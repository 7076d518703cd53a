"""Convolution routing, autotuning, specs and the inference engine."""
from repro_torch.core.algorithms import conv2d  # noqa: F401
from repro_torch.core.autotune import (  # noqa: F401
    REFERENCE_DEVICE, Choice, DeviceModel, TuningPlan, build_plan,
    cost_model_select, measured_select, select, select_block,
    xla_fallback_plan)
from repro_torch.core.convspec import ConvSpec, FusedBlockSpec  # noqa: F401
from repro_torch.core.dtypes import element_size, with_precision  # noqa: F401
from repro_torch.core.engine import InferenceEngine  # noqa: F401
