"""Config registry: importing this package registers the configs."""
from repro_torch.configs.base import ArchConfig, get, register  # noqa: F401
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    granite_3_2b,
    granite_8b,
    granite_moe_3b,
    internvl2_26b,
    jamba_1_5_large,
    mamba2_370m,
    minitron_8b,
    mobilenet,
    qwen2_0_5b,
    resnet,
    whisper_base,
)
from repro_torch.configs.tiny import tiny_variant  # noqa: F401
