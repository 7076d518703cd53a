"""Config registry: importing this package registers the configs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeSpec,
    applicable_shapes,
    get,
    names,
    register,
)
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

# The 10 assigned LM-pool architectures (resnet* are the paper's own nets).
ASSIGNED = (
    "granite-8b",
    "granite-3-2b",
    "qwen2-0.5b",
    "minitron-8b",
    "mamba2-370m",
    "deepseek-v2-236b",
    "granite-moe-3b-a800m",
    "internvl2-26b",
    "jamba-1.5-large-398b",
    "whisper-base",
)
