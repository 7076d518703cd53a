"""Config registry: importing this package registers the configs."""
from repro_torch.configs.base import ArchConfig, get, register  # noqa: F401
from repro_torch.configs import mamba2_370m, mobilenet, resnet  # noqa: F401
from repro_torch.configs.tiny import tiny_variant  # noqa: F401
