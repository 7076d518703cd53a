"""ResNet configs: the paper's own evaluation networks (224x224 ImageNet),
as in ``repro/configs/resnet.py``, and the four 3x3 layers of the paper's
algorithm comparison."""
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, register


@dataclass(frozen=True)
class ConvLayerSpec:
    """One benchmarked conv layer: C in, K out, HxW spatial, RxS filter."""
    name: str
    c_in: int
    c_out: int
    h: int
    w: int
    r: int = 3
    s: int = 3
    stride: int = 1
    count: int = 1  # occurrences in the net


# The paper's Table 2: the 3x3 conv layers of ResNet (C = K, square images).
PAPER_CONV_LAYERS = (
    ConvLayerSpec("conv2.x", 64, 64, 56, 56),
    ConvLayerSpec("conv3.x", 128, 128, 28, 28),
    ConvLayerSpec("conv4.x", 256, 256, 14, 14),
    ConvLayerSpec("conv5.x", 512, 512, 7, 7),
)

RESNET18 = register(ArchConfig(
    name="resnet18",
    family="cnn",
    num_layers=18,
    vocab_size=1000,  # ImageNet classes
    use_ilpm_conv=True,
    param_sharding="replicated",
    dtype="float32",
    extra={"blocks": (2, 2, 2, 2), "bottleneck": False, "img": 224},
))

RESNET50 = register(ArchConfig(
    name="resnet50",
    family="cnn",
    num_layers=50,
    vocab_size=1000,
    use_ilpm_conv=True,
    param_sharding="replicated",
    dtype="float32",
    extra={"blocks": (3, 4, 6, 3), "bottleneck": True, "img": 224},
))
