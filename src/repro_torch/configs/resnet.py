"""ResNet configs: the paper's own evaluation networks (224x224 ImageNet),
as in ``repro/configs/resnet.py``."""
from repro_torch.configs.base import ArchConfig, register

RESNET18 = register(ArchConfig(
    name="resnet18",
    family="cnn",
    num_layers=18,
    vocab_size=1000,  # ImageNet classes
    use_ilpm_conv=True,
    dtype="float32",
    extra={"blocks": (2, 2, 2, 2), "bottleneck": False, "img": 224},
))

RESNET50 = register(ArchConfig(
    name="resnet50",
    family="cnn",
    num_layers=50,
    vocab_size=1000,
    use_ilpm_conv=True,
    dtype="float32",
    extra={"blocks": (3, 4, 6, 3), "bottleneck": True, "img": 224},
))
