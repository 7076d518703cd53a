"""MobileNet configs: the mobile-GPU network family the paper targets, as
in ``repro/configs/mobilenet.py``.

MobileNetV2 (Sandler et al. 2018) inverted-residual settings: each row is
(t, c, n, s) = (expansion, output channels, block repeats, first-block
stride).
"""
from repro_torch.configs.base import ArchConfig, register

# The paper-standard MobileNetV2 1.0x table.
MOBILENET_V2_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

MOBILENET_V2 = register(ArchConfig(
    name="mobilenet_v2",
    family="cnn",
    num_layers=53,
    vocab_size=1000,  # ImageNet classes
    use_ilpm_conv=True,
    param_sharding="replicated",
    dtype="float32",
    extra={"arch": "mobilenet", "img": 224, "stem": 32, "head": 1280,
           "settings": MOBILENET_V2_SETTINGS},
))
