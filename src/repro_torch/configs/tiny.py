"""Reduced same-family configs for CPU tests: the cnn branch of
``repro/configs/tiny.py``."""
from repro_torch.configs.base import ArchConfig


def tiny_variant(cfg: ArchConfig) -> ArchConfig:
    """The reduced config of the same family: img 32, one block a stage
    (MobileNetV2 keeps a t=1 stage, two strided stages and a stride-1
    stage whose block adds the identity)."""
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"tiny_variant: family {cfg.family!r} comes with the substrate "
            "slice (ROADMAP queue 1 item 13)")
    extra = {**cfg.extra, "img": 32}
    if "blocks" in extra:  # resnet family
        extra["blocks"] = (1, 1, 1, 1)
    if "settings" in extra:  # mobilenet family
        extra.update(settings=((1, 16, 1, 1), (6, 24, 1, 2),
                               (6, 24, 1, 1), (6, 40, 1, 2)),
                     stem=16, head=64)
    return cfg.replace(name=cfg.name + "-tiny", dtype="float32",
                       param_dtype="float32",
                       vocab_size=min(cfg.vocab_size, 256) or 256,
                       extra=extra)
