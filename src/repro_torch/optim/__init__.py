"""Optimizers for the train step (``repro/optim``): AdamW and Adafactor
as pure functions of (grads, state, params), the schedule and the global
norm clip, and error-feedback int8 compression."""
from repro_torch.optim import adafactor, adamw, compression, schedule  # noqa: F401


def get(name: str):
    """The optimizer module a config names (``cfg.optimizer``)."""
    return {"adamw": adamw, "adafactor": adafactor}[name]
