"""The correctness control: the plain reference in the program's place,
at a precision below the configuration's fp32. ``"tf32"`` rounds every
product's operands to TF32 (the same on any device); ``"tf32_native"``
lets the card's TF32 tensor cores compute them. ``run`` and ``submit``
compute the image's logits at once. No mix names it: ``calibrate.py``
puts it in the program's place."""
from __future__ import annotations

from concurrent.futures import Future

import torch

from bench.harness import manifest
from bench.harness.compare import fp32_products


class ReferenceSystem:
    def __init__(self, cfg, weights, device, precision):
        if precision not in ("tf32", "tf32_native"):
            raise ValueError(f"no control at precision {precision!r}")
        self.ref = manifest.reference(cfg)
        self.cfg, self.weights = cfg, weights
        self.device, self.precision = device, precision

    def warm(self, inputs):
        self.run(inputs[0]).cpu()

    def run(self, image):
        x = torch.as_tensor(image, device=self.device)[None]
        native = self.precision == "tf32_native"
        with fp32_products(allow_tf32=native):
            return self.ref.logits(self.weights, self.cfg, x,
                                   "float32" if native else "tf32")[0]

    def submit(self, image):
        f = Future()
        f.set_result(self.run(image))
        return f

    def result(self, ticket, timeout):
        return ticket.result(timeout)

    def counters(self):
        return {}

    def close(self):
        pass


def build(cfg, mix, weights, device, precision="tf32"):
    return ReferenceSystem(cfg, weights, device, precision)
