"""The program's ``InferenceEngine(cfg, params=..., algorithm="auto")``,
the cost-model tuned plan, driven image by image through ``run``."""
from __future__ import annotations

from bench.systems.cnn_program import folded, program_config


class EngineSystem:
    def __init__(self, cfg, weights, device):
        from repro_torch.core.engine import InferenceEngine

        self.engine = InferenceEngine(
            program_config(cfg), params=folded(weights, cfg["bn_eps"]),
            algorithm="auto", device=device)

    def warm(self, inputs):
        """Capture and replay the batch-1 graph: the only shape used."""
        for image in inputs[:2]:
            self.engine.run(image).cpu()

    def run(self, image):
        return self.engine.run(image)

    def counters(self):
        return {}

    def close(self):
        self.engine = None


def build(cfg, mix, weights, device):
    return EngineSystem(cfg, weights, device)
