"""The tuned engine behind the program's ``Server`` with its default
``ServingOptions``, driven through ``submit`` and ``Ticket.result``."""
from __future__ import annotations

from bench.systems.cnn_program import folded, program_config


class ServerSystem:
    def __init__(self, cfg, weights, device):
        from repro_torch.serving import EngineCache, Server

        self.pcfg = program_config(cfg)
        cache = EngineCache(capacity=1, device=device)
        self.engine = cache.get(self.pcfg,
                                params=folded(weights, cfg["bn_eps"]))
        self.server = Server(cache=cache, device=device)
        self._base = {}

    def warm(self, inputs):
        """Capture every padded batch the batcher dispatches (buckets 1,
        2, 4, ... up to its ``max_batch``), then pass a few requests
        through the server so its threads have run."""
        from repro_torch.serving import bucket

        top = self.server.options.max_batch
        sizes = sorted({bucket(n, top) for n in range(1, top + 1)})
        for b in sizes:
            if b == 1:
                self.engine.run(inputs[0]).cpu()
            else:
                self.engine.run_batch(inputs[:b]).cpu()
        tickets = [self.submit(inputs[i % len(inputs)])
                   for i in range(2 * top)]
        for t in tickets:
            self.result(t, 60.0).cpu()
        self._base = self._histogram()

    def submit(self, image):
        return self.server.submit(self.pcfg, image)

    def result(self, ticket, timeout):
        return ticket.result(timeout)

    def _histogram(self):
        nets = self.server.stats()["networks"]
        hist = {}
        for stats in nets.values():
            for b, n in stats["batch_histogram"].items():
                hist[b] = hist.get(b, 0) + n
        return hist

    def counters(self):
        """Dispatches by batch size since ``warm`` or the last call."""
        now = self._histogram()
        hist = {b: n - self._base.get(b, 0) for b, n in now.items()
                if n - self._base.get(b, 0)}
        self._base = now
        return {"batch_histogram": hist}

    def close(self):
        self.server.close()
        self.server = self.engine = None


def build(cfg, mix, weights, device):
    return ServerSystem(cfg, weights, device)
