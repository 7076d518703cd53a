"""The token pipeline (``repro/data/pipeline.py``): deterministic and
restart-safe.

``batch(step)`` is a pure function of (seed, step): a run restored from
the checkpoint of step N regenerates batches N, N+1, ... with no loader
state to save. The host batch is numpy's ``default_rng((seed, step))``,
as the reference draws it, so both packages feed the same tokens; the
reference places it on its mesh, the port on one device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass
class TokenPipeline:
    """A synthetic LM token stream, or windows of a corpus."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus: np.ndarray | None = None  # optional (N,) token memmap

    def _host_batch(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch at ``step``: pure in (seed,
        step)."""
        rng = np.random.default_rng((self.seed, step))
        if self.corpus is not None:
            starts = rng.integers(0, len(self.corpus) - self.seq_len - 1,
                                  size=self.global_batch)
            rows = np.stack([self.corpus[s:s + self.seq_len + 1]
                             for s in starts[lo:hi]])
        else:
            rows = rng.integers(0, self.vocab_size,
                                size=(self.global_batch, self.seq_len + 1),
                                dtype=np.int32)[lo:hi]
        return rows.astype(np.int32)

    def batch(self, step: int, device=None) -> dict:
        """-> {"tokens": (B, S) int32, "labels": (B, S) int32, the tokens
        shifted by one} on ``device``: the card unless the caller names
        another."""
        device = resolve_device(device)
        rows = torch.from_numpy(self._host_batch(step, 0, self.global_batch))
        return {"tokens": rows[:, :-1].contiguous().to(device),
                "labels": rows[:, 1:].contiguous().to(device)}


def prefetch(iterator, depth: int = 2):
    """Keep ``depth`` items of ``iterator`` in flight ahead of the
    consumer, drawn on a worker thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        yield item
