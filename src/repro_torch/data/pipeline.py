"""The token pipeline (``repro/data/pipeline.py``): deterministic and
restart-safe.

``batch(step)`` is a pure function of (seed, step): a run restored from
the checkpoint of step N regenerates batches N, N+1, ... with no loader
state to save. The host batch is numpy's ``default_rng((seed, step))``,
as the reference draws it, so both packages feed the same tokens, and
either places it on a device or on its mesh.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import mesh_device
from repro_torch.sharding.rules import logical_sharding


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

    def batch(self, step: int, device=None, mesh=None, rules=None) -> dict:
        """-> {"tokens": (B, S) int32, "labels": (B, S) int32, the tokens
        shifted by one} on ``device``: the card unless the caller names
        another. With a ``mesh`` (and its ``rules``) both are DTensors on
        the mesh's device, placed by ("batch", "seq"): each rank draws the
        global batch and keeps its own block."""
        device = resolve_device(device) if mesh is None \
            else mesh_device(mesh)
        rows = torch.from_numpy(self._host_batch(step, 0, self.global_batch))
        out = {"tokens": rows[:, :-1].contiguous().to(device),
               "labels": rows[:, 1:].contiguous().to(device)}
        if mesh is None:
            return out
        pl = logical_sharding(("batch", "seq"), out["tokens"].shape, rules,
                              mesh)
        return {k: distribute_tensor(v, mesh, pl, src_data_rank=None)
                for k, v in out.items()}


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
