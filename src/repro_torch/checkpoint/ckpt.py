"""Async, integrity-checked checkpoints (``repro/checkpoint/ckpt.py``),
in the reference's layout:

    <dir>/step_<N>/
        shard_0.npz  the leaves, keyed by their "/"-joined tree paths
        META.json    step, paths, shapes, dtypes, the shard's sha256
        COMMIT       written last: a step without it is torn and ignored

A step is written into ``.tmp_step_<N>`` and renamed when whole. numpy
holds no bf16 without ``ml_dtypes``, so a bf16 leaf is stored as its
uint16 bits with ``"bfloat16"`` in ``META.json``'s dtypes and restored
bit for bit; an fp32 or int32 checkpoint is the reference's own format,
and either package restores the other's. One process writes one shard: a
sharded state is gathered and saved whole, so it restores onto any mesh.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

SHARD = "shard_0.npz"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _unflatten(pairs):
    root: dict = {}
    for path, val in pairs:
        node = root
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    return root


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor -> (a host copy as the numpy array to store, dtype name);
    a DTensor's whole value (a collective over its mesh)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _writes(leaves) -> bool:
    """Whether this process writes: always, unless the tree holds DTensors
    and this rank is not the first of their mesh."""
    for _, leaf in leaves:
        if isinstance(leaf, DTensor):
            coord = leaf.device_mesh.get_coordinate()
            return coord is not None and not any(coord)
    return True


class CheckpointManager:
    """Saves a tree of tensors at a step and restores it; keeps the last
    ``keep`` steps. With ``async_save`` the host copy is taken at
    ``save`` and a thread writes it; ``wait`` joins that thread."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree) -> None:
        """Save ``tree`` at ``step``. A tree of DTensors is saved whole, as
        full host arrays: every rank of its mesh calls ``save`` (each leaf
        is gathered) and the mesh's first rank writes."""
        leaves = list(_flatten(tree))
        host = {path: _to_host(leaf) for path, leaf in leaves}
        if not _writes(leaves):
            return
        if self.async_save:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._pending.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: dict) -> None:
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shard = tmp / SHARD
        np.savez(shard, **{k: arr for k, (arr, _) in host.items()})
        meta = {"step": step, "paths": sorted(host),
                "shapes": {k: list(arr.shape) for k, (arr, _) in host.items()},
                "dtypes": {k: dt for k, (_, dt) in host.items()},
                "digest": {SHARD: hashlib.sha256(shard.read_bytes())
                           .hexdigest()}}
        (tmp / "META.json").write_text(json.dumps(meta))
        (tmp / "COMMIT").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        """The committed steps, in order."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "COMMIT").exists())

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, verify: bool = True):
        """-> (step, tree of CPU tensors), the latest committed step unless
        ``step`` is given; (None, None) when there is none. ``verify``
        checks the shard's digest and raises ``IOError`` on a mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "META.json").read_text())
        shard = d / SHARD
        if verify:
            want = meta["digest"].get(SHARD)
            if want and hashlib.sha256(shard.read_bytes()).hexdigest() != want:
                raise IOError(f"checkpoint {d} failed integrity check")
        with np.load(shard) as z:
            pairs = [(k, _from_host(z[k], meta["dtypes"].get(k, "")))
                     for k in z.files]
        return step, _unflatten(pairs)
