"""Fault tolerance (``repro/runtime/fault_tolerance.py``): the restart
loop, the straggler watch and the transient-error type.

``resilient_train`` runs the train step as a pure function of (state,
step): an exception rolls the state back to the last committed checkpoint
and replays from there, which is exact because the data pipeline is pure
in (seed, step). ``StragglerWatch`` keeps a deadline of a multiple of the
running median step time and raises after ``max_breaches`` breaches, so
the restart path runs. ``elastic_remesh`` builds the largest (data,
model) mesh on the ranks that survive a scale-down; a checkpoint
restores onto any mesh.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import with_flattened
from repro_torch.models.spec import flatten, tree_map

log = logging.getLogger("repro_torch.runtime")


@dataclass
class StragglerWatch:
    factor: float = 3.0        # deadline = factor * running p50
    max_breaches: int = 5
    warmup: int = 3            # the first steps (builds, first calls)
    times: list = field(default_factory=list)
    breaches: int = 0

    def observe(self, dt: float) -> None:
        self.times.append(dt)
        hist = self.times[self.warmup:]
        if len(hist) < 5:
            return
        p50 = float(np.median(hist))
        if dt > self.factor * p50:
            self.breaches += 1
            log.warning("straggler: step took %.3fs vs p50 %.3fs (%d/%d)",
                        dt, p50, self.breaches, self.max_breaches)
            if self.breaches >= self.max_breaches:
                raise RuntimeError(
                    "persistent straggler detected — requesting reschedule")


class TransientFailure(Exception):
    """The repo-wide transient-error type: raised by the hardware or an
    injector to exercise the restart path, and the class of dispatch and
    build fault the serving tier retries (``serving.resilience``
    re-exports it); anything else is treated as persistent."""


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resilient_train(*, state, train_step, pipeline, ckpt, total_steps,
                    start_step=0, ckpt_every=50, max_failures=3,
                    straggler: StragglerWatch | None = None,
                    fail_injector=None, on_metrics=None, mesh=None,
                    rules=None):
    """Run to ``total_steps`` surviving up to ``max_failures`` restarts.

    Each step reads ``pipeline.batch(step, device=...)`` on the state's
    device (with a ``mesh``, placed on it by ``rules``) and ends in a
    synchronize of it; every ``ckpt_every`` steps and at the end the
    state is saved (with ``ckpt`` None nothing is saved, and a failure is
    raised: there is nothing to restart from). Returns (state, step,
    restarts).
    ``fail_injector(step)`` may raise to simulate faults; on a mesh every
    rank must fail at the same step, and the ranks meet before they read
    the checkpoint back."""
    step = start_step
    failures = 0
    device = next(iter(flatten(state).values())).device
    while step < total_steps:
        try:
            while step < total_steps:
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.perf_counter()
                batch = pipeline.batch(step, device=device) \
                    if mesh is None else pipeline.batch(step, mesh=mesh,
                                                        rules=rules)
                state, metrics = train_step(state, batch)
                _synchronize(device)
                dt = time.perf_counter() - t0
                if straggler is not None:
                    straggler.observe(dt)
                if on_metrics is not None:
                    on_metrics(step, metrics, dt)
                step += 1
                if ckpt is not None and (step % ckpt_every == 0
                                         or step == total_steps):
                    ckpt.save(step, state)
        except (TransientFailure, RuntimeError) as e:  # noqa: PERF203
            if ckpt is None:
                raise
            failures += 1
            log.warning("step %d failed (%s); restart %d/%d",
                        step, e, failures, max_failures)
            if failures > max_failures:
                raise
            ckpt.wait()
            if mesh is not None:  # the writer's last step is committed
                dist.barrier(group=mesh_group(mesh))
            restored_step, host_state = ckpt.restore()
            if host_state is None:
                step = start_step  # no checkpoint yet: replay from the top
                continue
            state = _device_put_like(host_state, state)
            step = restored_step
    if ckpt is not None:
        ckpt.wait()
    return state, step, failures


def _device_put_like(host_tree, like_tree):
    """The restored host tree on each live leaf's device and dtype; a
    DTensor leaf's on its mesh and placements, whatever mesh the
    checkpoint was saved from (each rank keeps its own block)."""
    def put(h, like):
        t = torch.as_tensor(h).to(device=like.device, dtype=like.dtype)
        if isinstance(like, DTensor):
            return distribute_tensor(t, like.device_mesh, like.placements,
                                     src_data_rank=None)
        return t
    return tree_map(put, host_tree, like_tree)


def mesh_group(mesh):
    """The process group of all of ``mesh``'s ranks."""
    if mesh.ndim == 1:
        return mesh.get_group()
    return mesh._flatten().get_group()


def elastic_remesh(n_devices: int, model_dims: list[int], *, device=None):
    """The largest (data, model) mesh on the first ``n_devices`` ranks of
    the group (at most its size) whose model axis divides every dim in
    ``model_dims`` (vocab, heads, d_ff ...), over a new group of those
    ranks: the scale-down re-mesh. Every rank of the group calls it; on a
    rank left out, ``mesh.get_coordinate()`` is None."""
    device = resolve_device(device)
    n = min(n_devices, dist.get_world_size())
    best = (n, 1)
    for model in range(min(n, 64), 0, -1):
        if n % model:
            continue
        if all(d % model == 0 for d in model_dims):
            best = (n // model, model)
            break
    ranks = torch.arange(best[0] * best[1]).reshape(best)
    return with_flattened(DeviceMesh(device.type, ranks,
                                     mesh_dim_names=("data", "model")))
