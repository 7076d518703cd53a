"""The train driver (``repro/launch/train.py``): config -> state -> the
resilient loop (checkpoints and restarts, the straggler watch, the
deterministic token pipeline).

    python -m repro_torch.launch.train --arch mamba2-370m --steps 20
    python -m repro_torch.launch.train --arch mamba2-370m --tiny \\
        --device cpu --steps 20

It runs on the card unless ``--device`` names another device, and resumes
from the latest checkpoint in ``--ckpt-dir``. With ``--mesh`` it runs
under ``torchrun``, one rank a device, on a (1, world size) mesh
(``local``) or a production one (``pod`` 16x16, ``multipod`` 2x16x16),
the state and the batch sharded by the config's ``rules_for``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mamba2-370m --tiny --mesh local --steps 20

``train`` is the run itself, for callers that bring their own pipeline,
fault injector or mesh.
"""
from __future__ import annotations

import argparse
import logging
from dataclasses import dataclass, field

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get, tiny_variant
from repro_torch.core.device import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps
from repro_torch.launch.mesh import first_rank, mesh_from_env
from repro_torch.runtime import StragglerWatch, resilient_train
from repro_torch.runtime.fault_tolerance import _device_put_like
from repro_torch.sharding.rules import rules_for


@dataclass
class TrainRun:
    """What ``train`` returns: the final state and step, the restarts, and
    each step's metrics as floats (``loss``, ``aux``, ``grad_norm``,
    ``lr``, ``seconds``: the host-clock time of the step, ending in a
    synchronize) keyed by step; a replayed step keeps its last run's."""
    state: dict
    step: int
    restarts: int
    metrics: dict = field(default_factory=dict)


def warmup_steps(total_steps: int) -> int:
    """The warmup the driver gives a run of ``total_steps``."""
    return min(100, total_steps // 10 + 1)


def train(cfg, *, steps_total, batch=8, seq=128, lr=3e-4,
          ckpt_dir="repro_ckpt", ckpt_every=50, seed=0, device=None,
          pipeline=None, fail_injector=None, max_failures=3,
          log_every=0, mesh=None, rules=None) -> TrainRun:
    """Train ``cfg`` to ``steps_total`` steps on ``device`` (the card
    unless named), resuming from the latest checkpoint in ``ckpt_dir``.
    ``pipeline`` defaults to ``TokenPipeline(cfg.vocab_size, seq, batch,
    seed=seed)``; ``log_every`` > 0 prints every that many steps (on a
    mesh, its first rank prints). With a ``mesh`` every rank of it calls
    ``train``: the state is sharded by ``rules`` (the config's
    ``rules_for`` unless given) and saved whole. ``ckpt_dir=None`` saves
    no checkpoint and resumes from none."""
    if mesh is not None:
        rules = rules if rules is not None else rules_for(cfg, mesh)
    else:
        device = resolve_device(device)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
    pipe = pipeline or TokenPipeline(cfg.vocab_size, seq, batch, seed=seed)
    train_step = steps.make_train_step(
        cfg, mesh, rules, peak_lr=lr, warmup=warmup_steps(steps_total),
        total_steps=steps_total)
    state = steps.init_state(cfg, seed, device, mesh, rules)
    first = first_rank(mesh)
    start = (ckpt.latest_step() or 0) if ckpt is not None else 0
    if start:
        _, host = ckpt.restore()
        state = _device_put_like(host, state)
        if first:
            print(f"resumed from step {start}", flush=True)
    run = TrainRun({}, start, 0)

    def on_metrics(step, m, dt):
        rec = {k: float(v.to_local() if isinstance(v, DTensor) else v)
               for k, v in m.items()}
        run.metrics[step] = {**rec, "seconds": dt}
        if log_every and step % log_every == 0 and first:
            print(f"step {step:5d}  loss {rec['loss']:.4f}  "
                  f"gnorm {rec['grad_norm']:.3f}  lr {rec['lr']:.2e}  "
                  f"{dt * 1e3:.0f} ms", flush=True)

    # handed over, not kept: a name here would hold the first state (a
    # second copy of the weights and the optimizer state) through the run
    first_state = [state]
    del state
    run.state, run.step, run.restarts = resilient_train(
        state=first_state.pop(), train_step=train_step, pipeline=pipe,
        ckpt=ckpt,
        total_steps=steps_total, start_step=start, ckpt_every=ckpt_every,
        max_failures=max_failures, straggler=StragglerWatch(),
        fail_injector=fail_injector, on_metrics=on_metrics, mesh=mesh,
        rules=rules)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"],
                    default=None, help="train sharded, under torchrun")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get(args.arch)
    if args.tiny:
        cfg = tiny_variant(cfg)
    mesh = mesh_from_env(args.mesh, args.device) if args.mesh else None
    try:
        run = train(cfg, steps_total=args.steps, batch=args.batch,
                    seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, seed=args.seed,
                    device=args.device, log_every=10, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if first_rank(mesh):
        print(f"done: step={run.step} restarts={run.restarts}", flush=True)
    return run


if __name__ == "__main__":
    main()
