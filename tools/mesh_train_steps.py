"""Time the port's sharded train step across the ranks of ``torchrun``.

Each rank takes one card (NCCL; gloo with ``--device cpu``) of a (1,
world size) ("data", "model") mesh (``launch.mesh.make_local_mesh``);
each config trains ``--steps`` steps of ``--batch`` x ``--seq`` tokens from
a 16-token vocabulary with its ``rules_for``, and the first rank prints one
JSON line a config: each step's host-clock ms (ending in a synchronize),
the losses, ``causal_conv1d``'s forward and backward launches a step on
that rank, the bytes of its block of the state, its peak device memory,
and the card's name and power limit.

    torchrun --nproc-per-node 4 tools/mesh_train_steps.py \\
        --arch mamba2-370m --arch granite-8b --steps 3

With ``--unsharded`` (no ``torchrun``) the same pipeline and schedule
train the unsharded step on one card, the losses a sharded run is held
against:

    python3 tools/mesh_train_steps.py --arch mamba2-370m --steps 4 \\
        --unsharded

Nothing is checkpointed (the state of granite-8b with AdamW is ~100 GB).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get, tiny_variant  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import causal_conv1d as cc  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.spec import flatten  # noqa: E402
from repro_torch.sharding.rules import rules_for  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unsharded", action="store_true",
                    help="one process, no mesh: the unsharded step")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if args.unsharded:
        return unsharded(args)
    if cuda:
        # fp32 means IEEE fp32, as chip_smoke.py sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl", device_id=torch.device(
            "cuda", torch.cuda.current_device()))
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo")
        card = None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = make_local_mesh(args.device)
    try:
        for arch in args.arch:
            cfg = tiny_variant(get(arch)) if args.tiny else get(arch)
            rules = rules_for(cfg, mesh)
            t0 = time.perf_counter()
            state = steps.init_state(cfg, 0, mesh=mesh, rules=rules)
            sync()
            init_s = time.perf_counter() - t0
            block = sum(v.to_local().numel() * v.to_local().element_size()
                        for v in flatten(state).values())
            pipe = TokenPipeline(16, args.seq, args.batch)
            step = steps.make_train_step(cfg, mesh, rules, peak_lr=1e-3,
                                         warmup=2, total_steps=20)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            ms, losses, launches = [], [], []
            for i in range(args.steps):
                cc.causal_conv1d.launches = cc.causal_conv1d_bwd.launches = 0
                sync()
                t0 = time.perf_counter()
                state, m = step(state, pipe.batch(i, mesh=mesh, rules=rules))
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"].to_local()))
                launches.append([cc.causal_conv1d.launches,
                                 cc.causal_conv1d_bwd.launches])
            if dist.get_rank() == 0:
                print(json.dumps({
                    "arch": cfg.name, "mesh": list(mesh.shape),
                    "backend": dist.get_backend(), "batch": args.batch,
                    "seq": args.seq, "parameters": cfg.num_params(),
                    "init_s": init_s, "state_block_bytes": block,
                    "step_ms": ms, "losses": losses,
                    "conv_launches_per_step": launches,
                    "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9
                    if cuda else None, "card": card}), flush=True)
            del state, step
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def unsharded(args):
    """``main``'s run of each config without a mesh, on one device."""
    cuda = args.device == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines() if cuda else None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for arch in args.arch:
        cfg = tiny_variant(get(arch)) if args.tiny else get(arch)
        state = steps.init_state(cfg, 0, args.device)
        pipe = TokenPipeline(16, args.seq, args.batch)
        step = steps.make_train_step(cfg, peak_lr=1e-3, warmup=2,
                                     total_steps=20)
        ms, losses = [], []
        for i in range(args.steps):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, pipe.batch(i, args.device))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        print(json.dumps({"arch": cfg.name, "mesh": None,
                          "batch": args.batch, "seq": args.seq,
                          "parameters": cfg.num_params(), "step_ms": ms,
                          "losses": losses, "card": card}), flush=True)
        del state, step
        if cuda:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
