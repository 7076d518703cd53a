"""The dry run (``repro/launch/dryrun.py``) of the train cells: the
sharded train step of an (architecture, ``train_4k``) cell run over 256 or
512 placeholder ranks, allocating nothing, to read what each rank holds,
computes and sends.

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's memory and cost analyses. Here a ``fake`` process
group of 256 (16x16) or 512 (2x16x16) ranks carries the production mesh,
and the step runs once as rank 0 under ``FakeTensorMode``: every tensor
is a shape without storage, every collective returns at once. From that
run, per rank:

- the exact bytes of its parameters, optimizer state and batch, from the
  local shard shapes;
- FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``'s formulas,
  applied to the local operations each DTensor operation becomes;
- collective bytes by kind (all-gather, all-reduce, reduce-scatter,
  all-to-all), the output bytes of each collective DTensor issues;
- roofline terms against one H100 SXM's data-sheet peaks.

Every layer runs (no scan, so no unrolled cost probe is needed). Prefill
and decode cells are not dry-run yet.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out dry.json

It needs no card: the fake ranks are CPU ranks. The group is made in
``main`` (``fake_group``) and destroyed before it returns.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, SHAPES, get, tiny_variant
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.spec import flatten
from repro_torch.sharding.rules import rules_for

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit): the
# roofline's denominators, per rank. The collective term uses NVLink's
# rate one way (900 GB/s both ways); between hosts a rank has InfiniBand
# at about a ninth of it, so that term is a lower bound.
H100_SXM_PEAKS = {"bfloat16": 989e12, "float32": 67e12, "mem_bw": 3.35e12,
                  "link_bw": 450e9}

_KINDS = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}


class RankCounter(TorchDispatchMode):
    """Counts one rank's FLOPs and collective bytes. A DTensor operation
    is let through (``NotImplemented``), so DTensor runs it as local
    operations and collectives, which come back here with plain tensors.
    DTensor also runs each new operation once on global-shaped fake
    tensors to learn its output's shape, under its ``ShardingPropagator``'s
    ``_fake_mode_lock``; ``counting`` wraps that lock so that those calls
    are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: dict[str, int] = {}
        self._formulas = FlopCounterMode(display=False).flop_registry
        self._probing = 0
        self._lock = None

    def __enter__(self):
        self._lock = ShardingPropagator._fake_mode_lock
        ShardingPropagator._fake_mode_lock = _ShapeProbe(self, self._lock)
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._fake_mode_lock = self._lock
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._probing:
            return out
        packet = func._overloadpacket
        kind = _KINDS.get(packet.__name__)
        if kind is not None and "c10d" in func.namespace:
            outs = out if isinstance(out, (list, tuple)) else (out,)
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                t.numel() * t.element_size() for t in outs
                if isinstance(t, torch.Tensor))
        elif packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        return out


class _ShapeProbe:
    """The propagator's lock, with the counter paused inside it."""

    def __init__(self, counter, lock):
        self.counter, self.lock = counter, lock

    def __enter__(self):
        self.lock.__enter__()
        self.counter._probing += 1

    def __exit__(self, *exc):
        self.counter._probing -= 1
        return self.lock.__exit__(*exc)


def local_bytes(tree) -> int:
    """The bytes of a rank's blocks of a tree of DTensors."""
    return sum(v.to_local().numel() * v.to_local().element_size()
               for v in flatten(tree).values())


def model_flops(cfg, shape) -> float:
    """6 N D (dense) or 6 N_active D (MoE), D the tokens of the step."""
    n = cfg.active_params() if cfg.num_experts else cfg.num_params()
    return float(6 * n * shape.global_batch * shape.seq_len)


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A ``fake`` process group of ``world_size`` ranks, this process
    ``rank`` (0 unless named), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str = "train_4k", *,
               multi_pod: bool = False, tiny: bool = False) -> dict:
    """Run one train cell's step on the production mesh over the current
    fake group (256 or 512 ranks) -> the report of rank 0."""
    cfg = get(arch)
    if tiny:
        cfg = tiny_variant(cfg)
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        raise ValueError(f"{shape_name}: only train cells are dry-run")
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = rules_for(cfg, mesh)
    t0 = time.time()
    with FakeTensorMode():
        state, _ = steps.abstract_state(cfg, mesh, rules)
        batch = {k: distribute_tensor(
            torch.empty(s.shape, dtype=s.dtype), mesh, s.placements,
            src_data_rank=None)
            for k, s in steps.input_specs(cfg, shape, mesh, rules).items()}
        step = steps.make_train_step(cfg, mesh, rules)
        with RankCounter() as counter:
            step(state, batch)
    seconds = time.time() - t0
    param_b = local_bytes(state["params"])
    opt_b = local_bytes(state["opt"])
    batch_b = local_bytes(batch)
    coll = sum(counter.collectives.values())
    peaks = H100_SXM_PEAKS
    terms = {"compute": counter.flops / peaks[cfg.dtype],
             # each state byte read and written once, the batch read once
             "memory": (2 * (param_b + opt_b) + batch_b) / peaks["mem_bw"],
             "collective": coll / peaks["link_bw"]}
    mf = model_flops(cfg, shape)
    ranks = mesh.size()
    return {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "ranks": ranks,
        "seconds": round(seconds, 1),
        "per_rank": {"param_bytes": param_b, "opt_bytes": opt_b,
                     "batch_bytes": batch_b, "flops": counter.flops,
                     "collective_bytes": coll,
                     "collectives": dict(counter.collectives)},
        "roofline_s": terms,
        "bottleneck": max(terms, key=terms.get),
        "step_time_bound_s": max(terms.values()),
        "model_flops": mf,
        "useful_flops_ratio": mf / (counter.flops * ranks)
        if counter.flops else None,
        "peaks": "H100 SXM data sheet, 700 W",
    }


def run_cells(cells, *, out_path=None, tiny=False):
    """Each (arch, shape, multi_pod) cell, a fake group a mesh size; a
    cell that fails is reported and the rest run."""
    results = []
    for multi_pod in sorted({mp for _, _, mp in cells}):
        with fake_group(512 if multi_pod else 256):
            for arch, shape_name, mp in cells:
                if mp != multi_pod:
                    continue
                tag = f"{arch} x {shape_name} x " \
                      f"{'2x16x16' if mp else '16x16'}"
                try:
                    rep = lower_cell(arch, shape_name, multi_pod=mp,
                                     tiny=tiny)
                except Exception as e:  # noqa: BLE001 -- report, go on
                    print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:400]}",
                          flush=True)
                    results.append({"arch": arch, "shape": shape_name,
                                    "mesh": "2x16x16" if mp else "16x16",
                                    "error": f"{type(e).__name__}: "
                                             f"{str(e)[:2000]}"})
                    continue
                r, t = rep["per_rank"], rep["roofline_s"]
                print(f"PASS {tag}: {rep['seconds']}s "
                      f"state={(r['param_bytes'] + r['opt_bytes']) / 2**30:.2f}"
                      f"GiB flops={r['flops']:.3e} "
                      f"coll={r['collective_bytes'] / 2**30:.2f}GiB "
                      f"bottleneck={rep['bottleneck']} "
                      f"t=(c {t['compute']:.2e} | m {t['memory']:.2e} | "
                      f"x {t['collective']:.2e})s", flush=True)
                results.append(rep)
                if out_path:
                    Path(out_path).write_text(json.dumps(results, indent=1))
    if out_path:
        Path(out_path).write_text(json.dumps(results, indent=1))
    return results


def all_cells(multi_pod: bool | None = None):
    """(arch, "train_4k", multi_pod) for every assigned architecture."""
    meshes = [False, True] if multi_pod is None else [multi_pod]
    return [(arch, "train_4k", mp) for arch in ASSIGNED for mp in meshes]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [c for mp in meshes for c in all_cells(mp)]
    elif args.arch:
        cells = [(args.arch, args.shape, mp) for mp in meshes]
    else:
        ap.error("--arch (or --all) is required")
    results = run_cells(cells, out_path=args.out, tiny=args.tiny)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results) - n_fail}/{len(results)} cells passed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
