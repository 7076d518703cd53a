"""The dry run (``repro/launch/dryrun.py``): one step of an
(architecture, shape) cell, the sharded train step of a ``train_4k``
cell or the sharded prefill or decode step of a ``prefill_32k``,
``decode_32k`` or ``long_500k`` cell, run over 256 or 512 placeholder
ranks, allocating nothing, to read what each rank holds, computes and
sends.

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's memory and cost analyses. Here a ``fake`` process
group of 256 (16x16) or 512 (2x16x16) ranks carries the production mesh,
and the step runs once as rank 0 under ``FakeTensorMode``: every tensor
is a shape without storage, every collective returns at once. From that
run, per rank:

- the exact bytes of its parameters, optimizer state (train), caches
  (serving: a prefill's output, a decode step's input) and batch, from
  the local shard shapes;
- FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``'s formulas,
  applied to the local operations each DTensor operation becomes;
- collective bytes by kind (all-gather, all-reduce, reduce-scatter,
  all-to-all), the output bytes of each collective DTensor issues (an
  all-to-all by the block it returns, as a CUDA group moves it);
- roofline terms against one H100 SXM's data-sheet peaks.

Every layer runs (no scan, so no unrolled cost probe is needed). A
serving step runs without autograd, on the parameters of
``steps.abstract_state`` and the tokens, caches and position of
``steps.input_specs``, as the reference's ``_lower_one`` lowers it.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
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
from torch.distributed.tensor import (DTensor, distribute_tensor,
                                      placement_types)
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED, SHAPES, applicable_shapes,
                                 get, tiny_variant)
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
    are not counted. A move between two split dims is counted as the
    all-to-all a CUDA group runs, by the block it returns, where a CPU
    group runs an all-gather of the whole tensor and a chunk
    (``_count_alltoall``)."""

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
        self._alltoall = placement_types.shard_dim_alltoall
        placement_types.shard_dim_alltoall = self._count_alltoall
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._fake_mode_lock = self._lock
        placement_types.shard_dim_alltoall = self._alltoall
        return super().__exit__(*exc)

    def _count_alltoall(self, *args, **kwargs):
        """DTensor's all-to-all between two split dims, its collectives
        not counted inside, counted by the block it returns."""
        self._probing += 1
        try:
            out = self._alltoall(*args, **kwargs)
        finally:
            self._probing -= 1
        if not self._probing:
            self.collectives["all-to-all"] = self.collectives.get(
                "all-to-all", 0) + out.numel() * out.element_size()
        return out

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
    """6 N D for a train step, 2 N D for a serving one (N the parameters,
    the active ones of an MoE), D the tokens of the step: a decode step's
    one a row."""
    n = cfg.active_params() if cfg.num_experts else cfg.num_params()
    if shape.kind == "train":
        return float(6 * n * shape.global_batch * shape.seq_len)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    return float(2 * n * tokens)


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


def _placed(tree, mesh):
    """``input_specs``' ``Struct`` leaves (nested) as DTensors of empty
    blocks on their placements."""
    return {k: _placed(v, mesh) if isinstance(v, dict) else
            distribute_tensor(torch.empty(v.shape, dtype=v.dtype), mesh,
                              v.placements, src_data_rank=None)
            for k, v in tree.items()}


def _serve(cfg, shape, params, inputs, mesh, rules):
    """One serving step of the cell -> the caches it writes (a prefill)
    or reads (a decode)."""
    with torch.no_grad():
        if shape.kind == "prefill":
            _, caches = steps.prefill_step(
                params, cfg, inputs["tokens"], cache_len=shape.seq_len,
                frames=inputs.get("frames"),
                prefix_embeds=inputs.get("patch_embeds"), mesh=mesh,
                rules=rules)
            return caches
        steps.decode_step(params, cfg, inputs["tokens"], inputs["caches"],
                          inputs["pos"], mesh=mesh, rules=rules)
        return inputs["caches"]


def lower_cell(arch: str, shape_name: str = "train_4k", *,
               multi_pod: bool = False, tiny: bool = False) -> dict:
    """Run one cell's step on the production mesh over the current fake
    group (256 or 512 ranks) -> the report of rank 0."""
    cfg = get(arch)
    if tiny:
        cfg = tiny_variant(cfg)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = rules_for(cfg, mesh)
    train = shape.kind == "train"
    t0 = time.time()
    with FakeTensorMode():
        state, _ = steps.abstract_state(cfg, mesh, rules)
        inputs = _placed(steps.input_specs(cfg, shape, mesh, rules), mesh)
        caches = inputs.pop("caches", None)
        pos = inputs.pop("pos", None)
        with RankCounter() as counter:
            if train:
                steps.make_train_step(cfg, mesh, rules)(state, inputs)
            else:
                caches = _serve(cfg, shape, state["params"],
                                {**inputs, "caches": caches, "pos": pos},
                                mesh, rules)
    seconds = time.time() - t0
    param_b = local_bytes(state["params"])
    opt_b = local_bytes(state["opt"]) if train else 0
    batch_b = local_bytes({**inputs, **({} if pos is None
                                        else {"pos": pos})})
    cache_b = 0 if train else local_bytes(caches)
    coll = sum(counter.collectives.values())
    peaks = H100_SXM_PEAKS
    # a train step reads and writes each state byte once and reads the
    # batch; a serving step reads the weights once and writes its caches
    # (a decode step reads them too)
    moved = (2 * (param_b + opt_b) + batch_b if train else
             param_b + batch_b + cache_b * (2 if shape.kind == "decode"
                                            else 1))
    terms = {"compute": counter.flops / peaks[cfg.dtype],
             "memory": moved / peaks["mem_bw"],
             "collective": coll / peaks["link_bw"]}
    mf = model_flops(cfg, shape)
    ranks = mesh.size()
    return {
        "arch": cfg.name, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "ranks": ranks,
        "seconds": round(seconds, 1),
        "per_rank": {"param_bytes": param_b, "opt_bytes": opt_b,
                     "batch_bytes": batch_b, "cache_bytes": cache_b,
                     "flops": counter.flops,
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
                      f"GiB cache={r['cache_bytes'] / 2**30:.3f}GiB "
                      f"flops={r['flops']:.3e} "
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
    """(arch, shape, multi_pod) for every assigned architecture and each
    of its ``applicable_shapes``: train, prefill and decode, and
    ``long_500k`` where the config has a sub-quadratic decode."""
    meshes = [False, True] if multi_pod is None else [multi_pod]
    return [(arch, shape.name, mp) for arch in ASSIGNED
            for shape in applicable_shapes(get(arch)) for mp in meshes]


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
