"""Spawned ranks for the port's mesh tests (not a test module).

``spawn(name, tmp_path, *args)`` starts ``WORLD`` processes, each of which
joins a ``gloo`` group through a rendezvous file under ``tmp_path`` (no
port to collide on between test workers), runs the function ``name`` of
this module as its rank and saves what it returns; ``spawn`` returns each
rank's result in rank order. Every rank runs one thread, so four ranks
share the host's cores without starving each other. This module imports
no JAX: the reference's side of a test runs in the test's own process or
in a subprocess.
"""
from __future__ import annotations

import hashlib
import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

WORLD = 4
TIMEOUT = 600  # seconds a spawn may take (a hang guard; the host may be busy)
FP32 = 2e-5


def spawn(name, tmp_path, *args, world=WORLD):
    return start(name, tmp_path, *args, world=world).join()


class start:
    """``spawn`` begun: ``join()`` waits for the ranks and returns their
    results, so that two groups (each its own rendezvous) may run at
    once."""

    def __init__(self, name, tmp_path, *args, world=WORLD):
        tmp_path.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        init = f"file://{tmp_path}/rendezvous"
        self.tmp_path, self.world = tmp_path, world
        self.procs = [ctx.Process(target=_entry, args=(
            name, rank, world, init, str(tmp_path), args))
            for rank in range(world)]
        for p in self.procs:
            p.start()

    def kill(self):
        for p in self.procs:
            p.kill()
            p.join()

    def join(self):
        for p in self.procs:
            p.join(TIMEOUT)
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        errors = [self.tmp_path / f"error{r}.txt" for r in range(self.world)]
        msg = "".join(e.read_text() for e in errors if e.exists())
        assert not alive and all(p.exitcode == 0 for p in self.procs), \
            f"exit codes {[p.exitcode for p in self.procs]}\n{msg}"
        return [torch.load(self.tmp_path / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def _entry(name, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        result = globals()[name](rank, world, *args)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    except BaseException:
        with open(f"{out_dir}/error{rank}.txt", "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# helpers


def rel(y, ref) -> float:
    """max|y - ref| / max|ref|."""
    y, ref = y.double(), ref.double()
    return float((y - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def block_digests(tree) -> dict:
    """{leaf: (the block this rank holds, sha256 of its bytes)}: ranks
    whose blocks have the same key must hold the same bytes."""
    from repro_torch.models.spec import flatten

    out = {}
    for k, v in flatten(tree).items():
        coord = v.device_mesh.get_coordinate()
        key = tuple(c if isinstance(p, Shard) else None
                    for c, p in zip(coord, v.placements))
        local = v.to_local().detach().reshape(-1).contiguous()
        out[k] = (key, hashlib.sha256(
            local.view(torch.uint8).numpy().tobytes()).hexdigest())
    return out


def _inputs(cfg, B, S, seed=0):
    """A numpy-seeded batch of the config's inputs (tokens, labels; an
    encoder-decoder's frames), whole, on the CPU."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    out = {k: torch.from_numpy(v.astype(np.int32)) for k, v in out.items()}
    out["labels"][0, :3] = -1
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _placed(batch, cfg, mesh, rules):
    from repro_torch.launch import steps
    from repro_torch.configs import ShapeSpec
    from repro_torch.sharding.rules import logical_sharding

    B, S = batch["tokens"].shape
    axes = steps.batch_axes(cfg, ShapeSpec("cell", S, B, "train"))
    return {k: distribute_tensor(
        v, mesh, logical_sharding(axes[k], v.shape, rules, mesh),
        src_data_rank=None) for k, v in batch.items()}


def _mesh(shape, names):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, names, "cpu")


# ----------------------------------------------------------------------
# the ranks' work


def families(rank, world, cases, B=4, S=24):
    """For each (name, arch, dtype, config overrides, the dense MoE
    dispatch's limit or None): the sharded gradients and loss against
    the unsharded step's on a 2x2 (data, model) mesh (rank 0 measures),
    then two sharded train steps: every rank's block digests."""
    from repro_torch.configs import get, tiny_variant
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models.spec import flatten
    from repro_torch.sharding.rules import rules_for

    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    dense_max = layers._DENSE_MAX
    for name, arch, dtype, overrides, limit in cases:
        layers._DENSE_MAX = dense_max if limit is None else limit
        cfg = tiny_variant(get(arch)).replace(dtype=dtype,
                                              param_dtype=dtype, **overrides)
        rules = rules_for(cfg, mesh)
        batch = _inputs(cfg, B, S)
        dbatch = _placed(batch, cfg, mesh, rules)
        state = steps.init_state(cfg, 0, mesh=mesh, rules=rules)
        grads, m = steps.loss_and_grads(cfg, state["params"], dbatch, mesh,
                                        rules)
        got = {k: full(v) for k, v in flatten(grads).items()}
        loss = full(m["loss"])
        rec = {"placements": {k: tuple(v.placements)
                              for k, v in flatten(state).items()},
               "metrics_replicated": all(
                   isinstance(v, DTensor) and all(
                       p.is_replicate() for p in v.placements)
                   for v in m.values())}
        if rank == 0:
            plain = steps.init_state(cfg, 0, "cpu")
            want, wm = steps.loss_and_grads(cfg, plain["params"], batch)
            rec["loss"] = rel(loss, wm["loss"])
            rec["grads"] = {k: rel(got[k], v)
                            for k, v in flatten(want).items()}
        step = steps.make_train_step(cfg, mesh, rules, peak_lr=1e-3,
                                     warmup=2, total_steps=10)
        for _ in range(2):
            state, metrics = step(state, dbatch)
        rec["digests"] = block_digests(state)
        rec["metric_digests"] = block_digests(metrics)
        out[name] = rec
    layers._DENSE_MAX = dense_max
    return out


def reference_grads(rank, world, npz_path):
    """The sharded gradients of the reference's parameters and batch
    (from its own sharded step, saved to ``npz_path``, which the ranks
    wait for) against its loss and gradients (rank 0 measures)."""
    from repro_torch.configs import get, tiny_variant
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import spec as pspec
    from repro_torch.models.spec import flatten, unflatten
    from repro_torch.sharding.rules import rules_for

    cfg = tiny_variant(get("qwen2-0.5b"))
    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(cfg, mesh)
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(npz_path):  # written whole, then renamed
        if time.monotonic() > deadline:
            raise TimeoutError(npz_path)
        time.sleep(0.1)
    z = np.load(npz_path)
    tree = unflatten({k[2:]: z[k] for k in z.files if k.startswith("p.")})
    params = unflatten(params_from_reference(tree))
    shard = flatten(pspec.param_shardings(steps.state_specs(cfg)["params"],
                                          mesh, rules))
    dparams = unflatten({k: distribute_tensor(v, mesh, shard[k],
                                              src_data_rank=None)
                         for k, v in flatten(params).items()})
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    grads, m = steps.loss_and_grads(cfg, dparams, _placed(batch, cfg, mesh,
                                                          rules), mesh,
                                    rules)
    got = {k: full(v) for k, v in flatten(grads).items()}
    loss = full(m["loss"])
    if rank:
        return {}
    want = flatten(unflatten(params_from_reference(unflatten(
        {k[2:]: z[k] for k in z.files if k.startswith("g.")}))))
    return {"loss": rel(loss, torch.from_numpy(z["loss"])),
            "grads": {k: rel(got[k], v) for k, v in want.items()}}


def pod_psum(rank, world, npz_path):
    """``compressed_psum_pod`` on a (pod, data) = (2, 2) mesh, each pod's
    ranks holding that pod's gradients and residuals -> this rank's pod
    and its outputs."""
    from repro_torch.optim.compression import compressed_psum_pod
    from repro_torch.sharding.rules import as_dtensor

    z = np.load(npz_path)
    mesh = _mesh((2, 2), ("pod", "data"))
    pod = mesh.get_coordinate()[0]
    grads = {k: as_dtensor(torch.from_numpy(z[f"g{pod}.{k}"]), mesh)
             for k in ("w", "b")}
    err = {k: as_dtensor(torch.from_numpy(z[f"e{pod}.{k}"]), mesh)
           for k in ("w", "b")}
    out, new_err = compressed_psum_pod(grads, err, mesh)
    return {"pod": pod,
            "out": {k: v.to_local() for k, v in out.items()},
            "err": {k: v.to_local() for k, v in new_err.items()}}


def remesh(rank, world, ckpt_dir):
    """The reference's elastic test: a step's loss on 4 ranks and, after
    ``elastic_remesh`` to 2 surviving ranks, on 2; the 4-rank state saved
    after its step and restored onto the 2-rank mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get, tiny_variant
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models.spec import flatten
    from repro_torch.runtime.fault_tolerance import (_device_put_like,
                                                     elastic_remesh)
    from repro_torch.sharding.rules import rules_for

    cfg = tiny_variant(get("granite-3-2b")).replace(num_layers=2)
    pipe = TokenPipeline(cfg.vocab_size, 16, 8)
    ckpt = CheckpointManager(ckpt_dir, async_save=False)
    out = {}
    saved = None
    for n in (4, 2):
        mesh = elastic_remesh(n, model_dims=[cfg.d_model, cfg.d_ff],
                              device="cpu")
        if mesh.get_coordinate() is None:
            continue  # this rank did not survive
        rules = rules_for(cfg, mesh)
        state = steps.init_state(cfg, 0, mesh=mesh, rules=rules)
        if n == 2:  # the 4-rank state, restored onto this mesh
            _, host = ckpt.restore()
            restored = _device_put_like(host, state)
            out["restored_bitwise"] = all(
                torch.equal(full(v), saved[k])
                for k, v in flatten(restored).items())
        step = steps.make_train_step(cfg, mesh, rules)
        state, m = step(state, pipe.batch(0, mesh=mesh, rules=rules))
        out[n] = {"loss": float(full(m["loss"])),
                  "mesh": tuple(mesh.shape)}
        if n == 4:
            saved = {k: full(v) for k, v in flatten(state).items()}
            ckpt.save(1, state)
            dist.barrier()
    return out


def _greedy_agree(got, want, tol) -> bool:
    """The argmax of ``got`` (B, V) equals ``want``'s in every row where
    ``want``'s top-1 leads its top-2 by more than ``tol * max|want|``."""
    top = torch.topk(want.double(), 2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > tol * want.abs().max()
    return bool((got.argmax(-1) == want.argmax(-1))[clear].all())


def _decode_bytes(fn):
    """(fn(), the bytes this rank's collectives move in it: by kind, and
    the largest one's under ``"largest"``)."""
    from repro_torch.launch.dryrun import RankCounter

    class Counter(RankCounter):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = sum(self.collectives.values())
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self.largest = max(self.largest,
                               sum(self.collectives.values()) - before)
            return out
    with Counter() as counter:
        out = fn()
    return out, {**counter.collectives, "largest": counter.largest}


def serve_case(cfg, mesh, rules, B, S, cache_len, new, seed=0,
               measure=True):
    """The sharded prefill and ``new`` decode steps of ``cfg`` against the
    unsharded ones from the same weights, teacher-forced on the unsharded
    greedy tokens: each step's logits error, greedy agreement, the
    caches' placements against ``input_specs``' and each decode step's
    collective bytes, by kind."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.models.spec import flatten

    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    V = cfg.vocab_size  # the padding columns are masked alike
    inputs = {}
    if cfg.is_encoder_decoder:
        inputs["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    params = steps.init_params(cfg, seed, mesh=mesh, rules=rules)
    plain = steps.init_params(cfg, seed, "cpu")
    kept = all(tuple(v.placements) == tuple(flatten(params)[k].placements)
               for k, v in flatten(steps.compute_params(params, cfg)).items())
    want_pl = {k: tuple(v.placements) for k, v in flatten(steps.input_specs(
        cfg, ShapeSpec("decode", cache_len, B, "decode"), mesh,
        rules)["caches"]).items()}
    with torch.no_grad():  # DTensor views fail in inference mode
        slog, scache = steps.prefill_step(params, cfg, tokens,
                                          cache_len=cache_len, mesh=mesh,
                                          rules=rules, **inputs)
        plog, pcache = steps.prefill_step(plain, cfg, tokens,
                                          cache_len=cache_len, **inputs)
        rec = {"logits": [rel(full(slog)[..., :V], plog[..., :V])],
               "greedy": [_greedy_agree(full(slog)[:, -1, :V],
                                        plog[:, -1, :V], FP32)],
               "bitwise": [torch.equal(full(slog), plog)],
               "placements": [{k: tuple(v.placements) == want_pl[k]
                               for k, v in flatten(scache).items()}],
               "cache_len": cache_len, "bytes": [],
               "compute_params_placed": kept}
        for i in range(new):
            tok = plog[:, -1, :V].argmax(-1)[:, None]
            if measure:
                (slog, scache), coll = _decode_bytes(
                    lambda: steps.decode_step(params, cfg, tok, scache,
                                              S + i, mesh=mesh,
                                              rules=rules))
                rec["bytes"].append(coll)
            else:
                slog, scache = steps.decode_step(params, cfg, tok, scache,
                                                 S + i, mesh=mesh,
                                                 rules=rules)
            plog, pcache = steps.decode_step(plain, cfg, tok, pcache, S + i)
            rec["logits"].append(rel(full(slog)[..., :V], plog[..., :V]))
            rec["greedy"].append(_greedy_agree(full(slog)[:, 0, :V],
                                               plog[:, 0, :V], FP32))
            rec["bitwise"].append(torch.equal(full(slog), plog))
            rec["placements"].append({k: tuple(v.placements) == want_pl[k]
                                      for k, v in flatten(scache).items()})
        rec["caches"] = max(rel(full(v), flatten(pcache)[k])
                            for k, v in flatten(scache).items())
    return rec


def serving(rank, world, archs, B=4, S=12, cache_len=512, new=4):
    """Each tiny fp32 config's sharded prefill and ``new`` decode steps
    on a 2x2 (data, model) mesh against the unsharded steps
    (``serve_case``), and ``serve.generate``'s greedy tokens sharded and
    unsharded (``"generate"``, of the first config); every rank returns
    its records."""
    from repro_torch.configs import get, tiny_variant
    from repro_torch.launch import serve, steps
    from repro_torch.sharding.rules import rules_for

    mesh = _mesh((2, 2), ("data", "model"))
    out = {}
    for arch in archs:
        cfg = tiny_variant(get(arch))
        out[arch] = serve_case(cfg, mesh, rules_for(cfg, mesh), B, S,
                               cache_len, new)
    cfg = tiny_variant(get(archs[0]))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    kw = dict(max_new=new + 1, cache_len=S + new + 1)
    out["generate"] = {
        "sharded": serve.generate(cfg, steps.init_params(cfg, 0, mesh=mesh),
                                  prompts, mesh=mesh, **kw),
        "unsharded": serve.generate(cfg, steps.init_params(cfg, 0, "cpu"),
                                    prompts, **kw)}
    return out


def one_rank_serving(archs, tmp_path, B=2, S=12, cache_len=16, new=4):
    """In this process: a gloo group of one rank and the (1, 1) mesh;
    each tiny fp32 config's sharded steps against the unsharded ones
    (``serve_case``), the group destroyed after."""
    from repro_torch.configs import get, tiny_variant
    from repro_torch.sharding.rules import rules_for

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv1",
                            rank=0, world_size=1)
    try:
        mesh = _mesh((1, 1), ("data", "model"))
        out = {}
        for arch in archs:
            cfg = tiny_variant(get(arch))
            out[arch] = serve_case(cfg, mesh, rules_for(cfg, mesh), B, S,
                                   cache_len, new, measure=False)
    finally:
        dist.destroy_process_group()
    return out


def reference_serving(rank, world, npz_path):
    """The reference's parameters, prompt and its greedy tokens (from its
    own sharded prefill and decode steps, saved to ``npz_path``, which
    the ranks wait for) through the port's sharded steps on a 2x2 mesh,
    teacher-forced on the same tokens: each step's logits against the
    reference's (rank 0 measures)."""
    from repro_torch.configs import get, tiny_variant
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import steps
    from repro_torch.models import spec as pspec
    from repro_torch.models.spec import flatten, unflatten
    from repro_torch.sharding.rules import rules_for

    cfg = tiny_variant(get("qwen2-0.5b"))
    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(cfg, mesh)
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(npz_path):  # written whole, then renamed
        if time.monotonic() > deadline:
            raise TimeoutError(npz_path)
        time.sleep(0.1)
    z = np.load(npz_path)
    params = unflatten(params_from_reference(unflatten(
        {k[2:]: z[k] for k in z.files if k.startswith("p.")})))
    shard = flatten(pspec.param_shardings(steps.state_specs(cfg)["params"],
                                          mesh, rules))
    dparams = unflatten({k: distribute_tensor(v, mesh, shard[k],
                                              src_data_rank=None)
                         for k, v in flatten(params).items()})
    tokens, fed = torch.from_numpy(z["tokens"]), torch.from_numpy(z["fed"])
    S, V = tokens.shape[1], cfg.vocab_size
    got = []
    with torch.no_grad():
        logits, caches = steps.prefill_step(dparams, cfg, tokens,
                                            cache_len=int(z["cache_len"]),
                                            mesh=mesh, rules=rules)
        got.append(full(logits))
        for i in range(fed.shape[1]):
            logits, caches = steps.decode_step(dparams, cfg, fed[:, i:i + 1],
                                               caches, S + i, mesh=mesh,
                                               rules=rules)
            got.append(full(logits))
    if rank:
        return {}
    return {"logits": [rel(g[..., :V], torch.from_numpy(z[f"l{i}"])[..., :V])
                       for i, g in enumerate(got)]}
