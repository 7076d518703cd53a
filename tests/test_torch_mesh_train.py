"""The port's train path across a mesh, on four ``gloo`` ranks of the CPU
(``torch_mesh_workers.spawn``): the sharded train step of every family
against the unsharded one, the reference's own sharded step across
packages, the compressed all-reduce over pods, the elastic re-mesh and a
checkpoint restored onto another mesh.

The reference's side of a cross-package test runs in a subprocess with 4
forced host devices (``tests/test_multipod.py:19``) and hands its inputs
and results over in an ``.npz``. Bound: max|y - ref| / max|ref| <= 2e-5
in fp32, per leaf.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

import torch_mesh_workers as W

SRC = str(Path(__file__).resolve().parent.parent / "src")
FP32 = W.FP32
FAMILIES = ("qwen2-0.5b", "mamba2-370m", "granite-moe-3b-a800m",
            "deepseek-v2-236b", "jamba-1.5-large-398b", "whisper-base")
# (name, arch, dtype, config overrides, the dense MoE dispatch's limit):
# the six families, and granite's sort-based dispatch (forced; capacity
# for every entry, so the mesh's 2 groups a row drop nothing the
# unsharded step's one group keeps)
CASES = [(a, a, "float32", {}, None) for a in FAMILIES] + [
    ("granite-moe/sort", "granite-moe-3b-a800m", "float32",
     {"capacity_factor": 8.0}, 0)]


class _Reference:
    """``code`` started in a subprocess that sees 4 host devices;
    ``wait()`` checks that it succeeded."""

    def __init__(self, code: str, tmp_path):
        prog = ("import os\n"
                "os.environ['XLA_FLAGS'] = "
                "'--xla_force_host_platform_device_count=4'\n"
                + textwrap.dedent(code))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", prog], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=tmp_path,
            env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)})

    def wait(self):
        _, err = self.proc.communicate(timeout=W.TIMEOUT)
        assert self.proc.returncode == 0, err[-3000:]


def _replicas_agree(results, part):
    """Every block held by more than one rank is bitwise the same on each
    -> the number of blocks compared."""
    groups: dict = {}
    for res in results:
        for leaf, (key, digest) in res[part].items():
            groups.setdefault((leaf, key), set()).add(digest)
    assert all(len(d) == 1 for d in groups.values()), \
        sorted(k for k, d in groups.items() if len(d) > 1)[:5]
    return len(groups)


def test_sharded_steps_match_unsharded_and_replicas_agree(tmp_path):
    """Tiny configs of six families in fp32 on a 2x2 (data, model) mesh,
    and granite-moe through the sort-based dispatch in 2 groups a row:
    the loss and every gradient within 2e-5 of the unsharded step's, the
    metrics replicated, the state on its rules' placements, and after
    two train steps every replicated block bitwise equal across ranks.
    (Tiny jamba's 8-layer gradient is the least well conditioned: its
    unsharded fp32 gradient lies up to 3.3e-5 from its fp64 one on other
    token draws; on this one the sharded step is within the bound.)"""
    # three groups of 4 ranks at once, of about equal work
    split = [("jamba-1.5-large-398b", "mamba2-370m"),
             ("deepseek-v2-236b", "granite-moe-3b-a800m"),
             ("qwen2-0.5b", "whisper-base", "granite-moe/sort")]
    groups = [W.start("families", tmp_path / str(i),
                      [c for c in CASES if c[0] in names])
              for i, names in enumerate(split)]
    parts = [g.join() for g in groups]
    results = [{k: v for part in ranks for k, v in part.items()}
               for ranks in zip(*parts)]
    assert set(results[0]) == {c[0] for c in CASES}
    mine = results[0]
    for arch, *_ in CASES:
        rec = mine[arch]
        assert rec["loss"] <= FP32, (arch, rec["loss"])
        worst = max(rec["grads"].items(), key=lambda kv: kv[1])
        assert worst[1] <= FP32, (arch, worst)
        assert rec["metrics_replicated"], arch
        # parameters sharded somewhere: the mesh did split the state
        assert any(any(not p.is_replicate() for p in pl)
                   for pl in rec["placements"].values()), arch
        for part in ("digests", "metric_digests"):
            per_arch = [{part: r[arch][part]} for r in results]
            assert _replicas_agree(per_arch, part) > 0


def test_qwen2_sharded_step_matches_the_reference_sharded_step(tmp_path):
    """The reference's sharded ``make_train_step`` on a (2, 2) mesh of 4
    forced host devices and the port's on 4 gloo ranks, from the same
    parameters and batch: the loss and every gradient within 2e-5."""
    npz = tmp_path / "ref.npz"
    ref_run = _Reference(f"""
        import os
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get, tiny_variant
        from repro.launch import steps
        from repro.models import spec as pspec
        from repro.sharding.rules import logical_sharding, rules_for
        cfg = tiny_variant(get("qwen2-0.5b"))
        # Auto axes: GSPMD places what the rules leave open, as the
        # reference was written for (explicit axes reject its embedding
        # gather of a (data, model)-split batch)
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        rules = rules_for(cfg, mesh)
        rng = np.random.default_rng(0)
        B, S = 4, 24
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels[0, :3] = -1
        with mesh:
            state = steps.init_state(cfg, 0)
            sh = pspec.param_shardings(steps.state_specs(cfg), mesh, rules)
            state = jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)
            bs = logical_sharding(("batch", "seq"), (B, S), rules, mesh)
            batch = {{"tokens": jax.device_put(tokens, bs),
                      "labels": jax.device_put(labels, bs)}}
            fwd = steps._forward_for(cfg)

            def total(p, batch):
                pc = jax.tree.map(lambda q: q.astype(cfg.dtype)
                                  if q.dtype == jnp.float32 else q, p)
                logits, _, aux = fwd(pc, batch, "train", rules, mesh)
                return steps._ce_loss(logits, batch["labels"]) \\
                    + cfg.router_aux_weight * aux
            grads = jax.jit(jax.grad(total))(state["params"], batch)
            _, metrics = jax.jit(steps.make_train_step(cfg, mesh, rules))(
                state, batch)

        def flat(tree, prefix):
            out = {{}}
            def walk(node, path):
                if isinstance(node, dict):
                    for k in node:
                        walk(node[k], path + (k,))
                else:
                    out[prefix + ".".join(path)] = np.asarray(node)
            walk(tree, ())
            return out
        np.savez({str(npz) + ".part.npz"!r}, tokens=tokens, labels=labels,
                 loss=np.asarray(metrics["loss"]),
                 **flat(state["params"], "p."), **flat(grads, "g."))
        os.replace({str(npz) + ".part.npz"!r}, {str(npz)!r})
    """, tmp_path)
    # the ranks start beside the reference and wait for its file
    ranks = W.start("reference_grads", tmp_path / "ranks", str(npz))
    try:
        ref_run.wait()
    except BaseException:
        ranks.kill()
        raise
    res = ranks.join()[0]
    assert res["loss"] <= FP32, res["loss"]
    worst = max(res["grads"].items(), key=lambda kv: kv[1])
    assert worst[1] <= FP32, worst
    assert len(res["grads"]) > 10


def test_compressed_psum_pod_matches_reference(tmp_path):
    """int8 error-feedback all-reduce over the pod axis of a (pod, data)
    = (2, 2) mesh, each pod with its own numpy-seeded gradients and
    residuals (``tests/test_multipod.py:28``): every rank's sum and new
    residual against the reference's device of the same pod."""
    rng = np.random.default_rng(5)
    inputs = {}
    for pod in range(2):
        inputs[f"g{pod}.w"] = rng.standard_normal((8, 4)).astype(np.float32)
        inputs[f"g{pod}.b"] = rng.standard_normal(4).astype(np.float32)
        inputs[f"e{pod}.w"] = (rng.standard_normal((8, 4)) * 0.01).astype(
            np.float32)
        inputs[f"e{pod}.b"] = (rng.standard_normal(4) * 0.01).astype(
            np.float32)
    npz, ref = tmp_path / "in.npz", tmp_path / "ref.npz"
    np.savez(npz, **inputs)
    ref_run = _Reference(f"""
        import jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.optim.compression import compressed_psum_pod
        z = np.load({str(npz)!r})
        mesh = jax.make_mesh((2, 2), ("pod", "data"))
        sharding = NamedSharding(mesh, P())
        pods = {{d: i for (i, j), d in np.ndenumerate(mesh.devices)}}

        def per_pod(prefix, k):
            shape = z[f"{{prefix}}0.{{k}}"].shape
            return jax.make_array_from_single_device_arrays(
                shape, sharding,
                [jax.device_put(z[f"{{prefix}}{{pods[d]}}.{{k}}"], d)
                 for d in mesh.devices.flat])
        g = {{k: per_pod("g", k) for k in ("w", "b")}}
        e = {{k: per_pod("e", k) for k in ("w", "b")}}
        with mesh:
            out, new_err = compressed_psum_pod(g, e, mesh)
        res = {{}}
        for name, tree in (("out", out), ("err", new_err)):
            for k, v in tree.items():
                for shard in v.addressable_shards:
                    res[f"{{name}}{{pods[shard.device]}}.{{k}}."
                        f"{{shard.device.id}}"] = np.asarray(shard.data)
        np.savez({str(ref)!r}, **res)
    """, tmp_path)
    results = W.spawn("pod_psum", tmp_path, str(npz))
    ref_run.wait()
    want = np.load(ref)
    assert sorted(r["pod"] for r in results) == [0, 0, 1, 1]
    for r in results:
        for name in ("out", "err"):
            for k, v in r[name].items():
                refs = [want[f] for f in want.files
                        if f.startswith(f"{name}{r['pod']}.{k}.")]
                assert len(refs) == 2
                for x in refs:
                    rel = float(np.abs(v.numpy() - x).max()
                                / max(np.abs(x).max(), 1e-30))
                    assert rel <= FP32, (name, k, rel)


def test_elastic_remesh_and_checkpoint_across_meshes(tmp_path):
    """``tests/test_multipod.py:56``: a step's loss on 4 ranks and, after
    ``elastic_remesh`` to 2 surviving ranks, on 2 agree within 2e-5; the
    4-rank state, checkpointed whole, restores bitwise onto the 2-rank
    mesh."""
    results = W.spawn("remesh", tmp_path, str(tmp_path / "ckpt"))
    l4, l2 = results[0][4]["loss"], results[0][2]["loss"]
    assert abs(l4 - l2) / abs(l4) <= FP32, (l4, l2)
    assert results[0][4]["mesh"] != results[0][2]["mesh"]
    assert results[0]["restored_bitwise"] and results[1]["restored_bitwise"]
    assert 2 not in results[2] and 2 not in results[3]  # left out
