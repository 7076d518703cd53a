"""The port's sharding layer on the CPU against the JAX package: the
logical-axis rules (every leaf of every assigned config, under each
parameter policy, with sequence parallelism on and off, on the 16x16,
2x16x16, (1, 1) and (3, 2) meshes), the counterparts of the reference's
``tests/test_sharding.py`` cases, DTensor placements of a spec, the
mesh-sized MoE groups, the one-device re-mesh, and the dry run.

The port's meshes are ``DeviceMesh`` objects over a ``fake`` process
group of the mesh's size, made and destroyed inside each test; the
reference's are abstract meshes of stand-in devices, as its own tests
build them. Bound for the MoE groups: max|y - ref| / max|ref| <= 2e-5 in
fp32.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import spec as jspec
from repro.sharding import rules as jrules
from repro_torch.configs import ASSIGNED, get, tiny_variant
from repro_torch.configs import SHAPES
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import layers
from repro_torch.models.spec import unflatten
from repro_torch.runtime.fault_tolerance import elastic_remesh
from repro_torch.sharding import rules

FP32 = tolerance("float32")
SRC = str(Path(__file__).resolve().parent.parent / "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "3x2": ((3, 2), ("data", "model"))}


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A ``DeviceMesh`` over a ``fake`` group of its size, this process
    rank 0; the group is destroyed on exit."""
    with dryrun.fake_group(int(np.prod(shape))):
        yield make_mesh(shape, names, "cpu")


def _jmesh(shape, names):
    """The reference's abstract mesh (``tests/test_sharding.py:11``)."""
    class D:
        def __init__(self, i):
            self.id = i
    devs = np.empty(shape, dtype=object)
    for i, idx in enumerate(np.ndindex(*shape)):
        devs[idx] = D(i)
    return Mesh(devs, names)


def _leaves(tree):
    """{path: ParamSpec} of either package's spec tree."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out[".".join(path)] = node
    walk(tree, ())
    return out


# ----------------------------------------------------------------------
# rule parity


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_spec_matches_reference_for_every_leaf(mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh = _jmesh(shape, names)
    assert tuple(ASSIGNED) == tuple(JASSIGNED)
    with fake_mesh(shape, names) as mesh:
        checked = 0
        for name in ASSIGNED:
            for policy in ("fsdp", "tp", "replicated"):
                for sp in (True, False):
                    jcfg = jget(name).replace(param_sharding=policy, extra={
                        **jget(name).extra, "sequence_parallel": sp})
                    tcfg = get(name).replace(param_sharding=policy, extra={
                        **get(name).extra, "sequence_parallel": sp})
                    jr, tr = jrules.rules_for(jcfg, jmesh), \
                        rules.rules_for(tcfg, mesh)
                    assert {k: tuple(v) for k, v in jr.items()} == tr
                    want = _leaves(jsteps.state_specs(jcfg))
                    got = _leaves(steps.state_specs(tcfg))
                    assert set(got) == set(want), name
                    for k, s in got.items():
                        assert rules.logical_spec(s.axes, s.shape, tr,
                                                  mesh) \
                            == tuple(jrules.logical_spec(
                                want[k].axes, want[k].shape, jr, jmesh)), \
                            (name, policy, sp, k)
                        checked += 1
        assert checked > 5_000


def test_batch_axes_match_reference():
    for name in ASSIGNED:
        for sname, shape in SHAPES.items():
            want = {k: ax for k, (_, _, ax)
                    in jsteps.batch_struct(jget(name), shape).items()}
            assert steps.batch_axes(get(name), shape) == want, (name, sname)


# ----------------------------------------------------------------------
# the reference's tests/test_sharding.py, case for case


CASES = [
    # (logical axes, shape, mesh, config policy or None, the spec)
    ((("vocab", "embed_fsdp"), (49664, 4096)), "16x16", None,
     ("model", "data")),
    ((("embed_fsdp", "kv_heads", None), (4096, 8, 128)), "16x16", None,
     ("data", None, None)),
    ((("seq_shard", "vocab_act"), (4096, 49664)), "16x16", None,
     ("model", None)),
    ((("batch", "seq"), (256, 4096)), "2x16x16", None,
     (("pod", "data"), None)),
    ((("embed_fsdp", "d_ff"), (4096, 14336)), "16x16", "replicated",
     (None, None)),
    ((("embed_fsdp", "d_ff"), (4096, 14336)), "16x16", "tp",
     (None, "model")),
    ((("batch", "seq_shard", None, None), (128, 1, 32, 64)), "16x16", None,
     ("data", None, None, None)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_reference_sharding_cases(case):
    """divisible dims shard; 8 KV heads fall back to replication; a mesh
    axis serves once a spec; the joint batch axis; the replicated and the
    tp-only policies; a decode step's length 1 replicates."""
    (axes, shape), mesh_name, policy, want = CASES[case]
    with fake_mesh(*MESHES[mesh_name]) as mesh:
        table = rules.DEFAULT_RULES if policy is None else rules.rules_for(
            get("granite-8b").replace(param_sharding=policy), mesh)
        assert rules.logical_spec(axes, shape, table, mesh) == want


def test_production_mesh_axes():
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
    with dryrun.fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()


# ----------------------------------------------------------------------
# placements


def test_joint_axis_places_the_block_jax_gives_the_device():
    """("pod", "data") on dim 0 splits it pod-major: the rank at mesh
    coordinate (p, d, m) holds block p * D + d, as JAX's device (p, d, m)
    does."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    for p, d, m in ((0, 0, 0), (0, 5, 3), (1, 3, 15)):
        with dryrun.fake_group(512, rank=p * 256 + d * 16 + m):
            mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")
            pl = rules.placements((("pod", "data"), None), mesh)
            assert pl == (Shard(0), Shard(0), Replicate())
            shape, offset = compute_local_shape_and_global_offset(
                (256, 4096), mesh, pl)
            assert tuple(shape) == (8, 4096)
            assert tuple(offset) == ((p * 16 + d) * 8, 0)
            with pytest.raises(ValueError):
                rules.placements((("data", "pod"),), mesh)


def test_a_mesh_axis_of_size_one_replicates():
    with fake_mesh((4, 1), ("data", "model")) as mesh:
        assert rules.placements(("data", "model"), mesh) \
            == (Shard(0), Replicate())


def test_constraints_are_no_ops_without_a_mesh():
    x = torch.randn(2, 3)
    assert rules.constrain(x, ("batch", None)) is x
    assert rules.with_logical_constraint(x, ("batch", None), None, None) \
        is x
    assert rules.current() is None


def test_elastic_remesh_of_one_device(tmp_path):
    """``tests/test_substrate.py:204``: one surviving device still makes
    a named (data, model) mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = elastic_remesh(1, model_dims=[4096, 32, 14336], device="cpu")
        assert mesh.size() == 1
        assert set(mesh.mesh_dim_names) == {"data", "model"}
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# the MoE groups


class _StubMesh:
    """The reference reads ``shape`` and ``empty``; the port's groups
    read ``shape`` alone (``rules.axis_sizes``)."""
    shape = {"model": 2}
    empty = False


@pytest.mark.parametrize("S", [16, 15])
def test_moe_groups_match_reference(S):
    """G = 2 groups (S = 16), and the fallback to one group where G does
    not divide S (S = 15)."""
    jcfg = jtiny(jget("granite-moe-3b-a800m"))
    tcfg = tiny_variant(get("granite-moe-3b-a800m"))
    jp = jspec.init_params(jlayers.moe_specs(jcfg), 0, "float32")
    tp = unflatten(params_from_reference(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    logits = jnp.einsum("bse,ef->bsf", jnp.asarray(x), jp["router"])
    jgate, jidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                jcfg.top_k)
    jgate = jgate / jgate.sum(-1, keepdims=True)
    want = jlayers._moe_scatter_dispatch(jp, jcfg, jnp.asarray(x), jidx,
                                         jgate, _StubMesh())
    got = layers._moe_scatter_dispatch(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(np.array(jidx))
        .long(), torch.from_numpy(np.array(jgate)), _StubMesh())
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) \
        <= FP32


# ----------------------------------------------------------------------
# the dry run


def _reference_local_bytes(jcfg, shape, names) -> int:
    """Each rank's bytes of the state, from the reference's specs: every
    leaf's dims divided by the mesh axes its spec names."""
    jmesh = _jmesh(shape, names)
    jr = jrules.rules_for(jcfg, jmesh)
    sizes = dict(zip(names, shape))
    total = 0
    for s in _leaves(jsteps.state_specs(jcfg)).values():
        spec = jrules.logical_spec(s.axes, s.shape, jr, jmesh)
        n = 1
        for dim, entry in zip(s.shape, tuple(spec) + (None,) * len(s.shape)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        dt = np.dtype(s.dtype or jcfg.param_dtype) \
            if (s.dtype or jcfg.param_dtype) != "bfloat16" else np.dtype(
                np.float16)
        total += n * dt.itemsize
    return total


@pytest.mark.parametrize("name", ["mamba2-370m"])
def test_dry_run_counts_match_the_reference_specs(name, tmp_path):
    """The 16x16 cell in this process (no group left behind after it),
    the 2x16x16 one beside it in a subprocess."""
    outs = [tmp_path / "dry16.json", tmp_path / "dry2x16.json"]
    args = ["--arch", name, "--tiny", "--out"]
    pod = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         str(outs[1]), "--multi-pod"], env={**os.environ, "PYTHONPATH": SRC},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    assert dryrun.main([*args, str(outs[0])]) == 0
    assert not dist.is_initialized()  # no group left behind
    _, err = pod.communicate(timeout=600)
    assert pod.returncode == 0, err[-2000:]
    reports = [r for out in outs for r in json.loads(out.read_text())]
    assert [r["mesh"] for r in reports] == ["16x16", "2x16x16"]
    jcfg = jtiny(jget(name))
    for rep in reports:
        shape, names = MESHES[rep["mesh"]]
        r = rep["per_rank"]
        assert r["param_bytes"] + r["opt_bytes"] \
            == _reference_local_bytes(jcfg, shape, names)
        assert r["flops"] > 0 and r["collective_bytes"] > 0
        assert all(v > 0 for v in r["collectives"].values())
        assert {"all-gather", "all-reduce"} <= set(r["collectives"])
        assert rep["peaks"].startswith("H100 SXM")
