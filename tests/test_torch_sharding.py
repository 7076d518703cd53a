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
from repro.models import registry as jregistry
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


def _local_elems(dims, axes, jr, jmesh, sizes) -> int:
    """The elements of a rank's block of a leaf: its dims divided by the
    mesh axes the reference's spec names."""
    spec = jrules.logical_spec(axes, dims, jr, jmesh)
    n = 1
    for dim, entry in zip(dims, tuple(spec) + (None,) * len(dims)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // int(np.prod([sizes[a] for a in axes]))
    return n


def _itemsize(dtype) -> int:
    return 2 if str(dtype) == "bfloat16" else np.dtype(str(dtype)).itemsize


def _reference_local_bytes(jcfg, shape, names, part=None) -> int:
    """Each rank's bytes of the state (or of its ``part``, "params" or
    "opt"), from the reference's specs: every leaf's dims divided by the
    mesh axes its spec names."""
    jmesh = _jmesh(shape, names)
    jr = jrules.rules_for(jcfg, jmesh)
    sizes = dict(zip(names, shape))
    specs = jsteps.state_specs(jcfg)
    total = 0
    for s in _leaves(specs if part is None else specs[part]).values():
        total += _local_elems(s.shape, s.axes, jr, jmesh, sizes) \
            * _itemsize(s.dtype or jcfg.param_dtype)
    return total


def _reference_cache_bytes(jcfg, cell, shape, names) -> int:
    """Each rank's bytes of a cell's decode caches: the reference's
    ``cache_struct`` split by its ``logical_spec``."""
    jmesh = _jmesh(shape, names)
    jr = jrules.rules_for(jcfg, jmesh)
    sizes = dict(zip(names, shape))
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            leaves.append(node)
    walk(jregistry.cache_struct(jcfg, cell.global_batch, cell.seq_len))
    return sum(_local_elems(tuple(dims), axes, jr, jmesh, sizes)
               * _itemsize(dt) for dims, dt, axes in leaves)


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


def test_dry_run_serving_cells_match_the_reference_specs(tmp_path):
    """Tiny mamba2-370m's ``prefill_32k`` cell and tiny qwen2's
    ``decode_32k`` cell on the 16x16 fake group, and tiny mamba2-370m's
    ``decode_32k`` on the 2x16x16 one: the parameter bytes a rank and the
    cache bytes a rank are the reference's specs split by its rules (the
    prefill's caches padded to the decode length, at its batch); a decode
    step's collectives move fewer bytes than its caches hold (the
    split-KV decode: no cache block moves; the products leave the weights
    in place and keep the tokens split over ``pod``, which splits no
    weight); no group is left behind."""
    for name, cell, mesh in (("mamba2-370m", "prefill_32k", "16x16"),
                             ("qwen2-0.5b", "decode_32k", "16x16"),
                             ("mamba2-370m", "decode_32k", "2x16x16")):
        shape, names = MESHES[mesh]
        jcfg = jtiny(jget(name))
        out = tmp_path / f"{cell}_{mesh}.json"
        assert dryrun.main(["--arch", name, "--tiny", "--shape", cell,
                            "--out", str(out)]
                           + (["--multi-pod"] if mesh == "2x16x16" else [])
                           ) == 0
        assert not dist.is_initialized()  # no group left behind
        (rep,) = json.loads(out.read_text())
        r = rep["per_rank"]
        assert rep["kind"] == SHAPES[cell].kind and rep["mesh"] == mesh
        assert r["param_bytes"] == _reference_local_bytes(
            jcfg, shape, names, "params")
        assert r["opt_bytes"] == 0
        assert r["cache_bytes"] == _reference_cache_bytes(
            jcfg, SHAPES[cell], shape, names) > 0
        assert r["flops"] > 0 and r["collective_bytes"] > 0
        assert rep["model_flops"] == 2 * jcfg.num_params() \
            * SHAPES[cell].global_batch * (
                1 if cell == "decode_32k" else SHAPES[cell].seq_len)
        if cell == "decode_32k":
            assert r["collective_bytes"] < r["cache_bytes"]



def test_pad_seq_pads_each_block_and_keeps_two_placements():
    """``lm.pad_seq`` of a prefill cache on a (1, 4) mesh: each rank pads
    its block, the result keeps one placement a mesh dim and its values,
    and the decode cell's constraint after it leaves each rank a quarter
    of the padded sequence (on the card's torch 2.11 DTensor's own pad
    returned one placement, and the constraint a whole-length block)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import lm
    a = torch.arange(4 * 32 * 2 * 3, dtype=torch.float32).reshape(4, 32, 2, 3)
    with fake_mesh((1, 4), ("data", "model")) as mesh:
        d = distribute_tensor(a, mesh, [Replicate(), Replicate()])
        out = lm.pad_seq(d, 36)
        assert tuple(out.placements) == (Replicate(), Replicate())
        assert tuple(out.shape) == (4, 36, 2, 3)
        assert torch.equal(out.to_local(),
                           torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 4)))
        split = out.redistribute(mesh, [Replicate(), Shard(1)])
        assert tuple(split.to_local().shape) == (4, 9, 2, 3)
        assert lm.pad_seq(d, 32) is d
