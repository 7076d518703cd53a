"""The port's training substrate on the CPU against the JAX package: the
optimizers, the schedule and the clip, error-feedback compression, the
state specs, the token pipeline, checkpoints and the restart loop.

Inputs are numpy-seeded and go through both packages. Bounds:
max|y - ref| / max|ref| <= tolerance(dtype) (2e-5 in fp32); a bf16 state
within bf16's. The pipeline's tokens and an fp32 or int32 checkpoint are
bitwise the reference's; a bf16 leaf is stored as its uint16 bits and
restored bit for bit. The port's counterparts of the reference's
``test_fault_tolerance.py`` and of ``test_substrate.py``'s optimizer,
pipeline, checkpoint, straggler and restart tests close the file.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch import steps as jsteps
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedule as jschedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ASSIGNED, SHAPES, applicable_shapes, names
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.core.dtypes import tolerance
from repro_torch.data import TokenPipeline, prefetch
from repro_torch.launch import steps
from repro_torch.models.spec import flatten, unflatten
from repro_torch.optim import adafactor, adamw, compression, schedule
from repro_torch.runtime import (StragglerWatch, TransientFailure,
                                 resilient_train)

FP32 = tolerance("float32")
# a stacked (layers, rows, cols) leaf, a matrix, a vector (the three
# cases Adafactor factors or not) and a scalar
SHAPES_OPT = {"stack": (3, 8, 6), "mat": (5, 7), "vec": (9,), "one": (1,)}


def _rel(y, r):
    y = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(
        y, dtype=np.float32)
    r = np.asarray(r, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    if not r.size:
        return 0.0
    return float(np.abs(y - r).max() / max(np.abs(r).max(), 1e-30))


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES_OPT.items()}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(port_tree, ref_tree, tol):
    pf, rf = flatten(port_tree), flatten(jax.tree.map(np.asarray, ref_tree))
    assert set(pf) == set(rf)
    for k in rf:
        assert str(pf[k].dtype).replace("torch.", "") == str(rf[k].dtype), k
        assert _rel(pf[k], rf[k].astype(np.float32)) <= tol, k


# ----------------------------------------------------------------------
# the optimizers against the reference


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(state_dtype):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tp, jp = _port(params), _jax(params)
    ts, js = adamw.init(tp, state_dtype), jadamw.init(jp, state_dtype)
    for step in range(4):
        g = _tree(rng, 1e-2)
        lr = 1e-2 * (step + 1)
        tp, ts = adamw.update(_port(g), ts, tp,
                              lr=schedule.const(lr, tp["vec"]))
        jp, js = jadamw.update(_jax(g), js, jp, lr=jnp.float32(lr))
        _close(tp, jp, FP32)
        _close(ts, js, tolerance(state_dtype))
    assert int(ts["step"]) == 4 and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adafactor_matches_reference_over_steps(state_dtype):
    """Factored stacked 3-D and 2-D leaves, unfactored 1-D ones with the
    (0,) placeholder column statistic."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tp, jp = _port(params), _jax(params)
    ts = adafactor.init(tp, state_dtype)
    js = jadafactor.init(jp, state_dtype)
    assert tuple(ts["vr"]["stack"].shape) == (3, 8)
    assert tuple(ts["vc"]["stack"].shape) == (3, 6)
    assert tuple(ts["vc"]["vec"].shape) == (0,)
    for step in range(4):
        g = _tree(rng, 1e-2)
        tp, ts = adafactor.update(_port(g), ts, tp,
                                  lr=schedule.const(1e-2, tp["vec"]),
                                  weight_decay=0.01)
        jp, js = jadafactor.update(_jax(g), js, jp, lr=jnp.float32(1e-2),
                                   weight_decay=0.01)
        _close(tp, jp, FP32)
        _close({k: ts[k] for k in ("vr", "vc")},
               {k: js[k] for k in ("vr", "vc")}, FP32)
        _close(ts["m"], js["m"], tolerance(state_dtype))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 40, 99, 100, 150])
def test_warmup_cosine_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    want = jschedule.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= FP32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    tree = _tree(rng, 3.0)
    tp = {k: v.to(getattr(torch, dtype)) for k, v in _port(tree).items()}
    jp = {k: v.astype(dtype) for k, v in _jax(tree).items()}
    got, gnorm = schedule.clip_by_global_norm(tp, 1.0)
    want, jnorm = jschedule.clip_by_global_norm(jp, 1.0)
    assert _rel(gnorm, jnorm) <= FP32
    _close(got, want, tolerance(dtype))


def test_ef_compress_matches_reference():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((6, 10)).astype(np.float32)
    err = compression.init_error_state({"g": torch.from_numpy(g)})["g"]
    jerr = jcompression.init_error_state({"g": jnp.asarray(g)})["g"]
    for _ in range(3):
        codes, scale, err = compression.ef_compress(torch.from_numpy(g), err)
        jcodes, jscale, jerr = jcompression.ef_compress(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        assert codes.dtype == torch.int8
        assert _rel(scale, jscale) <= FP32
        assert float(np.abs(err.numpy() - np.asarray(jerr)).max()) \
            <= FP32 * float(np.abs(g).max())


# ----------------------------------------------------------------------
# configs and state specs


def test_assigned_configs_and_shapes_match_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import applicable_shapes as japplicable
    from repro.configs import names as jnames

    assert ASSIGNED == JASSIGNED
    assert set(JASSIGNED) <= set(names()) and set(names()) <= set(jnames())
    assert {k: vars(v) for k, v in SHAPES.items()} \
        == {k: vars(v) for k, v in JSHAPES.items()}
    for name in ASSIGNED:
        assert [s.name for s in applicable_shapes(tget(name))] \
            == [s.name for s in japplicable(jget(name))]


@pytest.mark.parametrize("name", ASSIGNED)
def test_state_specs_match_reference(name):
    """The tiny variant's state tree: the same paths, shapes and dtypes
    as the reference's, params and optimizer state."""
    jcfg, tcfg = jtiny(jget(name)), ttiny(tget(name))
    assert (tcfg.optimizer, tcfg.opt_state_dtype) \
        == (jcfg.optimizer, jcfg.opt_state_dtype)
    want = flatten(jax.tree.map(
        lambda s: (tuple(s.shape), s.dtype or jcfg.param_dtype),
        jsteps.state_specs(jcfg),
        is_leaf=lambda x: hasattr(x, "axes")))
    got = flatten(steps.state_specs(tcfg))
    assert {k: (tuple(s.shape), s.dtype or tcfg.param_dtype)
            for k, s in got.items()} == want
    state = flatten(steps.init_state(tcfg, 0, "cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in state.items()} == want


def test_batch_struct_matches_reference():
    for name in ASSIGNED:
        jcfg, tcfg = jget(name), tget(name)
        for sname, shape in SHAPES.items():
            got = steps.batch_struct(tcfg, shape)
            want = jsteps.batch_struct(jcfg, shape)
            assert {k: (s, str(d).replace("torch.", ""))
                    for k, (s, d) in got.items()} \
                == {k: (s, str(jnp.dtype(d))) for k, (s, d, _)
                    in want.items()}, (name, sname)


# ----------------------------------------------------------------------
# the token pipeline


@pytest.mark.parametrize("corpus", [False, True])
def test_pipeline_batches_are_the_references(corpus):
    data = (np.random.default_rng(4).integers(0, 90, 500).astype(np.int32)
            if corpus else None)
    tp = TokenPipeline(90, 16, 4, seed=7, corpus=data)
    jp = JTokenPipeline(90, 16, 4, seed=7, corpus=data)
    for step in (5, 0, 5, 123):
        got, want = tp.batch(step, device="cpu"), jp.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      got["labels"][:, :-1].numpy())


def test_pipeline_deterministic_skip_ahead():
    p1 = TokenPipeline(1000, 16, 4, seed=7)
    p2 = TokenPipeline(1000, 16, 4, seed=7)
    b1 = p1.batch(5, "cpu")
    for _ in range(3):
        p2.batch(0, "cpu")  # unrelated reads do not perturb determinism
    assert torch.equal(p2.batch(5, "cpu")["tokens"], b1["tokens"])
    assert not torch.equal(p1.batch(6, "cpu")["tokens"], b1["tokens"])


def test_pipeline_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = TokenPipeline(50, 8, 2, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.batch(0)
    b = p.batch(0, device="cpu")
    assert tuple(b["tokens"].shape) == (2, 8) == tuple(b["labels"].shape)


def test_prefetch_keeps_order_and_ends():
    p = TokenPipeline(50, 8, 2, seed=1)
    got = list(prefetch((p.batch(s, "cpu") for s in range(5)), depth=2))
    assert len(got) == 5
    for s, b in enumerate(got):
        assert torch.equal(b["tokens"], p.batch(s, "cpu")["tokens"])


# ----------------------------------------------------------------------
# checkpoints


def _state(rng):
    return {"params": {"w": torch.from_numpy(
        rng.standard_normal((2, 3)).astype(np.float32)),
        "h": torch.from_numpy(rng.standard_normal(5).astype(np.float32)
                              ).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "vc": torch.zeros((0,), dtype=torch.float32)}}


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip_fp32_int32_bf16(tmp_path, async_save):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=async_save)
    tree = _state(np.random.default_rng(5))
    mgr.save(10, tree)
    mgr.wait()
    step, got = mgr.restore()
    assert step == 10
    for k, v in flatten(tree).items():
        assert flatten(got)[k].dtype == v.dtype, k
        assert torch.equal(flatten(got)[k], v), k
    meta = json.loads((tmp_path / "step_10" / "META.json").read_text())
    assert meta["dtypes"]["params/h"] == "bfloat16"
    assert meta["dtypes"]["opt/step"] == "int32"


def test_checkpoint_async_save_copies_before_the_writer_runs(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    w = torch.ones(4)
    mgr.save(1, {"w": w})
    w.add_(1.0)  # after save: the checkpoint holds the value at save
    mgr.wait()
    assert torch.equal(mgr.restore(1)[1]["w"], torch.ones(4))


def test_checkpoint_keep_integrity_and_torn_write(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, {"w": torch.arange(6.0).reshape(2, 3)})
    assert mgr.all_steps() == [20, 30]
    torn = tmp_path / "step_40"
    torn.mkdir()
    (torn / "shard_0.npz").write_bytes(b"partial")  # no COMMIT marker
    (tmp_path / ".tmp_step_50").mkdir()
    assert mgr.latest_step() == 30
    shard = tmp_path / "step_30" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:-7] + b"corrupt")
    with pytest.raises(IOError):
        mgr.restore(30)
    assert torch.equal(mgr.restore(20)[1]["w"],
                       torch.arange(6.0).reshape(2, 3))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference restores a port fp32/int32 checkpoint bitwise, and the
    port restores the reference's."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    CheckpointManager(tmp_path / "port", async_save=False).save(
        7, {"params": {"w": torch.from_numpy(w)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}})
    step, tree = JCheckpointManager(tmp_path / "port").restore()
    assert step == 7
    np.testing.assert_array_equal(tree["params"]["w"], w)
    assert tree["opt"]["step"].dtype == np.int32 and int(
        tree["opt"]["step"]) == 7
    JCheckpointManager(tmp_path / "ref", async_save=False).save(
        9, {"params": {"w": jnp.asarray(w)}, "opt": {"step": jnp.int32(9)}})
    step, tree = CheckpointManager(tmp_path / "ref").restore()
    assert step == 9
    assert torch.equal(tree["params"]["w"], torch.from_numpy(w))
    assert tree["opt"]["step"].dtype == torch.int32


# ----------------------------------------------------------------------
# the reference's substrate tests, ported


def _quadratic_problem():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}

    def grads_of(p):
        return {"w": 2 * (p["w"] - target)}
    return params, grads_of, target


def test_adamw_converges():
    params, grads_of, target = _quadratic_problem()
    state = adamw.init(params)
    lr = schedule.const(0.05, params["w"])
    for _ in range(300):
        params, state = adamw.update(grads_of(params), state, params, lr=lr,
                                     weight_decay=0.0)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_adamw_bf16_states():
    params = {"w": torch.ones((4, 4))}
    state = adamw.init(params, state_dtype="bfloat16")
    assert state["m"]["w"].dtype == torch.bfloat16
    newp, state = adamw.update({"w": torch.ones((4, 4))}, state, params,
                               lr=schedule.const(0.1, params["w"]))
    assert newp["w"].dtype == params["w"].dtype


def test_adafactor_converges_and_factors():
    params = {"w": torch.zeros((8, 6)), "b": torch.zeros(6)}
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 6)).astype(np.float32))
    state = adafactor.init(params)
    assert tuple(state["vr"]["w"].shape) == (8,)  # factored row stats
    assert tuple(state["vc"]["w"].shape) == (6,)
    lr = schedule.const(0.05, params["w"])
    for _ in range(400):
        g = {"w": 2 * (params["w"] - target), "b": params["b"] * 0}
        params, state = adafactor.update(g, state, params, lr=lr)
    assert float((params["w"] - target).abs().mean()) < 0.1


def test_optimizer_state_specs_match_params():
    cfg = ttiny(tget("granite-8b"))
    state = steps.init_state(cfg, 0, "cpu")
    assert len(flatten(state)) == len(flatten(steps.state_specs(cfg)))


def test_schedule_shapes():
    def lr(step):
        return float(schedule.warmup_cosine(
            torch.tensor(step), peak_lr=1e-3, warmup_steps=10,
            total_steps=100))
    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(100) < 2e-4


def test_clip_by_global_norm():
    clipped, norm = schedule.clip_by_global_norm({"a": torch.ones(4) * 100},
                                                 1.0)
    assert abs(float(clipped["a"].norm()) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(200.0)


def test_straggler_watch_raises():
    w = StragglerWatch(factor=2.0, max_breaches=2, warmup=0)
    for _ in range(6):
        w.observe(0.1)
    w.observe(0.5)
    with pytest.raises(RuntimeError):
        w.observe(0.5)


def test_straggler_warmup_steps_are_ignored():
    w = StragglerWatch(factor=3.0, max_breaches=5, warmup=3)
    for _ in range(3):
        w.observe(10.0)  # the first steps: ignored
    for _ in range(4):
        w.observe(0.01)  # 4 samples after them: still no deadline
    assert w.breaches == 0
    w.observe(0.01)  # the 5th arms the watch
    assert w.breaches == 0


def test_straggler_breach_accounting_and_raise():
    w = StragglerWatch(factor=3.0, max_breaches=2, warmup=0)
    for _ in range(5):
        w.observe(0.01)
    w.observe(0.02)  # 2x p50: under the 3x deadline
    assert w.breaches == 0
    w.observe(0.1)
    assert w.breaches == 1
    with pytest.raises(RuntimeError, match="straggler"):
        w.observe(0.1)
    assert w.breaches == 2


def test_straggler_median_tracks_history():
    w = StragglerWatch(factor=3.0, max_breaches=100, warmup=0)
    for _ in range(5):
        w.observe(0.01)
    for _ in range(20):
        w.observe(0.05)  # a new steady state: 5x the old p50
    before = w.breaches
    w.observe(0.06)
    assert w.breaches == before


class _StepPipeline:
    """(seed, step)-pure: batch(step) == step."""

    def batch(self, step, device=None):
        return torch.tensor(float(step))


def _train_step(state, batch):
    w = state["w"] + batch
    return {"w": w}, {"loss": w}


def test_resilient_train_restores_from_checkpoint_and_replays(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)
    fired = []

    def inject(step):
        if step == 5 and not fired:  # once, after the step-4 checkpoint
            fired.append(step)
            raise TransientFailure("injected device loss at step 5")

    state, step, failures = resilient_train(
        state={"w": torch.tensor(0.0)}, train_step=_train_step,
        pipeline=_StepPipeline(), ckpt=ckpt, total_steps=6, ckpt_every=2,
        fail_injector=inject)
    assert step == 6 and failures == 1
    assert float(state["w"]) == float(sum(range(6)))
    restored_step, host = ckpt.restore(4)
    assert restored_step == 4 and float(host["w"]) == float(sum(range(4)))


def test_resilient_train_without_checkpoint_replays_from_the_top(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)
    fired = []

    def inject(step):
        if step == 1 and not fired:
            fired.append(step)
            raise TransientFailure("injected before any checkpoint")

    state, step, failures = resilient_train(
        state={"w": torch.tensor(0.0)}, train_step=_train_step,
        pipeline=_StepPipeline(), ckpt=ckpt, total_steps=3, ckpt_every=10,
        fail_injector=inject)
    assert (step, failures) == (3, 1)
    assert float(state["w"]) == float(sum(range(3)))


def test_resilient_train_gives_up_past_max_failures(tmp_path):
    ckpt = CheckpointManager(tmp_path, async_save=False)

    def always_fail(step):
        raise TransientFailure("persistent fault")

    with pytest.raises(TransientFailure):
        resilient_train(state={"w": torch.tensor(0.0)},
                        train_step=_train_step, pipeline=_StepPipeline(),
                        ckpt=ckpt, total_steps=3, ckpt_every=1,
                        max_failures=2, fail_injector=always_fail)


def _toy_train_setup(tmp_path):
    def train_step(state, batch):
        g = state["w"] - batch["tokens"].float().mean()
        return {"w": state["w"] - 0.1 * g}, {"loss": (g * g).sum()}

    return ({"w": torch.zeros(4)}, train_step,
            TokenPipeline(100, 4, 2, seed=3),
            CheckpointManager(tmp_path, async_save=False))


def test_resilient_train_survives_failures(tmp_path):
    params, train_step, pipe, ckpt = _toy_train_setup(tmp_path)
    boom = {20: True, 35: True}

    def injector(step):
        if boom.pop(step, None):
            raise TransientFailure(f"injected at {step}")

    _, step, failures = resilient_train(
        state=params, train_step=train_step, pipeline=pipe, ckpt=ckpt,
        total_steps=50, ckpt_every=10, max_failures=5,
        fail_injector=injector)
    assert step == 50 and failures == 2


def test_resilient_train_replays_identically(tmp_path):
    """Crash and restore give the uninterrupted run's state, bit for bit,
    on the device of the state it started from."""
    params, train_step, pipe, ckpt = _toy_train_setup(tmp_path / "a")
    ref, _, _ = resilient_train(state=params, train_step=train_step,
                                pipeline=pipe, ckpt=ckpt, total_steps=30,
                                ckpt_every=5, max_failures=0)
    params, train_step, pipe, ckpt = _toy_train_setup(tmp_path / "b")
    hits = {17: True}

    def injector(step):
        if hits.pop(step, None):
            raise TransientFailure("boom")

    got, _, fails = resilient_train(
        state=params, train_step=train_step, pipeline=pipe, ckpt=ckpt,
        total_steps=30, ckpt_every=5, max_failures=2, fail_injector=injector)
    assert fails == 1
    assert got["w"].dtype == torch.float32 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], ref["w"])


def test_restart_puts_each_leaf_back_on_its_dtype(tmp_path):
    """A restore casts each host array to the live leaf's dtype: a bf16
    leaf and an int32 step come back as they were saved."""
    ckpt = CheckpointManager(tmp_path, async_save=False)
    hits = {3: True}

    def step_fn(state, batch):
        return ({"h": state["h"] + 1, "step": state["step"] + 1},
                {"loss": state["h"].float().sum()})

    def injector(step):
        if hits.pop(step, None):
            raise TransientFailure("boom")

    state, _, fails = resilient_train(
        state={"h": torch.zeros(3, dtype=torch.bfloat16),
               "step": torch.zeros((), dtype=torch.int32)},
        train_step=step_fn, pipeline=_StepPipeline(), ckpt=ckpt,
        total_steps=5, ckpt_every=2, max_failures=1, fail_injector=injector)
    assert fails == 1
    assert state["h"].dtype == torch.bfloat16 and state["step"].dtype \
        == torch.int32
    assert int(state["step"]) == 5 and torch.equal(
        state["h"], torch.full((3,), 5.0, dtype=torch.bfloat16))


def test_convert_carries_an_optimizer_state_tree():
    """``params_from_reference`` carries the reference's AdamW and
    Adafactor states with each leaf's dtype: the int32 step exactly, the
    (0,) placeholders, bf16 momentum."""
    from repro_torch.convert import params_from_reference

    jcfg = jtiny(jget("deepseek-v2-236b"))  # Adafactor, bf16 storage
    jstate = jax.tree.map(np.asarray, jsteps.init_state(jcfg, 0))
    jstate["opt"]["step"] = np.asarray(2 ** 30 + 1, np.int32)
    got = params_from_reference(jstate)
    want = flatten(jstate)
    assert set(got) == set(want)
    for k, v in got.items():
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), k
        assert tuple(v.shape) == want[k].shape, k
    assert int(got["opt.step"]) == 2 ** 30 + 1
    assert unflatten(got)["opt"]["vc"]["ln_f"]["w"].shape == (0,)
