"""The port's train step on the CPU against the JAX package: the loss,
one and two steps of ``make_train_step`` for tiny configs of every
family that reaches a different path (Mamba-2's conv, GQA, MoE's aux,
the encoder-decoder's frames, the VLM's patch embeddings), gradient
accumulation, rematerialization, ``causal_conv1d``'s gradient, the
reference's end-to-end training tests, and the train CLI.

The reference's train step is jitted; its weights are drawn once and
carried across with ``repro_torch.convert``. Bound: max|y - ref| /
max|ref| <= 2e-5 in fp32. A train step is held as its gradients (every
entry) and as the reference's optimizer applied to them (every entry);
against the reference's own step the parameters are compared only where
its gradient and new first moment exceed 1e-2 of their leaf's largest:
Adam moves an entry nearer zero by a whole step in the direction of its
sign, which rounding may flip. bf16 train steps hold
the loss and the grad norm within 3e-2 (the reference's own bf16 lies
that far from its fp32 at depth).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.optim import schedule as jschedule
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.data import TokenPipeline
from repro_torch.kernels import causal_conv1d as cc
from repro_torch.kernels import ref
from repro_torch.launch import steps, train
from repro_torch.models import lm, registry
from repro_torch.models.spec import flatten, unflatten
from repro_torch.runtime import TransientFailure, resilient_train

FP32 = tolerance("float32")
BF16 = tolerance("bfloat16")
B, S = 4, 24
KW = dict(peak_lr=1e-3, warmup=2, total_steps=10)
# the parameters and moments after a step are compared where the
# reference's gradient and new first moment exceed LIVE times their
# leaf's largest (see test_train_steps_match_reference)
LIVE = 1e-2


def _rel(y, r):
    y = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(
        y, dtype=np.float32)
    r = np.asarray(r, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    if not r.size:
        return 0.0
    return float(np.abs(y - r).max() / max(np.abs(r).max(), 1e-30))


def _batch(jcfg, seed=0):
    """A numpy batch of the config's inputs: tokens and labels (some
    masked with -1), and an encoder-decoder's frames or a VLM's patch
    embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32),
        "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if jcfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    if jcfg.frontend == "vit_stub":
        ft = jcfg.frontend_tokens
        out["tokens"] = out["tokens"][:, :S - ft]
        out["patch_embeds"] = rng.standard_normal(
            (B, ft, jcfg.d_model)).astype(np.float32) * 0.02
    return out


def _jgrads(jcfg, metrics=False):
    """The reference's gradients of its train loss (``make_train_step``'s
    ``loss_fn`` on fp32 weights), jitted: (params, batch) -> grads; with
    ``metrics``, -> (grads, {"loss", "aux"})."""
    fwd = jsteps._forward_for(jcfg)

    def total(p, batch):
        logits, _, aux = fwd(p, batch, "train", None, None)
        loss = jsteps._ce_loss(logits, batch["labels"])
        return loss + jcfg.router_aux_weight * aux, {"loss": loss, "aux": aux}
    if metrics:
        return jax.jit(lambda p, b: jax.grad(total, has_aux=True)(p, b))
    return jax.jit(jax.grad(lambda p, b: total(p, b)[0]))


def _state(jcfg, seed=0):
    jstate = jax.tree.map(np.asarray, jsteps.init_state(jcfg, seed))
    return jstate, unflatten(params_from_reference(jstate))


# ----------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_loss_matches_reference(dtype):
    """Masked labels; the max subtracted in the logits' dtype; the
    value and the gradient against the logits."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:5] = -1
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    want, jg = jax.value_and_grad(jsteps._ce_loss)(jl, jnp.asarray(labels))
    got = steps._ce_loss(tl, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) <= FP32
    assert tg.dtype == tl.dtype
    assert _rel(tg, np.asarray(jg.astype(jnp.float32))) <= tolerance(dtype)


def test_ce_loss_ignores_every_masked_position():
    logits = torch.randn(2, 3, 10)
    assert float(steps._ce_loss(logits, torch.full((2, 3), -1))) == 0.0


# ----------------------------------------------------------------------
# train steps against the reference's


CASES = [("mamba2-370m", 1), ("qwen2-0.5b", 1),
         ("granite-moe-3b-a800m", 1), ("whisper-base", 1),
         ("internvl2-26b", 1), ("mamba2-370m", 2)]


@pytest.mark.parametrize("name,accum", CASES)
def test_train_steps_match_reference(name, accum):
    """Two steps, each taken by both packages from the reference's state
    (the first from the initial one) on one batch, held three ways:

    - the gradients (``loss_and_grads``; with ``accum`` micro-batches
      summed into fp32 zeros in order, then divided) within the bound on
      every entry, and the step's loss, aux, grad norm and lr;
    - the step itself: the port's parameters and optimizer state after it
      are the reference's ``clip_by_global_norm`` and optimizer update
      applied to the port's gradients, within the bound on every entry;
    - against the reference's own step: the parameters and AdamW's
      moments where the reference's gradient and new first moment exceed
      ``LIVE`` (1e-2) of their leaf's largest. Adam's step ``m / (sqrt(v)
      + eps)`` turns a sign into a whole step, and passes an entry's
      relative gradient difference on to its step, which an entry at 1e-2
      of its leaf's largest magnifies a hundredfold. A zero-initialized
      leaf (a bias, ``A_log``) is, after the steps, its steps alone: it is
      held by the two checks above only. Adafactor's per-row and
      per-column normalization does the same to its momentum, which is
      held by the two checks above only.

    A leaf whose gradient is rounding noise (largest entry within the
    bound of the largest of any leaf) is held to that noise level and not
    compared entry by entry against the reference's step."""
    hold_train_steps(jtiny(jget(name)), ttiny(tget(name)), accum)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def hold_train_steps(jcfg, tcfg, accum=1, bound=FP32, own_step=True,
                     jstate=None):
    """``test_train_steps_match_reference``'s two steps of ``jcfg`` and
    ``tcfg`` within ``bound``, from ``jstate`` (the reference's draw by
    default); ``own_step=False`` leaves out the third check, against the
    reference's own step (16-bit weights round an entry's step to the
    weight's grid, where a rounding of the gradient moves it by a whole
    unit)."""
    if jstate is None:
        jstate, _ = _state(jcfg)
    zero = {k for k, v in flatten(jstate["params"]).items()
            if not _f32(v).any()}
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jts = jax.jit(jsteps.make_train_step(jcfg, accum=accum, **KW))
    tts = steps.make_train_step(tcfg, accum=accum, **KW)
    # without the reference's own step, its loss and aux come with its
    # gradients (one compiled function fewer)
    jopt, jgrads = joptim.get(jcfg.optimizer), _jgrads(jcfg, not own_step)

    @jax.jit
    def jupdate(grads, jstate, step):
        """The reference's clip and optimizer update of ``grads`` (jitted:
        eager, each of its operations compiles on its own)."""
        clipped, _ = jschedule.clip_by_global_norm(grads, 1.0)
        lr = jschedule.warmup_cosine(step, peak_lr=KW["peak_lr"],
                                     warmup_steps=KW["warmup"],
                                     total_steps=KW["total_steps"])
        return jopt.update(clipped, jstate["opt"], jstate["params"],
                           lr=lr), lr
    rows = [slice(i * B // accum, (i + 1) * B // accum) for i in range(accum)]
    # the reference's gradient of a leaf has the leaf's dtype
    jdt = {k: np.asarray(v).dtype
           for k, v in flatten(jstate["params"]).items()}
    for step in range(2):
        tstate = unflatten(params_from_reference(jstate))
        jouts = [jax.tree.map(np.asarray, jgrads(
            jstate["params"], {k: v[r] for k, v in jb.items()}))
            for r in rows]
        jparts = [flatten(o if own_step else o[0]) for o in jouts]
        tparts = [flatten(steps.loss_and_grads(
            tcfg, tstate["params"], {k: v[r] for k, v in tb.items()})[0])
            for r in rows]
        jg = {k: sum(_f32(g[k]) for g in jparts) / accum for k in jparts[0]}
        tg = {k: sum((g[k] for g in tparts), torch.zeros_like(v)) / accum
              for k, v in tparts[0].items()}
        gmax = max(np.abs(g).max() for g in jg.values())
        noise = {k for k, g in jg.items() if np.abs(g).max() <= FP32 * gmax}
        for k, v in tg.items():
            if k in noise:
                assert float(v.abs().max()) <= FP32 * gmax, (step, k)
            else:
                assert _rel(v, jg[k]) <= bound, (step, k)
        tnew, tm = tts(tstate, tb)
        (jp, jo), lr = jupdate(unflatten({
            k: jnp.asarray(v.float().numpy()).astype(jdt[k])
            for k, v in tg.items()}), jstate, jnp.asarray(step + 1, jnp.int32))
        if own_step:
            jnew, jm = jts(jstate, jb)
            jnew = jax.tree.map(np.asarray, jnew)
        else:
            jnew = {"params": jax.tree.map(np.asarray, jp),
                    "opt": jax.tree.map(np.asarray, jo)}
            jm = {k: sum(o[1][k] for o in jouts) / accum
                  for k in ("loss", "aux")}
            jm.update(lr=lr, grad_norm=np.sqrt(sum(
                np.sum(g.astype(np.float64) ** 2) for g in jg.values())))
        assert set(tm) == set(jm) == {"loss", "aux", "grad_norm", "lr"}
        for k in jm:
            assert tm[k].dtype == torch.float32
            assert _rel(tm[k], jm[k]) <= bound, (step, k)
        tflat = flatten(tnew)
        assert int(tflat["opt.step"]) == step + 1
        assert tflat["opt.step"].dtype == torch.int32
        for k, want in flatten({"params": jp, "opt": jo}).items():
            assert _rel(tflat[k], want) <= bound, (step, k)
        jstate = jnew
        if not own_step:
            continue
        jflat = flatten(jnew)
        for k, want in jflat.items():
            tree, _, leaf = k.partition(".")
            if tree == "opt":
                kind, _, leaf = leaf.partition(".")
                if kind not in ("m", "v") or tcfg.optimizer != "adamw":
                    continue
            if leaf in noise or leaf in zero:
                continue
            m = np.abs(_f32(jflat[f"opt.m.{leaf}"]))
            live = (np.abs(jg[leaf]) > LIVE * np.abs(jg[leaf]).max()) \
                & (m > LIVE * m.max())
            diff = np.abs(tflat[k].numpy() - want)[live]
            assert diff.size == 0 or diff.max() / np.abs(want).max() \
                <= bound, (step, k)


def test_ssd_gradient_is_finite_at_the_published_chunk():
    """Over 256 positions the SSD's decays above the diagonal (inside a
    chunk and between chunks) reach sums of ~180 and overflow fp32; the
    reference's gradient is then NaN (its backward multiplies the zero
    gradient of a ``where`` by the infinite ``exp``), the port's masks the
    exponents first. Where the reference's stays finite (time steps
    shrunk by ``dt_bias`` = -3) the port's gradients at the published
    chunk (256) are the reference's; where it is NaN the port's are
    finite and within 1e-4 at chunk 256 and chunk 64 (the SSD's value
    does not depend on the chunk; its sums run in other orders, and
    ``A_log``'s gradient, a sum over every position, moves 3e-5)."""
    jcfg = jtiny(jget("mamba2-370m")).replace(ssd_chunk=256)
    tcfg = ttiny(tget("mamba2-370m")).replace(ssd_chunk=256)
    jstate, tstate = _state(jcfg)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, jcfg.vocab_size, (2, 256)).astype(np.int32)
             for k in ("tokens", "labels")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jgrads = _jgrads(jcfg)
    jg = flatten(jax.tree.map(np.asarray, jgrads(jstate["params"], jb)))
    assert np.isnan(jg["embed.table"]).any()
    g256, _ = steps.loss_and_grads(tcfg, tstate["params"], tb)
    g64, _ = steps.loss_and_grads(tcfg.replace(ssd_chunk=64),
                                  tstate["params"], tb)
    for k, v in flatten(g256).items():
        assert bool(torch.isfinite(v).all()), k
        assert _rel(v, flatten(g64)[k].numpy()) <= 1e-4, k
    jstate["params"]["seg0"]["sub0"]["mamba"]["dt_bias"] = np.full_like(
        jstate["params"]["seg0"]["sub0"]["mamba"]["dt_bias"], -3.0)
    tstate = unflatten(params_from_reference(jstate))
    jg = flatten(jax.tree.map(np.asarray, jgrads(jstate["params"], jb)))
    tg, _ = steps.loss_and_grads(tcfg, tstate["params"], tb)
    for k, v in flatten(tg).items():
        assert np.isfinite(jg[k]).all(), k
        assert _rel(v, jg[k]) <= FP32, k


@pytest.mark.parametrize("name", ["mamba2-370m", "qwen2-0.5b"])
def test_bf16_train_step_matches_reference_loosely(name):
    """bf16 compute over fp32 masters: every leaf cast once, as the
    reference's loss does; the loss and the grad norm within 3e-2."""
    jcfg = jtiny(jget(name)).replace(dtype="bfloat16")
    tcfg = ttiny(tget(name)).replace(dtype="bfloat16")
    jstate, tstate = _state(jcfg)
    batch = _batch(jcfg)
    _, jm = jax.jit(jsteps.make_train_step(jcfg, **KW))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = steps.make_train_step(tcfg, **KW)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(tm["loss"], jm["loss"]) <= BF16
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= BF16


@pytest.mark.parametrize("name", ["mamba2-370m", "qwen2-0.5b",
                                  "whisper-base"])
def test_remat_gradients_equal_plain_gradients_bitwise(name):
    """Rematerializing each layer recomputes the same values in the same
    order: every gradient leaf bitwise equal with and without it."""
    tcfg = ttiny(tget(name))
    assert tcfg.remat == "none"
    jcfg = jtiny(jget(name))
    _, tstate = _state(jcfg)
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    plain, pm = steps.loss_and_grads(tcfg, tstate["params"], tb)
    full, fm = steps.loss_and_grads(tcfg.replace(remat="full"),
                                    tstate["params"], tb)
    assert torch.equal(pm["loss"], fm["loss"])
    for k, v in flatten(plain).items():
        assert torch.equal(flatten(full)[k], v), k


def test_remat_stays_off_the_serving_paths():
    cfg = ttiny(tget("mamba2-370m")).replace(remat="full")

    def fn(x):
        return x
    assert lm.remat(fn, cfg, "prefill") is fn
    assert lm.remat(fn, cfg, "decode") is fn
    with torch.no_grad():
        assert lm.remat(fn, cfg, "train") is fn
    assert lm.remat(fn, cfg.replace(remat="none"), "train") is fn
    assert lm.remat(fn, cfg, "train") is not fn


# ----------------------------------------------------------------------
# causal_conv1d's gradient


@pytest.mark.parametrize("L", [2, 37])
@pytest.mark.parametrize("bias", [True, False])
def test_conv_function_backward_matches_autograd_and_reference(L, bias):
    """The Function's backward (one ``causal_conv1d_bwd`` call: dx, dw
    and db in one pass; ``ref.causal_conv1d_bwd`` stands in for the
    kernel on the CPU) on the strided xBC view of a wider buffer, at L =
    2 < K - 1 too, against autograd of the plain version and
    ``jax.grad`` of the reference's ``ref.causal_conv1d``."""
    rng = np.random.default_rng(L + bias)
    K, C, W, off = 4, 12, 20, 5
    buf = rng.standard_normal((2, L, W)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32) if bias else None
    dy = rng.standard_normal((2, L, C)).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_() if bias else None
    wrt = (tw, tb) if bias else (tw,)
    grads = {}
    for name, fn in (("function", cc.CausalConv1d.apply),
                     ("plain", ref.causal_conv1d)):
        tbuf = torch.from_numpy(buf).requires_grad_()
        x = tbuf[..., off:off + C]
        assert x.stride() == (L * W, W, 1)
        y = fn(x, tw, tb)
        grads[name] = torch.autograd.grad(y, (x, *wrt), torch.from_numpy(dy))

    def jf(x, w, *bb):
        return jnp.vdot(jref.causal_conv1d(x, w, *bb), jnp.asarray(dy))
    args = (jnp.asarray(buf[..., off:off + C]), jnp.asarray(w)) + (
        (jnp.asarray(b),) if bias else ())
    want = jax.grad(jf, argnums=tuple(range(len(args))))(*args)
    for got, plain, jg in zip(grads["function"], grads["plain"], want):
        assert _rel(got, plain.numpy()) <= FP32
        assert _rel(got, np.asarray(jg)) <= FP32


def test_conv_function_off_when_nothing_needs_grad():
    """The wrapper on a CPU tensor is the plain version, which autograd
    differentiates; neither launch counter moves on the CPU."""
    before = (cc.causal_conv1d.launches, cc.causal_conv1d_bwd.launches)
    x = torch.randn(1, 5, 4, requires_grad=True)
    y = cc.causal_conv1d(x, torch.randn(3, 4))
    assert y.grad_fn is not None and not isinstance(
        y.grad_fn, cc.CausalConv1d._backward_cls)
    y.sum().backward()
    assert (cc.causal_conv1d.launches,
            cc.causal_conv1d_bwd.launches) == before


# ----------------------------------------------------------------------
# the reference's end-to-end training tests, ported


def test_lm_loss_decreases():
    cfg = ttiny(tget("qwen2-0.5b")).replace(vocab_size=64)
    state = steps.init_state(cfg, 0, "cpu")
    ts = steps.make_train_step(cfg, peak_lr=3e-3, warmup=5, total_steps=60)
    pipe = TokenPipeline(16, 16, 8, seed=0)  # tiny vocab -> learnable
    losses = []
    for step in range(25):
        state, m = ts(state, pipe.batch(step, "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_crash_resume_bitwise(tmp_path):
    cfg = ttiny(tget("granite-3-2b")).replace(vocab_size=128, num_layers=2)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=5)
    ts = steps.make_train_step(cfg, peak_lr=1e-3, warmup=2, total_steps=40)

    def run(tmp, injector=None, max_failures=0):
        ckpt = CheckpointManager(tmp, async_save=False)
        state, _, fails = resilient_train(
            state=steps.init_state(cfg, 1, "cpu"), train_step=ts,
            pipeline=pipe, ckpt=ckpt, total_steps=12, ckpt_every=4,
            max_failures=max_failures, fail_injector=injector)
        return state, fails

    ref_state, _ = run(tmp_path / "ref")
    hits = {9: True}

    def injector(step):
        if hits.pop(step, None):
            raise TransientFailure("chaos-monkey")

    ft_state, fails = run(tmp_path / "ft", injector, max_failures=2)
    assert fails == 1
    for k, v in flatten(ref_state).items():
        assert torch.equal(flatten(ft_state)[k], v), k


# ----------------------------------------------------------------------
# the driver, and what serving draws


def test_cli_trains_on_the_cpu_then_resumes(tmp_path, capsys, monkeypatch):
    argv = ["--arch", "mamba2-370m", "--tiny", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    run = train.main(argv + ["--steps", "6"])
    assert (run.step, run.restarts) == (6, 0)
    assert sorted(run.metrics) == list(range(6))
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    again = train.main(argv + ["--steps", "8"])
    assert again.step == 8 and sorted(again.metrics) == [6, 7]
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done: step=8" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-370m", "--tiny", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "card")])


def test_warmup_rule_is_the_references():
    assert [train.warmup_steps(n) for n in (1, 20, 200, 5000)] \
        == [min(100, n // 10 + 1) for n in (1, 20, 200, 5000)]


@pytest.mark.parametrize("name", ["mamba2-370m", "deepseek-v2-236b"])
def test_serving_draw_has_no_optimizer_state(name):
    """``init_params`` draws the weights alone, the same as the params of
    ``init_state`` (a leaf is seeded by its path in its own tree)."""
    cfg = ttiny(tget(name))
    params = flatten(steps.init_params(cfg, 3, "cpu"))
    state = steps.init_state(cfg, 3, "cpu")
    assert set(params) == set(flatten(registry.model_specs(cfg)))
    assert set(state) == {"params", "opt"}
    for k, v in flatten(state["params"]).items():
        assert torch.equal(params[k], v), k
