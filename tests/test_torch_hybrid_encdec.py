"""The port's hybrid plan, encoder-decoder and frontends on the CPU against
the JAX package: tiny jamba-1.5-large-398b (one interleave period of 8
layers: Mamba with dense and MoE ffns, one GQA layer) and a two-period
tiny jamba (16 layers: one stacked segment whose caches hold Mamba
``conv``/``state`` and GQA ``k``/``v`` side by side) in train, prefill and
decode with their ``aux``, and ``generate`` step by step; tiny
whisper-base's ``encode``, ``cross_kv`` and ``forward`` in its three
modes; tiny internvl2-26b with patch embeddings before its tokens;
``conv1d_dense``, the audio stem and the ViT patch embed; the configs,
parameter counts, plans, segments and cache structs, full and tiny;
``StepGraphs``'s prefill key over ``frames`` and ``prefix_embeds``.

Inputs and weights are numpy-seeded (the weights at the reference's init
scales, from its spec tree, the constant leaves perturbed so a missing
norm or bias shows) and carried across with ``repro_torch.convert``; the
reference's side is jitted. Bound: max|y - ref| / max|ref| <=
tolerance(dtype): 2e-5 in fp32, 3e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import encdec as jencdec
from repro.models import frontends as jfrontends
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import encdec, frontends, lm, registry
from repro_torch.models import layers as L
from repro_torch.models.spec import (ParamSpec, flatten, init_leaf,
                                     unflatten)

JAMBA, WHISPER, VLM = "jamba-1.5-large-398b", "whisper-base", "internvl2-26b"
PROMPT, NEW = 13, 4
DTYPES = ("float32", "bfloat16")


def _rel(y, r):
    y = y.float().numpy() if isinstance(y, torch.Tensor) else \
        np.asarray(y, dtype=np.float32)
    r = np.asarray(jnp.asarray(r, jnp.float32))
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _vocab(logits, cfg):
    return logits[..., :cfg.vocab_size]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a, dtype):
    """A numpy array as the same values in both packages, in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _draw(specs, seed):
    """A spec tree's weights drawn with numpy, scaled as ``init_params``
    scales them; the constant leaves (norm scales, biases, the SSM's
    decay and time-step bias) perturbed so a missing one shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, sp in _leaves(specs):
        z = rng.standard_normal(sp.shape).astype(np.float32)
        if sp.init == "ones":
            a = 1 + 0.1 * z
        elif sp.init == "zeros":
            a = 0.1 * z
        elif sp.init == "embed":
            a = 0.02 * z
        else:
            fan = int(np.prod(sp.shape[:-1])) if len(sp.shape) > 1 \
                else sp.shape[0]
            a = z * (sp.scale if sp.scale is not None else fan ** -0.5)
        out[key] = a.astype(np.float32)
    return unflatten(out)


def _model(jcfg, tcfg, seed):
    """(reference cfg, port cfg, reference params (jnp), port params)."""
    jp = _draw(jregistry.model_specs(jcfg), seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, jp),
            unflatten(params_from_reference(jp)))


@pytest.fixture(scope="module")
def models():
    """Tiny jamba (one period and two), tiny whisper, tiny internvl2."""
    jj, tj = jtiny(jget(JAMBA)), ttiny(tget(JAMBA))
    return {"jamba": _model(jj, tj, 300),
            "jamba2": _model(jj.replace(num_layers=16),
                             tj.replace(num_layers=16), 301),
            "whisper": _model(jtiny(jget(WHISPER)), ttiny(tget(WHISPER)),
                              302),
            "vlm": _model(jtiny(jget(VLM)), ttiny(tget(VLM)), 303)}


def _with_dtype(model, dtype):
    jcfg, tcfg, jp, tp = model
    return jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype), jp, tp


def _prompts(cfg, seed=0, S=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)


def _assert_trees_close(ttree, jtree, tol):
    jflat = dict(_leaves(jax.tree.map(np.asarray, jtree)))
    tflat = dict(_leaves(ttree))
    assert set(tflat) == set(jflat)
    for key, r in jflat.items():
        assert _rel(tflat[key], r) <= tol, key


def _clear_top1(logits, cfg, tol):
    """Per row, whether the reference's top-1 logit leads its top-2 by
    more than ``tol * max|logits|`` (else a port within ``tol`` may
    rightly pick the other token)."""
    a = np.asarray(jnp.asarray(_vocab(logits, cfg), jnp.float32))[:, -1]
    top2 = np.sort(a, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > tol * np.abs(a).max()


# ----------------------------------------------------------------------
# the hybrid plan


@pytest.mark.parametrize("which", ["jamba", "jamba2"])
def test_jamba_train_prefill_decode_match_reference(models, which):
    """Logits, the MoE layers' summed aux and every cache leaf (Mamba
    conv/state beside GQA K/V, stacked along the layer axis in the
    two-period model) in train, prefill and decode, fp32. (In bf16 the
    whole model compounds the rounding: the reference's own bf16 logits
    lie 4-15% from its fp32 ones at 8 layers, so bf16 is held layer by
    layer below.)"""
    jcfg, tcfg, jp, tp = models[which]
    tol = tolerance("float32")
    prompts = _prompts(tcfg)
    toks, ttoks = jnp.asarray(prompts), torch.from_numpy(prompts)
    train, _, jaux = jax.jit(lambda p, t: jlm.forward(
        p, jcfg, t, mode="train"))(jp, toks)
    out, caches, aux = lm.forward(tp, tcfg, ttoks, mode="train")
    assert caches is None and float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= tol * float(jaux)
    assert _rel(_vocab(out, tcfg), _vocab(train, tcfg)) <= tol
    cache_len = PROMPT + NEW
    jpre, jc, jaux = jax.jit(lambda p, t: jlm.forward(
        p, jcfg, t, mode="prefill", cache_len=cache_len))(jp, toks)
    tpre, tc, aux = lm.forward(tp, tcfg, ttoks, mode="prefill",
                               cache_len=cache_len)
    assert abs(float(aux) - float(jaux)) <= tol * float(jaux)
    assert _rel(_vocab(tpre, tcfg), _vocab(jpre, tcfg)) <= tol
    _assert_trees_close(tc, jc, tol)
    nxt = np.array([[3], [5]], np.int32)
    jdec, jdc, jaux = jax.jit(lambda p, t, c: jlm.decode_step(
        p, jcfg, t, c, PROMPT))(jp, jnp.asarray(nxt), jc)
    tdec, tdc, aux = lm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                    torch.tensor(PROMPT))
    assert abs(float(aux) - float(jaux)) <= tol * float(jaux)
    assert _rel(_vocab(tdec, tcfg), _vocab(jdec, tcfg)) <= tol
    _assert_trees_close(tdc, jdc, tol)


def _layers(cfg, jp, tp):
    """(plan, reference layer params, port layer params) in depth order."""
    for si, (body, n) in enumerate(lm.segments(cfg)):
        for i in range(n):
            for j, plan in enumerate(body):
                jl, tl = jp[f"seg{si}"][f"sub{j}"], tp[f"seg{si}"][f"sub{j}"]
                if n > 1:
                    jl = jax.tree.map(lambda a, i=i: a[i], jl)
                    tl = lm._index(tl, i)
                yield plan, jl, tl


def _torch(a):
    """A jnp array as a torch tensor of the same dtype and values."""
    dt = str(a.dtype)
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dt))


@pytest.mark.parametrize("which", ["jamba", "jamba2"])
def test_jamba_layers_match_reference_in_bf16(models, which):
    """bf16, layer by layer: each layer (Mamba + dense, Mamba + MoE, GQA
    + dense) fed the reference's input to it, in train, prefill (its
    cache) and one decode step against the reference's prefill cache
    padded by one position; its output, aux and caches within 3e-2 of the
    reference's; then ``ln_f`` and the unembedding on the reference's
    last hidden state."""
    jcfg, tcfg, jp, tp = _with_dtype(models[which], "bfloat16")
    tol = tolerance("bfloat16")
    S = PROMPT
    prompts = _prompts(tcfg)
    pos = np.arange(S)[None].repeat(2, 0)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
    jx = jL.embed(jp["embed"], jcfg, jnp.asarray(prompts))
    jxn = jL.embed(jp["embed"], jcfg, jnp.asarray([[3], [5]], jnp.int32))
    fns = {}

    def ref(plan, mode):
        if (plan, mode) not in fns:
            fns[plan, mode] = jax.jit(
                lambda p, x, q, c: jlm.apply_block(
                    p, jcfg, plan, x, q, mode=mode, cache=c, pos=S))
        return fns[plan, mode]
    for layer, (plan, jl, tl) in enumerate(_layers(tcfg, jp, tp)):
        tl = unflatten({k: _torch(v) for k, v in flatten(jl).items()})
        tx = _torch(jx)
        outs = {}
        for mode in ("train", "prefill"):
            jy, jc, ja = ref(plan, mode)(jl, jx, jpos, None)
            ty, tc, ta = lm.apply_block(tl, tcfg, plan, tx, tpos, mode=mode,
                                        cache=None, pos=0)
            assert ty.dtype == torch.bfloat16
            assert _rel(ty, jy) <= tol, (layer, plan, mode)
            assert abs(float(ta) - float(ja)) <= tol * max(float(ja), 1e-9)
            outs[mode] = jy, jc
        _assert_trees_close(tc, jc, tol)
        jc = jlm._pad_cache_seq(jcfg, plan, outs["prefill"][1], S + 1)
        tc = {k: _torch(v) for k, v in jc.items()}
        jd, jdc, _ = ref(plan, "decode")(jl, jxn, jpos[:, :1], jc)
        td, tdc, _ = lm.apply_block(tl, tcfg, plan, _torch(jxn),
                                    tpos[:, :1], mode="decode", cache=tc,
                                    pos=torch.tensor(S))
        assert _rel(td, jd) <= tol, (layer, plan, "decode")
        _assert_trees_close(tdc, jdc, tol)
        jx, jxn = outs["train"][0], jd
    jh = jL.unembed(jp["embed"], jcfg, jL.apply_norm(jp["ln_f"], jx,
                                                     jcfg.norm_eps))
    th = L.unembed(tp["embed"], tcfg, L.apply_norm(tp["ln_f"], _torch(jx),
                                                   tcfg.norm_eps))
    assert _rel(_vocab(th, tcfg), _vocab(jh, tcfg)) <= tol


@pytest.mark.parametrize("which", ["jamba", "jamba2"])
def test_jamba_prefill_then_decode_matches_train_logits(models, which):
    """Inside the port, at capacity factor 8 (no drops): the prefill and
    the cached decode steps give the train logits at every position."""
    _, tcfg, _, tp = models[which]
    tcfg = tcfg.replace(capacity_factor=8.0)
    seq = torch.from_numpy(_prompts(tcfg, seed=8, S=PROMPT + NEW))
    train, _, _ = lm.forward(tp, tcfg, seq, mode="train")
    logits, caches = steps.prefill_step(tp, tcfg, seq[:, :PROMPT],
                                        cache_len=PROMPT + NEW)
    tol = tolerance("float32")
    assert _rel(logits[:, 0], train[:, PROMPT - 1].numpy()) <= tol
    for i in range(NEW - 1):
        logits, caches = steps.decode_step(
            tp, tcfg, seq[:, PROMPT + i:PROMPT + i + 1], caches, PROMPT + i)
        assert _rel(_vocab(logits[:, 0], tcfg),
                    _vocab(train[:, PROMPT + i], tcfg).numpy()) <= tol, i


@pytest.mark.parametrize("which", ["jamba", "jamba2"])
def test_jamba_generate_matches_reference_step_by_step(models, which):
    """fp32 (bf16 is held layer by layer above): each step's logits
    teacher-forced on the reference's tokens, and greedy ``generate``
    against the reference's while the reference's top-1 leads its top-2
    by more than the tolerance; at least the first token is compared."""
    jcfg, tcfg, jp, tp = models[which]
    tol = tolerance("float32")
    prompts = _prompts(tcfg, seed=1)
    toks = jnp.asarray(prompts)
    cache_len = PROMPT + NEW
    jtokens = np.asarray(jserve.generate(jcfg, jp, toks, max_new=NEW,
                                         cache_len=cache_len))
    ttokens = serve.generate(tcfg, tp, torch.from_numpy(prompts),
                             max_new=NEW, cache_len=cache_len).numpy()
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=cache_len))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jlog, jc = jpre(jp, {"tokens": toks})
    cparams = steps.compute_params(tp, tcfg)
    tlog, tc = steps.prefill_step(cparams, tcfg, torch.from_numpy(prompts),
                                  cache_len=cache_len)
    assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol
    clear = [_clear_top1(jlog, tcfg, tol)]
    for i in range(NEW - 1):
        tok = np.array(jtokens[:, i:i + 1])
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, PROMPT + i)
        tlog, tc = steps.decode_step(cparams, tcfg, torch.from_numpy(tok),
                                     tc, PROMPT + i)
        assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol, i
        clear.append(_clear_top1(jlog, tcfg, tol))
    for row in range(2):
        n = 0
        while n < NEW and clear[n][row]:
            n += 1
        np.testing.assert_array_equal(ttokens[row, :n], jtokens[row, :n])
        assert n >= 1, row


def test_jamba_stacked_mixed_caches_round_trip(models):
    """The two-period model: one segment of 2 stacked periods; its caches
    hold Mamba conv/state and GQA k/v side by side, and ``_index`` /
    ``_stack`` take them apart by layer and put them back unchanged."""
    _, tcfg, _, tp = models["jamba2"]
    body, n = lm.segments(tcfg)[0]
    assert n == 2 and len(lm.segments(tcfg)) == 1 and len(body) == 8
    _, caches = steps.prefill_step(tp, tcfg, torch.from_numpy(
        _prompts(tcfg)), cache_len=PROMPT + 2)
    seg = caches["seg0"]
    kinds = {j: set(seg[f"sub{j}"]) for j in range(8)}
    assert kinds[tcfg.attn_layer_offset] == {"k", "v"}
    assert all(kinds[j] == {"conv", "state"} for j in range(8)
               if j != tcfg.attn_layer_offset)
    struct = lm.cache_struct(tcfg, 2, PROMPT + 2)["seg0"]
    for key, a in flatten(seg).items():
        sub, leaf = key.split(".")
        assert tuple(a.shape) == struct[sub][leaf][0], key
    back = lm._stack([lm._index(seg, i) for i in range(n)])
    assert flatten(back).keys() == flatten(seg).keys()
    for key, a in flatten(seg).items():
        assert torch.equal(flatten(back)[key], a), key


def test_hybrid_and_unknown_plans(models):
    """Mamba with a dense or MoE ffn builds; an unknown mixer, ffn or
    family still raises."""
    tcfg = models["jamba"][1]
    for plan in (("mamba", "dense"), ("mamba", "moe"), ("mamba", "none")):
        assert "mamba" in lm.block_specs(tcfg, plan)
    with pytest.raises(ValueError, match="unknown mixer"):
        lm.block_specs(tcfg, ("rwkv", "dense"))
    with pytest.raises(ValueError, match="unknown ffn"):
        lm.block_specs(tcfg, ("mamba", "glu"))
    with pytest.raises(ValueError, match="unknown family"):
        ttiny(tcfg.replace(family="diffusion"))


# ----------------------------------------------------------------------
# the encoder-decoder


def _frames(cfg, seed=5, B=2):
    return _normal(seed, (B, cfg.encoder_seq, cfg.d_model))


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_encode_and_cross_kv_match_reference(models, dtype):
    """The encoder (frames and positions cast to the compute dtype, then
    added) and every decoder layer's cross K and V (``wk``/``wv`` alone)."""
    jcfg, tcfg, jp, tp = _with_dtype(models["whisper"], dtype)
    jf, tf = _pair(_frames(tcfg), "float32")
    jenc = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, jf)
    tenc = encdec.encode(tp, tcfg, tf)
    assert tenc.dtype == getattr(torch, dtype)
    assert _rel(tenc, jenc) <= tolerance(dtype)
    jkv = jax.jit(lambda p, e: jencdec.cross_kv(p, jcfg, e))(jp, jenc)
    tkv = encdec.cross_kv(tp, tcfg, tenc)
    assert tuple(tkv["xk"].shape) == (tcfg.num_layers, 2, tcfg.encoder_seq,
                                      tcfg.num_kv_heads, tcfg.head_dim)
    _assert_trees_close(tkv, jkv, tolerance(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_whisper_forward_matches_reference(models, dtype):
    """Train, prefill (the self K and V padded to ``cache_len``, the cross
    K and V) and decode (``cross`` passed through unchanged)."""
    jcfg, tcfg, jp, tp = _with_dtype(models["whisper"], dtype)
    tol = tolerance(dtype)
    prompts = _prompts(tcfg)
    toks, ttoks = jnp.asarray(prompts), torch.from_numpy(prompts)
    jf, tf = _pair(_frames(tcfg), "float32")
    train, _, _ = jax.jit(lambda p, t, f: jencdec.forward(
        p, jcfg, t, f, mode="train"))(jp, toks, jf)
    out, caches, aux = encdec.forward(tp, tcfg, ttoks, tf, mode="train")
    assert caches is None and float(aux) == 0.0
    assert _rel(_vocab(out, tcfg), _vocab(train, tcfg)) <= tol
    assert bool((out[..., tcfg.vocab_size:]
                 == torch.finfo(out.dtype).min).all())
    cache_len = PROMPT + NEW
    jpre, jc, _ = jax.jit(lambda p, t, f: jencdec.forward(
        p, jcfg, t, f, mode="prefill", cache_len=cache_len))(jp, toks, jf)
    tpre, tc, _ = encdec.forward(tp, tcfg, ttoks, tf, mode="prefill",
                                 cache_len=cache_len)
    assert _rel(_vocab(tpre, tcfg), _vocab(jpre, tcfg)) <= tol
    assert tuple(tc["self"]["k"].shape) == (
        tcfg.num_layers, 2, cache_len, tcfg.num_kv_heads, tcfg.head_dim)
    assert not tc["self"]["k"][:, :, PROMPT:].any()
    _assert_trees_close(tc, jc, tol)
    nxt = np.array([[3], [5]], np.int32)
    jdec, jdc, _ = jax.jit(lambda p, t, c: jencdec.forward(
        p, jcfg, t, None, mode="decode", caches=c, pos=PROMPT))(
        jp, jnp.asarray(nxt), jc)
    tdec, tdc, _ = encdec.forward(tp, tcfg, torch.from_numpy(nxt), None,
                                  mode="decode", caches=tc,
                                  pos=torch.tensor(PROMPT))
    assert _rel(_vocab(tdec, tcfg), _vocab(jdec, tcfg)) <= tol
    assert tdc["cross"] is tc["cross"]
    _assert_trees_close(tdc, jdc, tol)


def test_whisper_prefill_then_decode_matches_train_logits(models):
    """Inside the port: the prefill and the cached decode steps (through
    ``steps``, with frames at the prefill only) give the train logits."""
    _, tcfg, _, tp = models["whisper"]
    seq = torch.from_numpy(_prompts(tcfg, seed=8, S=PROMPT + NEW))
    frames = torch.from_numpy(_frames(tcfg))
    train, _, _ = encdec.forward(tp, tcfg, seq, frames, mode="train")
    logits, caches = steps.prefill_step(tp, tcfg, seq[:, :PROMPT],
                                        cache_len=PROMPT + NEW,
                                        frames=frames)
    tol = tolerance("float32")
    assert _rel(logits[:, 0], train[:, PROMPT - 1].numpy()) <= tol
    for i in range(NEW - 1):
        logits, caches = steps.decode_step(
            tp, tcfg, seq[:, PROMPT + i:PROMPT + i + 1], caches, PROMPT + i)
        assert _rel(_vocab(logits[:, 0], tcfg),
                    _vocab(train[:, PROMPT + i], tcfg).numpy()) <= tol, i


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["whisper", "vlm"])
def test_steps_match_the_references_steps(models, name, dtype):
    """``steps.prefill_step`` with ``frames`` (whisper) or
    ``prefix_embeds`` (internvl2, the reference's ``patch_embeds``) and
    ``decode_step`` against the reference's step builders, on the
    weights ``compute_params`` casts once."""
    jcfg, tcfg, jp, tp = _with_dtype(models[name], dtype)
    tol = tolerance(dtype)
    prompts = _prompts(tcfg)
    if name == "whisper":
        extra = _frames(tcfg)
        jkey, tkey, start = "frames", "frames", PROMPT
    else:
        extra = _normal(6, (2, tcfg.frontend_tokens, tcfg.d_model), 0.1)
        jkey, tkey = "patch_embeds", "prefix_embeds"
        start = PROMPT + tcfg.frontend_tokens
    jx, tx = _pair(extra, dtype)
    cache_len = start + NEW
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=cache_len))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jlog, jc = jpre(jp, {"tokens": jnp.asarray(prompts), jkey: jx})
    cparams = steps.compute_params(tp, tcfg)
    tlog, tc = steps.prefill_step(cparams, tcfg, torch.from_numpy(prompts),
                                  cache_len=cache_len, **{tkey: tx})
    assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol
    _assert_trees_close(tc, jc, tol)
    for i in range(NEW - 1):
        tok = np.array([[3 + i], [7 + i]], np.int32)
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, start + i)
        tlog, tc = steps.decode_step(cparams, tcfg, torch.from_numpy(tok),
                                     tc, start + i)
        assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol, i
    _assert_trees_close(tc, jc, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_prefix_embeds_match_reference(models, dtype):
    """internvl2's backbone with patch embeddings before the tokens in
    train and prefill, then a decode step at position S + frontend
    tokens."""
    jcfg, tcfg, jp, tp = _with_dtype(models["vlm"], dtype)
    tol = tolerance(dtype)
    prompts = _prompts(tcfg)
    toks, ttoks = jnp.asarray(prompts), torch.from_numpy(prompts)
    P = tcfg.frontend_tokens
    assert P == 8
    jx, tx = _pair(_normal(7, (2, P, tcfg.d_model), 0.1), "float32")
    train, _, _ = jax.jit(lambda p, t, x: jlm.forward(
        p, jcfg, t, mode="train", prefix_embeds=x))(jp, toks, jx)
    out, _, _ = lm.forward(tp, tcfg, ttoks, mode="train", prefix_embeds=tx)
    assert tuple(out.shape[:2]) == (2, P + PROMPT)
    assert _rel(_vocab(out, tcfg), _vocab(train, tcfg)) <= tol
    cache_len = P + PROMPT + 1
    jpre, jc, _ = jax.jit(lambda p, t, x: jlm.forward(
        p, jcfg, t, mode="prefill", prefix_embeds=x,
        cache_len=cache_len))(jp, toks, jx)
    tpre, tc, _ = lm.forward(tp, tcfg, ttoks, mode="prefill",
                             prefix_embeds=tx, cache_len=cache_len)
    assert _rel(_vocab(tpre, tcfg), _vocab(jpre, tcfg)) <= tol
    nxt = np.array([[3], [5]], np.int32)
    jdec, _, _ = jax.jit(lambda p, t, c: jlm.decode_step(
        p, jcfg, t, c, PROMPT + P))(jp, jnp.asarray(nxt), jc)
    tdec, _, _ = lm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                PROMPT + P)
    assert _rel(_vocab(tdec, tcfg), _vocab(jdec, tcfg)) <= tol


def test_encdec_module_holds_the_reference_paths(models):
    """``EncDec``'s ``state_dict()`` keys are the reference's parameter
    paths with their stacked shapes, and calling it is ``forward``;
    ``params_from_reference`` carries the tree (``enc`` and ``dec``
    stacked, ``enc_pos``, ``embed.pos``) unchanged."""
    jcfg, tcfg, jp, tp = models["whisper"]
    flat = params_from_reference(jax.tree.map(np.asarray, jp))
    net = encdec.EncDec(tcfg, flat)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    sd = net.state_dict()
    assert set(sd) == set(jflat) >= {"enc_pos", "embed.pos", "embed.table",
                                     "enc.attn.wq", "dec.xattn.wk"}
    for key, a in jflat.items():
        assert tuple(sd[key].shape) == a.shape
        assert np.array_equal(sd[key].numpy(), a), key
    assert sd["dec.attn.wq"].shape[0] == tcfg.num_layers
    toks = torch.from_numpy(_prompts(tcfg))
    frames = torch.from_numpy(_frames(tcfg))
    with torch.no_grad():
        a, _, _ = net(toks, frames=frames)
    b, _, _ = encdec.forward(tp, tcfg, toks, frames)
    assert torch.equal(a, b)


def test_compute_params_keeps_the_layer_norms_stored(models):
    """``steps.compute_params`` on whisper: the token and position tables
    (``embed.pos``, ``enc_pos``) and every matrix are cast to the compute
    dtype once; the LayerNorms' ``w`` and ``b`` stay as stored; the model
    computes the same values from either tree."""
    _, tcfg, _, tp = models["whisper"]
    bcfg = tcfg.replace(dtype="bfloat16")
    cast = steps.compute_params(tp, bcfg)
    assert cast["embed"]["pos"].dtype == cast["enc_pos"].dtype \
        == cast["dec"]["xattn"]["wk"].dtype == cast["enc"]["ffn"]["b1"].dtype \
        == torch.bfloat16
    assert cast["dec"]["lnx"]["b"].dtype == cast["enc_ln"]["w"].dtype \
        == torch.float32
    toks = torch.from_numpy(_prompts(tcfg))
    frames = torch.from_numpy(_frames(tcfg))
    a, _, _ = encdec.forward(tp, bcfg, toks, frames)
    b, _, _ = encdec.forward(cast, bcfg, toks, frames)
    assert torch.equal(a, b)


# ----------------------------------------------------------------------
# conv1d_dense and the frontends


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("length", [10, 11])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_dense_matches_reference(stride, length, bias):
    """SAME padding split as XLA splits it (at stride 2 and an even
    length the single pad goes at the end)."""
    x = _normal(10, (2, length, 6))
    w = _normal(11, (3, 6, 5), 0.3)
    b = _normal(12, (5,)) if bias else None
    ref = jref.conv1d_dense(jnp.asarray(x), jnp.asarray(w),
                            None if b is None else jnp.asarray(b),
                            stride=stride)
    out = ops.conv1d_dense(torch.from_numpy(x), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b),
                           stride=stride)
    assert tuple(out.shape) == (2, -(-length // stride), 5)
    assert _rel(out, ref) <= tolerance("float32")


@pytest.mark.parametrize("length", [32, 33])
def test_audio_stem_matches_reference(models, length):
    """Two k=3 convs (stride 1, then 2), each followed by the tanh GELU."""
    jcfg, tcfg = models["whisper"][:2]
    jp = _draw(jfrontends.audio_stem_specs(jcfg, n_mels=16), 20)
    mel = _normal(21, (1, length, 16))
    ref = jfrontends.audio_stem(jax.tree.map(jnp.asarray, jp), jcfg,
                                jnp.asarray(mel))
    out = frontends.audio_stem(unflatten(params_from_reference(jp)), tcfg,
                               torch.from_numpy(mel))
    assert tuple(out.shape) == (1, -(-length // 2), tcfg.d_model)
    assert _rel(out, ref) <= tolerance("float32")


def test_vit_patch_embed_matches_reference(models):
    """Patch 7 on a 28 x 28 image: 16 patches through the conv's patch
    route (a reshape and one product), plus the bias."""
    jcfg, tcfg = models["vlm"][:2]
    jp = _draw(jfrontends.vit_patch_specs(jcfg, patch=7), 22)
    img = _normal(23, (1, 28, 28, 3))
    ref = jfrontends.vit_patch_embed(jax.tree.map(jnp.asarray, jp), jcfg,
                                     jnp.asarray(img), patch=7)
    out = frontends.vit_patch_embed(unflatten(params_from_reference(jp)),
                                    tcfg, torch.from_numpy(img), patch=7)
    assert tuple(out.shape) == (1, 16, tcfg.d_model)
    assert _rel(out, ref) <= tolerance("float32")


# ----------------------------------------------------------------------
# configs, parameters, plans, caches


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", [JAMBA, WHISPER, VLM])
def test_config_fields_and_param_count_match_reference(name, tiny):
    """Every field of the port's config, the parameter count (total and
    active) and the spec tree (shapes, axes, init, scale)."""
    jcfg, tcfg = jget(name), tget(name)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert registry.count_params(tcfg) == jregistry.count_params(jcfg)
    assert registry.count_params(tcfg, active_only=True) \
        == jregistry.count_params(jcfg, active_only=True)
    specs = dict(_leaves(registry.model_specs(tcfg)))
    jspecs = dict(_leaves(jregistry.model_specs(jcfg)))
    assert {k: (s.shape, s.axes, s.init, s.scale)
            for k, s in specs.items()} == {
        k: (s.shape, s.axes, s.init, s.scale) for k, s in jspecs.items()}


def test_published_parameter_counts():
    jamba = tget(JAMBA)
    assert jamba.num_params() == 398_042_458_752
    assert jamba.active_params() == 93_636_651_648
    assert tget(WHISPER).num_params() == 88_387_584
    assert tget(VLM).num_params() == 19_862_722_560


@pytest.mark.parametrize("layers", [None, 16, 5])
@pytest.mark.parametrize("tiny", [False, True])
def test_jamba_plans_and_segments_match_reference(tiny, layers):
    """The layer plan and segments, full (one 8-layer period repeated 9
    times), tiny (one period), cut to 16 layers (two) or 5 (the chip's
    cut: four Mamba layers, then the attention layer at offset 4)."""
    jcfg, tcfg = jget(JAMBA), tget(JAMBA)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    if layers:
        jcfg, tcfg = (c.replace(num_layers=layers) for c in (jcfg, tcfg))
    assert lm.layer_plan(tcfg) == jlm.layer_plan(jcfg)
    assert lm.segments(tcfg) == jlm.segments(jcfg)
    period = [("mamba", "dense"), ("mamba", "moe")] * 2
    period[4:] = [("gqa", "dense"), ("mamba", "moe"), ("mamba", "dense"),
                  ("mamba", "moe")]
    n = tcfg.num_layers
    if n % 8 == 0:
        assert lm.segments(tcfg) == [(tuple(period), n // 8)]
    else:
        assert lm.layer_plan(tcfg) == period[:n]


def _struct(tree):
    return {k: (tuple(v[0]), str(v[1]).split(".")[-1], tuple(v[2]))
            for k, v in tree.items()}


def _flat_struct(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_struct(v, path + (k,)))
        else:
            out[".".join(path + (k,))] = v
    return out


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", [JAMBA, WHISPER, VLM])
def test_cache_structs_match_reference(name, tiny):
    """The decode cache's leaves (shape, dtype, axes), full and tiny."""
    jcfg, tcfg = jget(name), tget(name)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    t = _struct(_flat_struct(registry.cache_struct(tcfg, 3, 40)))
    j = _struct(_flat_struct(jregistry.cache_struct(jcfg, 3, 40)))
    assert t == j and t


def test_init_leaf_pieces_are_one_draw(monkeypatch):
    """``init_leaf`` draws a large leaf in pieces that are its one draw:
    the same values as ``torch.randn`` of the whole shape times its
    scale; a leaf whose size is not a multiple of 16 is drawn whole."""
    from repro_torch.models import spec
    monkeypatch.setattr(spec, "_PIECE", 64)
    for shape in ((3, 7, 16), (200, 3), (5, 41)):
        sp = ParamSpec(shape, (None,) * len(shape))
        leaf = init_leaf(sp, torch.Generator().manual_seed(3), "float32")
        whole = torch.randn(shape, generator=torch.Generator().manual_seed(
            3)) * spec._std(sp)
        assert torch.equal(leaf, whole), shape


# ----------------------------------------------------------------------
# serving entry points


def test_generate_takes_tokens_only():
    """The reference's ``generate`` cannot serve an encoder-decoder, and
    neither does the port's: it names the steps to use."""
    tcfg = ttiny(tget(WHISPER))
    params = steps.init_params(tcfg, 0, "cpu")
    with pytest.raises(ValueError, match="StepGraphs"):
        serve.generate(tcfg, params, torch.zeros((1, 3), dtype=torch.int64),
                       max_new=2, cache_len=5)
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", WHISPER, "--tiny", "--device", "cpu"])


def test_serve_cli_runs_jamba_on_the_cpu(capsys):
    out = serve.main(["--arch", JAMBA, "--tiny", "--batch", "2",
                      "--prompt-len", "5", "--max-new", "3",
                      "--device", "cpu"])
    assert out.shape == (2, 3) and out.dtype == torch.int32
    assert "generated 6 tokens on cpu" in capsys.readouterr().out


class _FakeGraph:
    """On the CPU: ``replay`` reruns the captured function into its
    static logits, as a CUDA graph replays into its static buffers (a
    capture runs nothing, so the fake's capture is the warm-up alone)."""

    def __init__(self, fn, logits):
        self.fn, self.logits = fn, logits

    def replay(self):
        self.logits.copy_(self.fn())


def _cpu_graphs(cfg, params, monkeypatch):
    """A ``StepGraphs`` on the CPU with the capture replaced by
    ``_FakeGraph``: the key and static-input logic, not the card."""
    g = steps.StepGraphs.__new__(steps.StepGraphs)
    g.cfg, g.source, g.device = cfg, params, torch.device("cpu")
    g.params = steps.compute_params(params, cfg)
    g._prefills, g._decodes, g._caches = {}, {}, {}
    g.prefills = g.steps = 0

    def capture(fn):
        logits = fn().clone()
        return _FakeGraph(fn, logits), logits
    monkeypatch.setattr(g, "_capture", capture, raising=False)
    return g


@pytest.mark.parametrize("name", ["whisper", "vlm"])
def test_prefill_graph_key_covers_frames_and_prefix_embeds(models, name,
                                                           monkeypatch):
    """One prefill graph a (tokens, cache_len, and the shape and dtype of
    ``frames`` or ``prefix_embeds``); new values of the same shape are
    copied into its static inputs and replayed; the decode graph reads
    the prefill's static caches, and an encoder-decoder's ``cross`` is
    never rewritten."""
    _, tcfg, _, tp = models[name]
    g = _cpu_graphs(tcfg, tp, monkeypatch)
    key = "frames" if name == "whisper" else "prefix_embeds"
    shape = (2, tcfg.encoder_seq if name == "whisper"
             else tcfg.frontend_tokens, tcfg.d_model)
    toks = torch.from_numpy(_prompts(tcfg))
    start = PROMPT + (0 if name == "whisper" else tcfg.frontend_tokens)
    cache_len = start + 2
    cparams = steps.compute_params(tp, tcfg)
    for seed in (1, 2):
        x = torch.from_numpy(_normal(seed, shape, 0.1))
        logits, caches = g.prefill(toks, cache_len, **{key: x})
        want, _ = steps.prefill_step(cparams, tcfg, toks,
                                     cache_len=cache_len, **{key: x})
        assert torch.equal(logits, want)
    assert len(g._prefills) == 1
    g.prefill(toks, cache_len, **{key: x[:1].expand(shape).to(
        torch.bfloat16)})
    g.prefill(toks, cache_len, **{key: x[:, :shape[1] - 1]})
    assert len(g._prefills) == 3
    logits, caches = g.prefill(toks, cache_len, **{key: x})
    cross = {k: v.clone() for k, v in flatten(caches).items()
             if k.startswith("cross")}
    assert bool(cross) == (name == "whisper")
    _, ecaches = steps.prefill_step(cparams, tcfg, toks,
                                    cache_len=cache_len, **{key: x})
    tok = torch.tensor([[3], [5]])
    out = g.decode(tok, caches, start)
    want, ecaches = steps.decode_step(cparams, tcfg, tok, ecaches, start)
    assert torch.equal(out, want)
    for k, v in flatten(caches).items():
        assert torch.equal(v, flatten(ecaches)[k]), k
        if k in cross:
            assert torch.equal(v, cross[k])
