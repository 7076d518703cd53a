"""The port's GQA attention LMs on the CPU against the JAX package:
``rope``, the attention core (full scores and the online softmax over KV
chunks, at a ragged length over several chunks, causal and not, with the
GQA expansion), the decode-cache write and ``gqa_decode``, the SwiGLU and
GELU ``ffn``; then the tiny variants of the four dense configs
(qwen2-0.5b: tied embeddings, qkv bias, head_dim 64 at full width;
granite-3-2b: tied, no bias; granite-8b and minitron-8b: untied, head_dim
128 at full width) in train, prefill and decode modes, the prefill caches
padded to ``cache_len``, and ``generate`` step by step; plus the configs,
parameter counts, layer plans and cache structs (of the two MoE configs
too, whose layers ``tests/test_torch_mla_moe.py`` holds) and what still
raises.

Inputs are numpy-seeded; the weights are drawn once by the reference,
their constant leaves (norm scales, biases) perturbed so a missing bias
or norm shows, and carried across with ``repro_torch.convert``. Bound:
max|y - ref| / max|ref| <= tolerance(dtype): 2e-5 in fp32, 3e-2 in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.models.spec import init_params as jinit
from repro_torch.configs import ArchConfig
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import lm, registry
from repro_torch.models.spec import unflatten

DENSE = ("qwen2-0.5b", "granite-3-2b", "granite-8b", "minitron-8b")
MOE = ("granite-moe-3b-a800m", "deepseek-v2-236b")
PROMPT, NEW = 21, 4
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


def _pair(a, dtype):
    """A numpy array as the same values in both packages, in ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------------------
# rope, the attention core, the cache write, the ffn


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 64, 128])
def test_rope_matches_reference(D, dtype):
    x = _normal(D, (2, 11, 3, D))
    pos = np.arange(5, 16)[None].repeat(2, 0)
    jx, tx = _pair(x, dtype)
    ref = jL.rope(jx, jnp.asarray(pos, jnp.int32), 1_000_000.0)
    out = L.rope(tx, torch.from_numpy(pos), 1_000_000.0)
    assert out.dtype == tx.dtype
    assert _rel(out, ref) <= tolerance(dtype)


def _qkv(seed, B, Sq, Sk, H, KV, D, dtype):
    q, k, v = (_normal(seed + i, (B, s, h, D))
               for i, (s, h) in enumerate(((Sq, H), (Sk, KV), (Sk, KV))))
    return [_pair(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 64])
def test_attend_full_and_chunked_match_reference(D, causal, dtype):
    """Sk = 37 over chunks of 16: three chunks, the last ragged and padded
    with masked slots; the queries sit at the end of the keys' span."""
    B, Sq, Sk, H = 2, 9, 37, 4
    (jq, tq), (jk, tk), (jv, tv) = _qkv(D, B, Sq, Sk, H, H, D, dtype)
    q_pos = np.arange(Sk - Sq, Sk)[None].repeat(B, 0)
    kv_pos = np.arange(Sk)[None].repeat(B, 0)
    jqp, jkp = jnp.asarray(q_pos, jnp.int32), jnp.asarray(kv_pos, jnp.int32)
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    scale = D ** -0.5
    ref = jL._attend_full(jq, jk, jv, causal=causal, q_pos=jqp, kv_pos=jkp,
                          scale=scale)
    out = L._attend_full(tq, tk, tv, causal=causal, q_pos=tqp, kv_pos=tkp,
                         scale=scale)
    assert out.dtype == tq.dtype
    assert _rel(out, ref) <= tolerance(dtype)
    ref = jL._attend_chunked(jq, jk, jv, causal=causal, q_pos=jqp,
                             kv_pos=jkp, scale=scale, chunk=16)
    chunked = L._attend_chunked(tq, tk, tv, causal=causal, q_pos=tqp,
                                kv_pos=tkp, scale=scale, chunk=16)
    assert chunked.dtype == tq.dtype
    assert _rel(chunked, ref) <= tolerance(dtype)
    if dtype == "float32":  # the two paths compute the same attention
        assert _rel(chunked, out.numpy()) <= tolerance(dtype)


@pytest.mark.parametrize("KV", [1, 2, 4])
def test_attention_expands_kv_heads_as_the_reference(KV):
    B, S, H, D = 2, 13, 4, 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv(KV, B, S, S, H, KV, D, "float32")
    pos = np.arange(S)[None].repeat(B, 0)
    ref = jL.attention(jq, jk, jv, causal=True, q_pos=jnp.asarray(pos),
                       kv_pos=jnp.asarray(pos), chunk=8)
    out = L.attention(tq, tk, tv, causal=True, q_pos=torch.from_numpy(pos),
                      kv_pos=torch.from_numpy(pos), chunk=8)
    assert _rel(out, ref) <= tolerance("float32")


def test_attention_takes_the_chunked_path_above_the_threshold(monkeypatch):
    """Above ``_FULL_THRESH`` (Sq * Sk) the core runs the online softmax,
    as the reference does."""
    calls = []
    monkeypatch.setattr(L, "_FULL_THRESH", 8 * 8)
    monkeypatch.setattr(L, "_attend_chunked",
                        lambda *a, **kw: calls.append(kw["chunk"]))
    (_, tq), (_, tk), (_, tv) = _qkv(0, 1, 9, 9, 2, 1, 16, "float32")
    pos = torch.arange(9)[None]
    L.attention(tq, tk, tv, causal=True, q_pos=pos, kv_pos=pos, chunk=4)
    assert calls == [4]


def test_full_threshold_is_the_references():
    assert L._FULL_THRESH == jL._FULL_THRESH == 2048 * 2048


@pytest.mark.parametrize("as_tensor", [False, True])
def test_masked_cache_write_matches_reference(as_tensor):
    cache = _normal(1, (2, 10, 2, 16))
    new = _normal(2, (2, 1, 2, 16))
    ref = jL._masked_cache_write(jnp.asarray(cache), jnp.asarray(new), 6)
    pos = torch.tensor(6) if as_tensor else 6
    out = L._masked_cache_write(torch.from_numpy(cache),
                                torch.from_numpy(new), pos)
    assert torch.equal(out, torch.from_numpy(np.array(ref)))
    assert torch.equal(out[:, 6], torch.from_numpy(new[:, 0]))


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, port cfg, reference params (numpy), port
    params)} for the tiny dense configs, constant leaves perturbed."""
    out = {}
    for i, name in enumerate(DENSE):
        jcfg, tcfg = jtiny(jget(name)), ttiny(tget(name))
        jp = jax.tree.map(np.asarray, jinit(jregistry.model_specs(jcfg), 0,
                                            jcfg.param_dtype))
        rng = np.random.default_rng(100 + i)
        flat = dict(_leaves(jp))
        for key, a in flat.items():
            if np.ptp(a) == 0:  # ones / zeros init: norms, biases
                flat[key] = (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    np.float32)
        jp = unflatten(flat)
        out[name] = (jcfg, tcfg, jp, unflatten(params_from_reference(jp)))
    return out


def _layer(tree, i=0):
    seg = tree["seg0"]["sub0"]
    return jax.tree.map(lambda a: a[i], seg) if isinstance(
        seg["ln1"]["w"], np.ndarray) else lm._index(seg, i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_gqa_decode_matches_reference(models, as_tensor, dtype):
    jcfg, tcfg, jp, tp = models["qwen2-0.5b"]
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    B, Smax, pos = 2, 12, 7
    x = _normal(3, (B, 1, tcfg.d_model))
    cache = {"k": _normal(4, (B, Smax, tcfg.num_kv_heads, tcfg.head_dim)),
             "v": _normal(5, (B, Smax, tcfg.num_kv_heads, tcfg.head_dim))}
    jx, tx = _pair(x, dtype)
    jc = {k: _pair(v, dtype)[0] for k, v in cache.items()}
    tc = {k: _pair(v, dtype)[1] for k, v in cache.items()}
    ref, jnew = jL.gqa_decode(_layer(jp)["attn"], jcfg, jx, jc, pos)
    tpos = torch.tensor(pos) if as_tensor else pos
    out, tnew = L.gqa_decode(_layer(tp)["attn"], tcfg, tx, tc, tpos)
    assert _rel(out, ref) <= tolerance(dtype)
    for key in ("k", "v"):
        assert _rel(tnew[key], jnew[key]) <= tolerance(dtype), key
        # only slot pos changed
        keep = [s for s in range(Smax) if s != pos]
        assert torch.equal(tnew[key][:, keep], tc[key][:, keep])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "gelu_mlp"])
def test_ffn_matches_reference(models, act, dtype):
    jcfg, tcfg = (c.replace(act=act, dtype=dtype)
                  for c in models["granite-8b"][:2])
    specs = jL.ffn_specs(jcfg)
    rng = np.random.default_rng(7)
    p = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for k, s in specs.items()}
    assert set(p) == set(L.ffn_specs(tcfg)) == (
        {"w1", "w2", "w3"} if act == "swiglu" else {"w1", "b1", "w2", "b2"})
    for k, s in L.ffn_specs(tcfg).items():
        assert s.shape == specs[k].shape, k
    x = _normal(8, (2, 5, tcfg.d_model))
    jx, tx = _pair(x, dtype)
    ref = jL.ffn({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jx)
    out = L.ffn({k: torch.from_numpy(v) for k, v in p.items()}, tcfg, tx)
    assert out.dtype == tx.dtype
    assert _rel(out, ref) <= tolerance(dtype)


# ----------------------------------------------------------------------
# the whole model, per dense config


def _prompts(cfg, seed=0, S=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_lm_train_prefill_decode_match_reference(models, name, dtype):
    jcfg, tcfg, jp, tp = models[name]
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    tol = tolerance(dtype)
    prompts = _prompts(tcfg)
    toks, ttoks = jnp.asarray(prompts), torch.from_numpy(prompts)
    train, _, _ = jlm.forward(jp, jcfg, toks, mode="train")
    out, caches, aux = lm.forward(tp, tcfg, ttoks, mode="train")
    assert caches is None and float(aux) == 0.0
    assert _rel(_vocab(out, tcfg), _vocab(train, tcfg)) <= tol
    cache_len = PROMPT + NEW
    jpre, jc, _ = jlm.forward(jp, jcfg, toks, mode="prefill",
                              cache_len=cache_len)
    tpre, tc, _ = lm.forward(tp, tcfg, ttoks, mode="prefill",
                             cache_len=cache_len)
    assert tpre.shape == (2, 1, 512)
    assert _rel(_vocab(tpre, tcfg), _vocab(jpre, tcfg)) <= tol
    nxt = np.array([[3], [5]], np.int32)
    jdec, jdc, _ = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jc, PROMPT)
    tdec, tdc, _ = lm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                  torch.tensor(PROMPT))
    assert _rel(_vocab(tdec, tcfg), _vocab(jdec, tcfg)) <= tol
    jflat = dict(_leaves(jax.tree.map(np.asarray, jdc)))
    tflat = dict(_leaves(tdc))
    assert set(tflat) == set(jflat) == {"seg0.sub0.k", "seg0.sub0.v"}
    for key, r in jflat.items():
        assert _rel(tflat[key], r) <= tol, key


@pytest.mark.parametrize("cache_len", [0, PROMPT - 5, PROMPT + NEW])
def test_prefill_caches_padded_as_the_reference(models, cache_len):
    """The prefill's K and V zero-padded along the sequence to
    ``cache_len``, never cut below the prompt, in the reference's tree."""
    jcfg, tcfg, jp, tp = models["granite-8b"]
    prompts = _prompts(tcfg)
    _, jc, _ = jlm.forward(jp, jcfg, jnp.asarray(prompts), mode="prefill",
                           cache_len=cache_len)
    _, tc, _ = lm.forward(tp, tcfg, torch.from_numpy(prompts),
                          mode="prefill", cache_len=cache_len)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jc)))
    tflat = dict(_leaves(tc))
    assert set(tflat) == set(jflat)
    S = max(cache_len, PROMPT)
    for key, r in jflat.items():
        assert tuple(tflat[key].shape) == r.shape == (
            tcfg.num_layers, 2, S, tcfg.num_kv_heads, tcfg.head_dim), key
        assert _rel(tflat[key], r) <= tolerance("float32"), key
        assert not tflat[key][:, :, PROMPT:].any(), key


def _clear_top1(logits, cfg, tol):
    """Per row, whether the reference's top-1 logit leads its top-2 by
    more than ``tol * max|logits|``: where it does not, a port within
    ``tol`` of the reference may pick the other token without a fault."""
    a = np.asarray(jnp.asarray(_vocab(logits, cfg), jnp.float32))[:, -1]
    top2 = np.sort(a, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > tol * np.abs(a).max()


def assert_greedy_agrees(ttokens, jtokens, clear):
    """Greedy tokens compared step by step while the reference's choice
    is clear (``clear[i]``: per row, at step i); a row's comparison stops
    at its first near-tie, after which the sequences may diverge. Returns
    the number of tokens compared per row."""
    compared = []
    for row in range(jtokens.shape[0]):
        n = 0
        while n < jtokens.shape[1] and clear[n][row]:
            n += 1
        np.testing.assert_array_equal(ttokens[row, :n], jtokens[row, :n])
        compared.append(n)
    return compared


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_generate_matches_reference_step_by_step(models, name, dtype):
    """Each step's logits with the reference's tokens fed to both (teacher
    forcing), and greedy ``generate`` against the reference's while the
    reference's top-1 leads its top-2 by more than the tolerance (the
    weights are the reference's ``init_params``, which change from
    process to process: a near-tie flips greedy argmax within the bound);
    in fp32 at least the first token is compared."""
    jcfg, tcfg, jp, tp = models[name]
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    tol = tolerance(dtype)
    prompts = _prompts(tcfg, seed=1)
    toks = jnp.asarray(prompts)
    cache_len = PROMPT + NEW
    jtokens = np.asarray(jserve.generate(jcfg, jp, toks, max_new=NEW,
                                         cache_len=cache_len))
    ttokens = serve.generate(tcfg, tp, torch.from_numpy(prompts),
                             max_new=NEW, cache_len=cache_len)
    assert ttokens.dtype == torch.int32 and ttokens.shape == (2, NEW)

    jpre = jsteps.make_prefill_step(jcfg, cache_len=cache_len)
    jdec = jsteps.make_decode_step(jcfg)
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
    compared = assert_greedy_agrees(ttokens.numpy(), jtokens, clear)
    if dtype == "float32":
        assert min(compared) >= 1, compared


def test_prefill_then_decode_matches_train_logits(models):
    """Inside the port: the causal prefill over the prompt and the cached
    decode steps give the train logits at every position."""
    _, tcfg, _, tp = models["qwen2-0.5b"]
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


def test_compute_params_casts_once_to_the_same_values(models):
    """``steps.compute_params``: the leaves every use casts to the compute
    dtype are cast once; norm scales and the SSM's fp32 leaves stay as
    stored, so the model computes the same values from either tree."""
    _, tcfg, _, tp = models["qwen2-0.5b"]
    bcfg = tcfg.replace(dtype="bfloat16")
    cast = steps.compute_params(tp, bcfg)
    seg = cast["seg0"]["sub0"]
    assert seg["attn"]["wq"].dtype == seg["ffn"]["w1"].dtype \
        == cast["embed"]["table"].dtype == torch.bfloat16
    assert seg["ln1"]["w"].dtype == cast["ln_f"]["w"].dtype == torch.float32
    assert steps.compute_params(tp, tcfg)["seg0"]["sub0"]["attn"]["wq"] \
        is tp["seg0"]["sub0"]["attn"]["wq"]
    toks = torch.from_numpy(_prompts(tcfg))
    a, _, _ = lm.forward(tp, bcfg, toks, mode="train")
    b, _, _ = lm.forward(cast, bcfg, toks, mode="train")
    assert torch.equal(a, b)


# ----------------------------------------------------------------------
# configs, parameters, caches, what still raises


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", DENSE + MOE)
def test_config_fields_and_param_count_match_reference(name, tiny):
    """Every field of the port's config, the parameter count (total and
    active: the routed experts at top_k of num_experts) and the spec tree
    (shapes, axes, init, scale) equal the reference's."""
    jcfg, tcfg = jget(name), tget(name)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert registry.count_params(tcfg) == jregistry.count_params(jcfg)
    assert registry.count_params(tcfg, active_only=True) \
        == jregistry.count_params(jcfg, active_only=True) \
        == tcfg.active_params()
    specs = dict(_leaves(registry.model_specs(tcfg)))
    jspecs = dict(_leaves(jregistry.model_specs(jcfg)))
    assert {k: (s.shape, s.axes, s.init, s.scale)
            for k, s in specs.items()} == {
        k: (s.shape, s.axes, s.init, s.scale) for k, s in jspecs.items()}


@pytest.mark.parametrize("name", MOE)
def test_moe_layer_plans_match_reference(name):
    """The layer plans and segments of the full MoE configs: granite-moe
    32 GQA + MoE layers in one stacked segment; DeepSeek-V2 its dense MLA
    first layer, then 59 MLA + MoE layers; a token visits under a fifth
    of DeepSeek's parameters (the reference's ``test_active_params_moe``)."""
    jcfg, tcfg = jget(name), tget(name)
    assert lm.layer_plan(tcfg) == jlm.layer_plan(jcfg)
    assert lm.segments(tcfg) == jlm.segments(jcfg)
    plan = lm.layer_plan(tcfg)
    if name == "deepseek-v2-236b":
        assert plan[0] == ("mla", "dense")
        assert plan[1:] == [("mla", "moe")] * 59
        assert lm.segments(tcfg) == [((("mla", "dense"),), 1),
                                     ((("mla", "moe"),), 59)]
        assert tcfg.active_params() < 0.2 * tcfg.num_params()
    else:
        assert lm.segments(tcfg) == [((("gqa", "moe"),), 32)]
        assert tcfg.num_params() == 3_299_575_296
        assert tcfg.active_params() == 883_656_192


def test_qwen2_is_the_published_width():
    cfg = tget("qwen2-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
            cfg.tie_embeddings, cfg.rope_theta) == (
        24, 896, 14, 2, 64, 4864, 151936, True, True, 1e6)
    assert L.padded_vocab(cfg.vocab_size) == 152064
    assert cfg.num_params() == jget("qwen2-0.5b").num_params()


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", DENSE + MOE)
def test_cache_struct_matches_reference(name, tiny):
    """K and V a GQA layer, the latent ``c_kv`` and ``k_rope`` an MLA
    layer, stacked as the segments are, in the compute dtype."""
    jcfg, tcfg = jget(name), tget(name)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    jflat = dict(_leaves(jlm.cache_struct(jcfg, 3, 50)))
    tflat = dict(_leaves(registry.cache_struct(tcfg, 3, 50)))
    want = {"seg0.sub0.k", "seg0.sub0.v"} if tcfg.attn_impl == "gqa" else {
        f"seg{i}.sub0.{k}" for i in (0, 1) for k in ("c_kv", "k_rope")}
    assert set(tflat) == set(jflat) == want
    for key, (shape, dt, axes) in tflat.items():
        assert (shape, axes) == jflat[key][::2], key
        assert dt == getattr(torch, tcfg.dtype)


@pytest.mark.parametrize("name", DENSE)
def test_dense_family_no_longer_raises(name):
    tcfg = ttiny(tget(name))
    assert ttiny(ArchConfig(name="dense-lm", family="dense")).family \
        == "dense"
    for plan in (("gqa", "none"), ("gqa", "dense")):
        assert "attn" in lm.block_specs(tcfg, plan)
    params = steps.init_params(tcfg, 0, "cpu")
    out = serve.generate(tcfg, params, torch.zeros((1, 3), dtype=torch.int64),
                         max_new=2, cache_len=5)
    assert out.shape == (1, 2)


def test_unported_plans_still_raise(models):
    """The hybrid plans (a Mamba mixer with a dense or MoE ffn), tiny
    jamba-1.5-large-398b (the hybrid family) and the full one, and
    whisper-base (an encoder-decoder) through the registry now build, as
    do MLA and MoE; an unknown mixer or ffn still raises."""
    tcfg = models["qwen2-0.5b"][1]
    for plan in (("mamba", "dense"), ("mamba", "moe")):
        assert "mamba" in lm.block_specs(tcfg.replace(ssm_state=16), plan)
    for plan in (("mla", "none"), ("mla", "dense"), ("mla", "moe"),
                 ("gqa", "moe")):
        lm._check_plan(plan)
    for plan in (("rwkv", "dense"), ("gqa", "glu")):
        with pytest.raises(ValueError, match="unknown"):
            lm._check_plan(plan)

    def port(name):  # the reference's config as the port's fields
        j = jget(name)
        return ArchConfig(**{f.name: getattr(j, f.name)
                             for f in dataclasses.fields(ArchConfig)})
    jamba, whisper = port("jamba-1.5-large-398b"), port("whisper-base")
    assert ttiny(jamba).num_layers == jamba.attn_layer_period
    for cfg in (jamba, whisper):
        assert registry.count_params(cfg) == jregistry.count_params(
            jget(cfg.name))
    assert registry.cache_struct(whisper, 1, 8)["cross"]["xk"][0] == (
        6, 1, 1500, 8, 64)


def test_serve_cli_runs_an_attention_lm_on_the_cpu(capsys):
    out = serve.main(["--arch", "qwen2-0.5b", "--tiny", "--batch", "2",
                      "--prompt-len", "5", "--max-new", "3",
                      "--device", "cpu"])
    assert out.shape == (2, 3) and out.dtype == torch.int32
    assert "generated 6 tokens on cpu" in capsys.readouterr().out


def test_replay_needs_the_card(models):
    """CUDA graphs run on the card: asking for them on the CPU raises, as
    the engine does; ``replay=False`` (the CPU default) runs."""
    _, tcfg, _, tp = models["qwen2-0.5b"]
    toks = torch.from_numpy(_prompts(tcfg))
    with pytest.raises(ValueError, match="CUDA graphs run on the card"):
        serve.generate(tcfg, tp, toks, max_new=2, cache_len=PROMPT + 2,
                       replay=True)
    with pytest.raises(ValueError, match="CUDA graphs run on the card"):
        steps.StepGraphs(tcfg, tp)
    out = serve.generate(tcfg, tp, toks, max_new=2, cache_len=PROMPT + 2,
                         replay=False)
    assert torch.equal(out, serve.generate(tcfg, tp, toks, max_new=2,
                                           cache_len=PROMPT + 2))


def test_capture_keeps_the_garbage_collector_off(monkeypatch):
    """``core.device.capture``, which every graph capture of the port goes
    through: the cyclic collector stays off inside the capture (a
    finalizer's CUDA call there would invalidate it), under
    ``CAPTURE_LOCK``, and is back on after, also when the capture raises;
    a collector the caller turned off stays off. ``torch.cuda.graph`` is
    stubbed: there is no card here."""
    import contextlib
    import gc

    from repro_torch.core import device

    seen = []

    @contextlib.contextmanager
    def graph(g, *, pool, stream, capture_error_mode):
        seen.append((g, pool, stream, capture_error_mode,
                     device.CAPTURE_LOCK.locked(), gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    with device.capture("g", stream="s", pool="p"):
        assert not gc.isenabled()
    assert seen == [("g", "p", "s", "thread_local", True, False)]
    assert gc.isenabled() and not device.CAPTURE_LOCK.locked()
    with pytest.raises(RuntimeError, match="boom"):
        with device.capture("g", stream="s"):
            raise RuntimeError("boom")
    assert gc.isenabled() and not device.CAPTURE_LOCK.locked()
    gc.disable()
    try:
        with device.capture("g", stream="s"):
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
