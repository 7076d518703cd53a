"""The port's MLA and MoE on the CPU against the JAX package: ``mla_attn``
and the absorbed ``mla_decode``; the router's top-k on exact ties; the
dense dispatch's slots and its dispatch tensor; ``moe``'s output and
load-balancing loss with and without drops and on tied router logits;
the sort-based dispatch against the reference's and against the dense
one; then the tiny variants of granite-moe-3b-a800m (GQA, 8 routed
experts top-2) and deepseek-v2-236b (MLA, a dense first layer, 8 routed
experts top-2 and one shared) in train, prefill and decode modes with
their summed ``aux``, and ``generate`` step by step.

Inputs and weights are numpy-seeded (the weights at the reference's
init scales, from its spec tree, the norm scales perturbed so a missing
norm shows) and carried across with ``repro_torch.convert``. Bound: max|y - ref| /
max|ref| <= tolerance(dtype): 2e-5 in fp32, 3e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.spec import unflatten

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


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _carry(jp):
    """Reference params (numpy) -> (jnp tree, port tree)."""
    return (jax.tree.map(jnp.asarray, jp),
            unflatten(params_from_reference(jp)))


def _draw(specs, seed):
    """A spec tree's weights drawn with numpy, scaled as ``init_params``
    scales them; the constant leaves (norm scales: ones) perturbed so a
    missing norm shows."""
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


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, port cfg, reference params (numpy), port
    params)} for the tiny MoE configs."""
    out = {}
    for i, name in enumerate(MOE):
        jcfg, tcfg = jtiny(jget(name)), ttiny(tget(name))
        jp = _draw(jregistry.model_specs(jcfg), 200 + i)
        out[name] = (jcfg, tcfg, jp, unflatten(params_from_reference(jp)))
    return out


def _first(tree):
    """Layer 0 of a stacked tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _moe_layer(tree):
    """The first MoE layer's ffn params (layer 0 of its segment)."""
    for seg in sorted(k for k in tree if k.startswith("seg")):
        ffn = tree[seg]["sub0"].get("ffn", {})
        if "router" in ffn:
            return _first(ffn) if ffn["router"].ndim == 3 else ffn
    raise AssertionError("no MoE layer")


def _mla_layer(tree):
    """Layer 0's MLA params (the dense first layer's)."""
    return tree["seg0"]["sub0"]["attn"]


# ----------------------------------------------------------------------
# MLA


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attn_matches_reference(models, dtype):
    """Decompressed K and V through the shared core with the 16 + 8 wide
    qk scaled by its inverse square root; the latent cache it returns."""
    jcfg, tcfg, jp, tp = models["deepseek-v2-236b"]
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    x = _normal(1, (2, PROMPT, tcfg.d_model))
    pos = np.arange(PROMPT)[None].repeat(2, 0)
    jx, tx = _pair(x, dtype)
    jpar, tpar = _carry(_mla_layer(jp))
    ref, (jc, jk) = jax.jit(lambda p, x, q: jL.mla_attn(p, jcfg, x, q))(
        jpar, jx, jnp.asarray(pos, jnp.int32))
    out, (tc, tk) = L.mla_attn(tpar, tcfg, tx, torch.from_numpy(pos))
    assert out.dtype == tx.dtype
    assert tuple(tc.shape) == (2, PROMPT, tcfg.kv_lora_rank)
    assert tuple(tk.shape) == (2, PROMPT, tcfg.qk_rope_head_dim)
    for a, r in ((out, ref), (tc, jc), (tk, jk)):
        assert _rel(a, r) <= tolerance(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_mla_decode_matches_reference(models, as_tensor, dtype):
    """The absorbed decode against a latent cache: the output, and the new
    latent written at ``pos`` only, ``pos`` an int or a 0-d tensor."""
    jcfg, tcfg, jp, tp = models["deepseek-v2-236b"]
    jcfg, tcfg = jcfg.replace(dtype=dtype), tcfg.replace(dtype=dtype)
    B, Smax, pos = 2, PROMPT + NEW, PROMPT
    x = _normal(3, (B, 1, tcfg.d_model))
    cache = {"c_kv": _normal(4, (B, Smax, tcfg.kv_lora_rank)),
             "k_rope": _normal(5, (B, Smax, tcfg.qk_rope_head_dim))}
    jx, tx = _pair(x, dtype)
    jc = {k: _pair(v, dtype)[0] for k, v in cache.items()}
    tc = {k: _pair(v, dtype)[1] for k, v in cache.items()}
    jpar, tpar = _carry(_mla_layer(jp))
    ref, jnew = jax.jit(lambda p, x, c: jL.mla_decode(p, jcfg, x, c, pos))(
        jpar, jx, jc)
    out, tnew = L.mla_decode(tpar, tcfg, tx, tc,
                             torch.tensor(pos) if as_tensor else pos)
    assert out.dtype == tx.dtype
    assert _rel(out, ref) <= tolerance(dtype)
    keep = [s for s in range(Smax) if s != pos]
    for key in ("c_kv", "k_rope"):
        assert _rel(tnew[key], jnew[key]) <= tolerance(dtype), key
        assert torch.equal(tnew[key][:, keep], tc[key][:, keep])


def test_mla_decode_equals_mla_attn_at_the_last_position(models):
    """Inside the port: absorbing W_uk and W_uv computes what the
    decompressed attention does, given the same latent cache."""
    _, tcfg, _, tp = models["deepseek-v2-236b"]
    p = _mla_layer(tp)
    x = torch.from_numpy(_normal(6, (2, 9, tcfg.d_model)))
    pos = torch.arange(9)[None].expand(2, 9)
    full, (c_kv, k_r) = L.mla_attn(p, tcfg, x, pos)
    cache = {"c_kv": F.pad(c_kv[:, :8], (0, 0, 0, 4)),
             "k_rope": F.pad(k_r[:, :8], (0, 0, 0, 4))}
    out, _ = L.mla_decode(p, tcfg, x[:, 8:], cache, 8)
    assert _rel(out, full[:, 8:].numpy()) <= tolerance("float32")


# ----------------------------------------------------------------------
# the router, the dense dispatch's slots and tensor


@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_top_k_orders_ties_as_lax_top_k(k):
    """Exact ties, hand-built: the lower index first, as ``lax.top_k``."""
    rows = np.array([
        [0.25, 0.25, 0.25, 0.25, 0.0, 0.0, 0.0, 0.0],
        [0.1, 0.3, 0.1, 0.3, 0.1, 0.0, 0.1, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.5, 0.5],
        [0.125] * 8,
        [0.2, 0.1, 0.2, 0.1, 0.2, 0.1, 0.0, 0.1],
    ], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(rows), k)
    tvals, tidx = L.top_k(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(vals))


def test_top_k_on_bf16_router_ties_matches_reference():
    """Logits rounded to bf16, cast to fp32: many exact ties among 40
    experts; the softmax's top-8 indices equal ``lax.top_k``'s."""
    logits = _normal(7, (64, 40)) * 4
    j = jax.nn.softmax(jnp.asarray(logits).astype(jnp.bfloat16).astype(
        jnp.float32), axis=-1)
    t = torch.from_numpy(np.array(j))
    assert (np.diff(np.sort(t.numpy(), -1), axis=-1) == 0).any()
    np.testing.assert_array_equal(L.top_k(t, 8)[1].numpy(),
                                  np.asarray(jax.lax.top_k(j, 8)[1]))


def _route(seed, T, N, k):
    """Random top-k expert choices (distinct a token) and gates."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(N)[:k] for _ in range(T)]).astype(
        np.int32)
    gate = rng.random((T, k)).astype(np.float32)
    return idx, gate / gate.sum(-1, keepdims=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [2, 8, 32])
def test_dispatch_mask_is_the_one_hot_product(cap, dtype):
    """The dispatch tensor written by one scatter is bitwise the
    reference's op-for-op product (one_hot(idx) * one_hot(pos) * inside,
    summed over k), in torch and in jnp, with and without drops."""
    T, N, k = 40, 8, 2
    idx, _ = _route(cap, T, N, k)
    tidx = torch.from_numpy(idx).long()
    pos, inside = L.dense_slots(tidx, N, cap)
    # the reference's slots
    onehot = jax.nn.one_hot(jnp.asarray(idx), N, dtype=jnp.int32)
    jpos = jnp.cumsum(onehot.reshape(T * k, N), axis=0).reshape(T, k, N) - 1
    jpos = (jpos * onehot).sum(-1)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    if cap != 8:  # at 2 entries drop, at 32 none
        assert bool((~inside).any()) == (cap == 2)
    tdt = getattr(torch, dtype)
    disp = L.dispatch_mask(tidx, pos, inside, N, cap, tdt)
    prod = (F.one_hot(tidx, N).to(tdt)[..., None]
            * F.one_hot(torch.clamp(pos, max=cap - 1), cap).to(tdt)[:, :, None]
            * inside[..., None, None].to(tdt)).sum(1)
    assert disp.dtype == tdt and torch.equal(disp, prod)
    jdisp = (jax.nn.one_hot(jnp.asarray(idx), N, dtype=dtype)[..., None]
             * jax.nn.one_hot(jpos, cap, dtype=dtype)[:, :, None, :]
             * (jpos < cap)[..., None, None].astype(dtype)).sum(1)
    assert torch.equal(disp.float(),
                       torch.from_numpy(np.array(jdisp, np.float32)))


def test_capacity_is_the_references():
    for name in MOE:
        cfg = tget(name)
        for T, cf in ((4096, 1.25), (4, 1.25), (300, 1.25), (42, 0.5)):
            c = cfg.replace(capacity_factor=cf)
            want = -(-max(int(cf * T * cfg.top_k / cfg.num_experts), 1)
                     // 8) * 8
            assert L.capacity(c, T) == want
    assert L._DENSE_MAX == 1 << 22


# ----------------------------------------------------------------------
# moe and the sort-based dispatch


def _moe_inputs(models, name, dtype, cf, seed=9, B=2, S=21):
    jcfg, tcfg, jp, _ = models[name]
    jcfg = jcfg.replace(dtype=dtype, capacity_factor=cf)
    tcfg = tcfg.replace(dtype=dtype, capacity_factor=cf)
    jpar, tpar = _carry(_moe_layer(jp))
    jx, tx = _pair(_normal(seed, (B, S, tcfg.d_model)), dtype)
    return jcfg, tcfg, jpar, tpar, jx, tx


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_moe_matches_reference(models, name, dtype, cf):
    """Output and Switch aux of one MoE layer (DeepSeek's with its shared
    expert) through the dense dispatch; at capacity factor 0.5 entries
    drop, and must drop as the reference's do."""
    jcfg, tcfg, jpar, tpar, jx, tx = _moe_inputs(models, name, dtype, cf)
    ref, jaux = jax.jit(lambda p, x: jL.moe(p, jcfg, x))(jpar, jx)
    out, aux = L.moe(tpar, tcfg, tx)
    assert out.dtype == tx.dtype and aux.dtype == torch.float32
    assert _rel(out, ref) <= tolerance(dtype)
    assert abs(float(aux) - float(jaux)) <= tolerance(dtype) * abs(
        float(jaux))
    if cf == 0.5:
        T = tx.shape[0] * tx.shape[1]
        _, _, idx = L.route(tpar, tcfg, tx)
        _, inside = L.dense_slots(idx.reshape(T, -1), tcfg.num_experts,
                                  L.capacity(tcfg, T))
        assert not inside.all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_moe_on_exact_router_ties_matches_reference(models, name, dtype):
    """Router columns repeated in pairs: every logit ties with its twin,
    so top-2 of 8 takes a tied pair; the lower index must come first and
    the same experts be chosen, at capacity factor 0.5 (drops too)."""
    jcfg, tcfg, jpar, tpar, jx, tx = _moe_inputs(models, name, dtype, 0.5,
                                                 seed=10)
    router = np.array(jpar["router"])
    router[:, 1::2] = router[:, 0::2]
    jpar = {**jpar, "router": jnp.asarray(router)}
    tpar = {**tpar, "router": torch.from_numpy(router)}
    ref, jaux = jax.jit(lambda p, x: jL.moe(p, jcfg, x))(jpar, jx)
    out, aux = L.moe(tpar, tcfg, tx)
    _, _, idx = L.route(tpar, tcfg, tx)
    assert (idx[..., 1] == idx[..., 0] + 1).all()  # the tied twins
    assert _rel(out, ref) <= tolerance(dtype)
    assert abs(float(aux) - float(jaux)) <= tolerance(dtype) * abs(
        float(jaux))


@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_dispatch_matches_reference(models, dtype, cf):
    """The sort-based dispatch on the same top-k and gates as the
    reference's, capacity counted per batch row; at 0.5 entries drop."""
    B, S = 3, 64
    jcfg, tcfg, jpar, tpar, jx, tx = _moe_inputs(
        models, "granite-moe-3b-a800m", dtype, cf, seed=11, B=B, S=S)
    idx, gate = _route(12, B * S, tcfg.num_experts, tcfg.top_k)
    idx, gate = idx.reshape(B, S, -1), gate.reshape(B, S, -1)
    ref = jax.jit(lambda p, x, i, g: jL._moe_scatter_dispatch(
        p, jcfg, x, i, g, None))(jpar, jx, jnp.asarray(idx),
                                 jnp.asarray(gate))
    out = L._moe_scatter_dispatch(tpar, tcfg, tx,
                                  torch.from_numpy(idx).long(),
                                  torch.from_numpy(gate))
    assert out.dtype == tx.dtype
    assert _rel(out, ref) <= tolerance(dtype)
    if cf == 0.5:
        cap = L.capacity(tcfg, S)
        load = np.stack([np.bincount(r.ravel(), minlength=tcfg.num_experts)
                         for r in idx])
        assert (load > cap).any()


@pytest.mark.parametrize("cf", [4.0, 8.0])
@pytest.mark.parametrize("b,s,seed", [(1, 8, 0), (2, 16, 1)])
def test_moe_sorted_equals_dense(models, b, s, seed, cf):
    """The reference's ``test_moe_sorted_equals_dense`` in the port: the
    sort-based dispatch equals the dense one at high capacity."""
    cfg = ttiny(tget("granite-moe-3b-a800m")).replace(
        capacity_factor=cf, num_shared_experts=0)
    _, _, jp, _ = models["granite-moe-3b-a800m"]
    p = _carry(_moe_layer(jp))[1]
    x = torch.from_numpy(_normal(20 + seed, (b, s, cfg.d_model), 0.3))
    y_dense, _ = L.moe(p, cfg.replace(moe_dispatch="dense"), x)
    _, gate, idx = L.route(p, cfg, x)
    y_sorted = L._moe_scatter_dispatch(p, cfg, x, idx, gate)
    np.testing.assert_allclose(y_dense.numpy(), y_sorted.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", MOE)
def test_moe_takes_the_references_dispatch(models, name, monkeypatch):
    """Above ``_DENSE_MAX`` (T * N) ``moe`` takes the sort-based dispatch,
    below it or with ``moe_dispatch="dense"`` the dense one, as the
    reference's ``moe`` does at 1 << 22; the shared expert added either
    way."""
    jcfg, tcfg, jpar, tpar, jx, tx = _moe_inputs(models, name, "float32",
                                                 0.5)
    probs = jax.nn.softmax(jnp.einsum("bse,ef->bsf", jx, jpar["router"]),
                           axis=-1)
    jgate, jidx = jax.lax.top_k(probs, jcfg.top_k)
    jgate = jgate / jnp.maximum(jgate.sum(-1, keepdims=True), 1e-9)
    ref = jax.jit(lambda p, x, i, g: jL._moe_scatter_dispatch(
        p, jcfg, x, i, g, None))(jpar, jx, jidx, jgate)
    if jcfg.num_shared_experts:
        ref = ref + jL.ffn(jpar["shared"], jcfg, jx)
    monkeypatch.setattr(L, "_DENSE_MAX", 8)
    out, _ = L.moe(tpar, tcfg, tx)
    assert _rel(out, ref) <= tolerance("float32")
    dense, _ = L.moe(tpar, tcfg.replace(moe_dispatch="dense"), tx)
    dcfg = jcfg.replace(moe_dispatch="dense")
    jdense, _ = jax.jit(lambda p, x: jL.moe(p, dcfg, x))(jpar, jx)
    assert _rel(dense, jdense) <= tolerance("float32")
    assert not torch.allclose(out, dense)  # the two drop differently


# ----------------------------------------------------------------------
# the whole model


def _prompts(cfg, seed=0, S=PROMPT):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_lm_train_prefill_decode_match_reference(models, name, dtype, cf):
    """Train, prefill and decode logits, the summed aux of the MoE layers
    and the caches (K/V, or the MLA latent), at capacity factor 1.25 and
    0.5 (drops)."""
    jcfg, tcfg, jp, tp = models[name]
    jcfg = jcfg.replace(dtype=dtype, capacity_factor=cf)
    tcfg = tcfg.replace(dtype=dtype, capacity_factor=cf)
    tol = tolerance(dtype)
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
    nxt = np.array([[3], [5]], np.int32)
    jdec, jdc, jaux = jax.jit(lambda p, t, c: jlm.decode_step(
        p, jcfg, t, c, PROMPT))(jp, jnp.asarray(nxt), jc)
    tdec, tdc, aux = lm.decode_step(tp, tcfg, torch.from_numpy(nxt), tc,
                                    torch.tensor(PROMPT))
    assert abs(float(aux) - float(jaux)) <= tol * float(jaux)
    assert _rel(_vocab(tdec, tcfg), _vocab(jdec, tcfg)) <= tol
    jflat = dict(_leaves(jax.tree.map(np.asarray, jdc)))
    tflat = dict(_leaves(tdc))
    assert set(tflat) == set(jflat)
    for key, r in jflat.items():
        assert _rel(tflat[key], r) <= tol, key


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_generate_matches_reference_step_by_step(models, name, dtype):
    """Greedy ``generate`` against the reference's, and each step's logits
    with the reference's tokens fed to both (teacher forcing)."""
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
    np.testing.assert_array_equal(ttokens.numpy(), jtokens)

    jpre = jax.jit(jsteps.make_prefill_step(jcfg, cache_len=cache_len))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jlog, jc = jpre(jp, {"tokens": toks})
    cparams = steps.compute_params(tp, tcfg)
    tlog, tc = steps.prefill_step(cparams, tcfg, torch.from_numpy(prompts),
                                  cache_len=cache_len)
    assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol
    for i in range(NEW - 1):
        tok = np.array(jtokens[:, i:i + 1])
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, PROMPT + i)
        tlog, tc = steps.decode_step(cparams, tcfg, torch.from_numpy(tok),
                                     tc, PROMPT + i)
        assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= tol, i


@pytest.mark.parametrize("name", MOE)
def test_prefill_then_decode_matches_train_logits(models, name):
    """Inside the port, at capacity factor 8 (no drops, so a token's
    experts do not depend on the others in its batch): the prefill and
    the cached decode steps give the train logits at every position, as
    the reference's ``test_prefill_decode_consistency``."""
    _, tcfg, _, tp = models[name]
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


def test_compute_params_keeps_the_mla_norms_fp32(models):
    """``steps.compute_params`` casts the MLA and MoE matrices (the router
    too) to the compute dtype once and keeps ``q_norm.w`` and
    ``kv_norm.w``, norm scales, fp32; the model computes the same values
    from either tree."""
    _, tcfg, _, tp = models["deepseek-v2-236b"]
    bcfg = tcfg.replace(dtype="bfloat16")
    cast = steps.compute_params(tp, bcfg)
    attn = cast["seg0"]["sub0"]["attn"]
    ffn = cast["seg1"]["sub0"]["ffn"]
    assert attn["q_norm"]["w"].dtype == attn["kv_norm"]["w"].dtype \
        == torch.float32
    assert attn["w_dq"].dtype == attn["w_uk"].dtype == ffn["router"].dtype \
        == ffn["w1"].dtype == ffn["shared"]["w1"].dtype == torch.bfloat16
    toks = torch.from_numpy(_prompts(tcfg))
    a, _, aux_a = lm.forward(tp, bcfg, toks, mode="train")
    b, _, aux_b = lm.forward(cast, bcfg, toks, mode="train")
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
