"""The port's Mamba-2 LM path on the CPU against the JAX package:
``ssd_chunked``, ``mamba_forward`` and ``mamba_decode`` per layer, the
tiny ``mamba2-370m`` ``lm.forward`` in train, prefill and decode modes with
both caches, and ``generate`` step by step against
``repro.launch.serve.generate``; plus the configs, the parameter count and
the entry points' device rule.

Inputs are numpy-seeded; the weights are drawn once by the reference and
carried across with ``repro_torch.convert`` (the reference seeds each
leaf with ``hash`` of its path, which changes from process to process).
Bound: max|y - ref| / max|ref| <= tolerance(dtype), 2e-5 in fp32.
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
from repro.models import lm as jlm
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro.models.spec import init_params as jinit
from repro_torch.configs import ArchConfig
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.convert import params_from_reference
from repro_torch.core.dtypes import tolerance
from repro_torch.kernels import causal_conv1d as cc
from repro_torch.launch import serve, steps
from repro_torch.models import lm, registry, ssm
from repro_torch.models.spec import flatten, unflatten

NAME = "mamba2-370m"
PROMPT, NEW = 37, 5  # the prompt crosses a 16-step SSD chunk boundary
FP32 = tolerance("float32")


def _rel(y, r):
    y = y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    r = np.asarray(r, dtype=np.float32)
    assert y.shape == r.shape, (y.shape, r.shape)
    return float(np.abs(y - r).max() / np.abs(r).max())


def _vocab(logits, cfg):
    """The logits of the real vocab (the padding columns are masked)."""
    return logits[..., :cfg.vocab_size]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


@pytest.fixture(scope="module")
def cfgs():
    return jtiny(jget(NAME)), ttiny(tget(NAME))


@pytest.fixture(scope="module")
def params(cfgs):
    """(reference params as numpy, the same params as port tensors)."""
    jcfg, _ = cfgs
    jp = jax.tree.map(np.asarray, jinit(jregistry.model_specs(jcfg), 0,
                                        jcfg.param_dtype))
    return jp, unflatten(params_from_reference(jp))


@pytest.fixture(scope="module")
def prompts(cfgs):
    return np.random.default_rng(0).integers(
        0, cfgs[0].vocab_size, (2, PROMPT)).astype(np.int32)


def _layer(tree, i=0):
    """Layer i of the stacked segment's Mamba parameters."""
    seg = tree["seg0"]["sub0"]["mamba"]
    return jax.tree.map(lambda a: a[i], seg) if isinstance(
        seg["in_proj"], np.ndarray) else lm._index(seg, i)


# ----------------------------------------------------------------------
# the SSD scan and one Mamba layer


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [37, 48])
def test_ssd_chunked_matches_reference(L, G):
    rng = np.random.default_rng(L + G)
    B, Hg, P, N, chunk = 2, 2, 4, 8, 16
    x = rng.standard_normal((B, L, G, Hg, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, G, Hg)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((G, Hg)) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    C = rng.standard_normal((B, L, G, N)).astype(np.float32)
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, C)),
                              chunk)
    ty, ts = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, C)),
                             chunk)
    assert _rel(ty, jy) <= FP32
    assert _rel(ts, js) <= FP32


@pytest.mark.parametrize("L", [2, PROMPT])
def test_mamba_forward_matches_reference(cfgs, params, L):
    """One layer with its decode cache; L = 2 is shorter than the conv
    window, so the cache's tail is padded with zeros."""
    jcfg, tcfg = cfgs
    x = np.random.default_rng(L).standard_normal(
        (2, L, jcfg.d_model)).astype(np.float32)
    jout, jcache = jssm.mamba_forward(_layer(params[0]), jcfg, jnp.asarray(x),
                                      want_cache=True)
    tout, tcache = ssm.mamba_forward(_layer(params[1]), tcfg,
                                     torch.from_numpy(x), want_cache=True)
    assert _rel(tout, jout) <= FP32
    for key in ("conv", "state"):
        assert _rel(tcache[key], jcache[key]) <= FP32, key


def test_mamba_forward_bf16_matches_reference(cfgs, params):
    jcfg, tcfg = (c.replace(dtype="bfloat16") for c in cfgs)
    x = np.random.default_rng(3).standard_normal(
        (2, PROMPT, jcfg.d_model)).astype(np.float32)
    jout, _ = jssm.mamba_forward(_layer(params[0]), jcfg,
                                 jnp.asarray(x, jnp.bfloat16))
    tout, _ = ssm.mamba_forward(_layer(params[1]), tcfg,
                                torch.from_numpy(x).to(torch.bfloat16))
    assert tout.dtype == torch.bfloat16
    assert _rel(tout, jnp.asarray(jout, jnp.float32)) <= tolerance("bfloat16")


def test_mamba_decode_matches_reference(cfgs, params):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(4)
    d_inner, G, N, P, H, Hg, conv_ch = ssm._dims(tcfg)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal(
                 (2, tcfg.ssm_conv_k - 1, conv_ch)).astype(np.float32),
             "state": rng.standard_normal((2, G, Hg, P, N)).astype(
                 np.float32)}
    jout, jcache = jssm.mamba_decode(_layer(params[0], 1), jcfg,
                                     jnp.asarray(x),
                                     jax.tree.map(jnp.asarray, cache), 7)
    tout, tcache = ssm.mamba_decode(
        _layer(params[1], 1), tcfg, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in cache.items()}, 7)
    assert _rel(tout, jout) <= FP32
    for key in ("conv", "state"):
        assert _rel(tcache[key], jcache[key]) <= FP32, key


# ----------------------------------------------------------------------
# the whole model


@pytest.fixture(scope="module")
def reference_run(cfgs, params, prompts):
    """The reference's train logits, prefill logits and caches, and one
    decode step's logits and caches."""
    jcfg, _ = cfgs
    jp, toks = params[0], jnp.asarray(prompts)
    train, _, _ = jlm.forward(jp, jcfg, toks, mode="train")
    pre, caches, _ = jlm.forward(jp, jcfg, toks, mode="prefill")
    nxt = jnp.asarray([[3], [5]], jnp.int32)
    dec, dcaches, _ = jlm.decode_step(jp, jcfg, nxt, caches, PROMPT)
    return {"train": train, "prefill": pre, "caches": caches,
            "decode": dec, "decode_caches": dcaches, "next": nxt}


def _assert_caches_match(tcaches, jcaches):
    jflat = dict(_leaves(jax.tree.map(np.asarray, jcaches)))
    tflat = dict(_leaves(tcaches))
    assert set(tflat) == set(jflat) == {"seg0.sub0.conv", "seg0.sub0.state"}
    for key, r in jflat.items():
        assert _rel(tflat[key], r) <= FP32, key


def test_lm_train_logits_match_reference(cfgs, params, prompts,
                                         reference_run):
    tcfg = cfgs[1]
    logits, caches, aux = lm.forward(params[1], tcfg,
                                     torch.from_numpy(prompts), mode="train")
    assert caches is None and float(aux) == 0.0
    assert _rel(_vocab(logits, tcfg), _vocab(reference_run["train"], tcfg)) \
        <= FP32


def test_lm_prefill_and_decode_match_reference(cfgs, params, prompts,
                                               reference_run):
    tcfg = cfgs[1]
    logits, caches, _ = lm.forward(params[1], tcfg,
                                   torch.from_numpy(prompts), mode="prefill")
    assert logits.shape == (2, 1, 512)
    assert _rel(_vocab(logits, tcfg), _vocab(reference_run["prefill"], tcfg)) \
        <= FP32
    _assert_caches_match(caches, reference_run["caches"])
    nxt = torch.from_numpy(np.array(reference_run["next"]))
    dec, dcaches, _ = lm.decode_step(params[1], tcfg, nxt, caches, PROMPT)
    assert _rel(_vocab(dec, tcfg), _vocab(reference_run["decode"], tcfg)) \
        <= FP32
    _assert_caches_match(dcaches, reference_run["decode_caches"])


def test_padding_columns_are_masked(cfgs, params, prompts):
    tcfg = cfgs[1]
    logits, _, _ = lm.forward(params[1], tcfg, torch.from_numpy(prompts),
                              mode="prefill")
    assert bool((logits[..., tcfg.vocab_size:]
                 == torch.finfo(logits.dtype).min).all())


def test_generate_matches_reference_step_by_step(cfgs, params, prompts):
    """Greedy ``generate`` against the reference's, and each step's logits
    with the reference's tokens fed to both (teacher forcing)."""
    jcfg, tcfg = cfgs
    jp, toks = params[0], jnp.asarray(prompts)
    jtokens = np.asarray(jserve.generate(jcfg, jp, toks, max_new=NEW,
                                         cache_len=PROMPT + NEW))
    ttokens = serve.generate(tcfg, params[1], torch.from_numpy(prompts),
                             max_new=NEW, cache_len=PROMPT + NEW)
    assert ttokens.dtype == torch.int32 and ttokens.shape == (2, NEW)
    np.testing.assert_array_equal(ttokens.numpy(), jtokens)

    jpre = jsteps.make_prefill_step(jcfg, cache_len=PROMPT + NEW)
    jdec = jsteps.make_decode_step(jcfg)
    jlog, jc = jpre(jp, {"tokens": toks})
    tlog, tc = steps.prefill_step(params[1], tcfg, torch.from_numpy(prompts),
                                  cache_len=PROMPT + NEW)
    assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= FP32
    for i in range(NEW - 1):
        tok = np.array(jtokens[:, i:i + 1])
        jlog, jc = jdec(jp, jnp.asarray(tok), jc, PROMPT + i)
        tlog, tc = steps.decode_step(params[1], tcfg, torch.from_numpy(tok),
                                     tc, PROMPT + i)
        assert _rel(_vocab(tlog, tcfg), _vocab(jlog, tcfg)) <= FP32, i


def test_prefill_then_decode_matches_train_logits(cfgs, params, prompts):
    """Inside the port: the chunked scan over the whole sequence and the
    recurrent steps give the same logits at every position."""
    tcfg = cfgs[1]
    seq = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (2, PROMPT + NEW)).astype(np.int32))
    train, _, _ = lm.forward(params[1], tcfg, seq, mode="train")
    logits, caches = steps.prefill_step(params[1], tcfg, seq[:, :PROMPT])
    assert _rel(_vocab(logits[:, 0], tcfg),
                _vocab(train[:, PROMPT - 1], tcfg)) <= FP32
    for i in range(NEW):
        logits, caches = steps.decode_step(params[1], tcfg,
                                           seq[:, PROMPT + i:PROMPT + i + 1],
                                           caches, PROMPT + i)
        if PROMPT + i + 1 < seq.shape[1]:
            assert _rel(_vocab(logits[:, 0], tcfg),
                        _vocab(train[:, PROMPT + i], tcfg)) <= FP32, i


def test_the_cpu_path_launches_no_kernel(cfgs, params, prompts):
    before = cc.causal_conv1d.launches
    serve.generate(cfgs[1], params[1], torch.from_numpy(prompts), max_new=2,
                   cache_len=PROMPT + 2)
    assert cc.causal_conv1d.launches == before


# ----------------------------------------------------------------------
# parameters, configs, caches


def test_lm_module_state_dict_is_the_reference_tree(cfgs, params, prompts):
    jcfg, tcfg = cfgs
    flat = params_from_reference(params[0])
    model = lm.LM(tcfg, flat)
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in _leaves(params[0])}
    assert tuple(sd["seg0.sub0.mamba.in_proj"].shape) == (2, 64, 2 * 128
                                                          + 2 * 16 + 8)
    out, _, _ = model(torch.from_numpy(prompts), mode="prefill")
    ref_out, _, _ = lm.forward(params[1], tcfg, torch.from_numpy(prompts),
                               mode="prefill")
    assert torch.equal(out, ref_out)
    with pytest.raises(ValueError, match="params do not match"):
        lm.LM(tcfg, {k: v for k, v in flat.items() if k != "ln_f.w"})


@pytest.mark.parametrize("tiny", [False, True])
def test_param_count_matches_reference(tiny):
    jcfg, tcfg = jget(NAME), tget(NAME)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    assert registry.count_params(tcfg) == tcfg.num_params() \
        == jregistry.count_params(jcfg)
    if not tiny:
        assert tcfg.num_params() == 368_756_224


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("name", ["resnet18", "resnet50", "mobilenet_v2",
                                  NAME])
def test_config_fields_match_reference(name, tiny):
    jcfg, tcfg = jget(name), tget(name)
    if tiny:
        jcfg, tcfg = jtiny(jcfg), ttiny(tcfg)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.d_inner, tcfg.ssm_nheads) == (jcfg.d_inner, jcfg.ssm_nheads)


def test_cache_struct_matches_reference(cfgs):
    jcfg, tcfg = cfgs
    jflat = dict(_leaves(jlm.cache_struct(jcfg, 3, 50)))
    tflat = dict(_leaves(registry.cache_struct(tcfg, 3, 50)))
    assert set(tflat) == set(jflat)
    for key, (shape, dt, axes) in tflat.items():
        assert (shape, axes) == jflat[key][::2], key
        assert dt == torch.float32


def test_unported_families_and_mixers_raise(cfgs):
    """The hybrid family and Mamba with a dense or MoE ffn now build, as
    does an encoder-decoder config; an unknown family, mixer or ffn
    still raises."""
    tcfg = cfgs[1]
    hybrid = ttiny(ArchConfig(name="hybrid-lm", family="hybrid",
                              vocab_size=256, attn_layer_period=4,
                              attn_layer_offset=2))
    assert hybrid.num_layers == 4 and hybrid.ssm_state == 16
    for plan in (("mamba", "dense"), ("mamba", "moe")):
        assert {"ln1", "mamba", "ln2", "ffn"} <= set(
            lm.block_specs(tcfg.replace(d_ff=128, num_experts=4,
                                        moe_d_ff=32), plan))
    with pytest.raises(ValueError, match="unknown family"):
        ttiny(ArchConfig(name="rnn-lm", family="rnn"))
    with pytest.raises(ValueError, match="unknown mixer"):
        lm.block_specs(tcfg, ("rwkv", "none"))
    with pytest.raises(ValueError, match="unknown ffn"):
        lm.block_specs(tcfg, ("mamba", "glu"))
    enc = registry.model_specs(tcfg.replace(
        is_encoder_decoder=True, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, act="gelu_mlp", num_encoder_layers=1, encoder_seq=8))
    assert {"enc", "dec", "enc_pos"} <= set(enc)


def test_entry_points_run_on_the_card_unless_told_otherwise(cfgs,
                                                            monkeypatch,
                                                            capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_state(cfgs[1], 0)
    argv = ["--arch", NAME, "--tiny", "--batch", "2", "--prompt-len", "5",
            "--max-new", "3"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
    out = serve.main(argv + ["--device", "cpu"])
    assert out.shape == (2, 3)
    assert "generated 6 tokens on cpu" in capsys.readouterr().out
    params = steps.init_params(cfgs[1], 0, "cpu")
    assert {k: v.device.type for k, v in flatten(params).items()} \
        == dict.fromkeys(flatten(lm.model_specs(cfgs[1])), "cpu")


def test_temperature_sampling_takes_an_explicit_generator(cfgs, params,
                                                          prompts):
    tcfg, toks = cfgs[1], torch.from_numpy(prompts)
    with pytest.raises(ValueError, match="torch.Generator"):
        serve.generate(tcfg, params[1], toks, max_new=2, cache_len=0,
                       temperature=1.0)
    draws = [serve.generate(tcfg, params[1], toks, max_new=3, cache_len=0,
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(11))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert int(draws[0].max()) < tcfg.vocab_size
