"""The train steps of the two LM families that ``test_torch_train.py``
does not hold against the reference: DeepSeek-V2 (MLA attention, a dense
first layer, routed and shared experts) and Jamba (the Mamba-2 mixer
beside GQA attention and routed experts), tiny, both on Adafactor as
published.

Two steps of the port's ``make_train_step`` against the reference's
jitted one, checked as ``test_train_steps_match_reference`` checks them:
in fp32 within 2e-5 three ways (the gradients, the step on the port's
gradients, the reference's own step on live entries); with the published
bf16 weights and bf16 compute, the gradients and the step on the port's
gradients within 3e-2 (bf16 rounds each weight's step to its grid).

The weights are the port's draw (``steps.init_state``, a leaf seeded by
the crc32 of its path), handed to both packages: the reference's draw
seeds a leaf by ``hash`` of its path, which changes with
``PYTHONHASHSEED``, and tiny Jamba's fp32 gradient is conditioned so
that the reference's own fp32 lies 1e-5 to 2e-5 from its fp64 on such
draws (``tools/train_grad_fp64.py``): a draw that changed from run to
run would make the bound a coin toss.
"""
import numpy as np
import pytest
import torch
from test_torch_train import hold_train_steps

from repro.configs import get as jget
from repro.configs import tiny_variant as jtiny
from repro_torch.configs import get as tget
from repro_torch.configs import tiny_variant as ttiny
from repro_torch.core.dtypes import tolerance
from repro_torch.launch import steps
from repro_torch.models.spec import flatten, unflatten

NAMES = ("deepseek-v2-236b", "jamba-1.5-large-398b")


def port_draw(tcfg, seed=0):
    """The port's initial train state as the reference's numpy tree, each
    leaf in its own dtype (bf16 as ``ml_dtypes``' bfloat16)."""
    import jax.numpy as jnp

    def np_leaf(v):
        if v.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16))
        return v.numpy()
    return unflatten({k: np_leaf(v) for k, v in
                      flatten(steps.init_state(tcfg, seed, "cpu")).items()})


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_reference_fp32(name):
    jcfg, tcfg = jtiny(jget(name)), ttiny(tget(name))
    assert jcfg.optimizer == tcfg.optimizer == "adafactor"
    hold_train_steps(jcfg, tcfg, bound=tolerance("float32"),
                     jstate=port_draw(tcfg))


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_reference_published_bf16(name):
    """The config's published ``dtype`` and ``param_dtype`` (bf16 weights,
    bf16 compute) and its Adafactor with fp32 momentum: every leaf that
    the loss reads is bf16, so ``loss_and_grads`` casts none of them."""
    pub = tget(name)
    assert (pub.dtype, pub.param_dtype, pub.opt_state_dtype) == (
        "bfloat16", "bfloat16", "float32")
    kw = dict(param_dtype=pub.param_dtype)
    jcfg = jtiny(jget(name)).replace(**kw)
    tcfg = ttiny(pub).replace(**kw)
    state = port_draw(tcfg)
    assert flatten(state)["params.embed.table"].dtype.name == "bfloat16"
    assert flatten(state)["opt.m.embed.table"].dtype == np.float32
    hold_train_steps(jcfg, tcfg, bound=tolerance("bfloat16"),
                     own_step=False, jstate=state)


# ----------------------------------------------------------------------
# chip_smoke.py's count of a train step's least time


def _meta_state(cfg):
    """The train state of ``cfg`` as meta tensors (shapes and dtypes, no
    storage), as ``steps.init_state`` would draw it."""
    from repro_torch.core.dtypes import torch_dtype
    from repro_torch.models.spec import tree_map

    return tree_map(lambda s: torch.empty(s.shape, device="meta", dtype=(
        torch_dtype(s.dtype or cfg.param_dtype))), steps.state_specs(cfg))


def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


PEAKS = {"float32": 67e12, "bfloat16": 989e12, "mem_bw": 3.35e12}
B, S = 4, 64


def test_train_bound_scales_the_routed_experts_by_top_k():
    """Tiny granite-moe: the routed experts' products count at top_k /
    num_experts of their weights, four times a step (the forward, its
    recompute, the backward's two)."""
    cs = _chip_smoke()
    cfg = ttiny(tget("granite-moe-3b-a800m"))
    state = _meta_state(cfg)
    routed = sum(v.numel() for k, v in flatten(state["params"]).items()
                 if ".ffn.w" in k and ".shared." not in k)
    assert routed and cfg.top_k < cfg.num_experts
    flops = {k: cs.train_bounds(cfg.replace(top_k=k), state, B, S,
                                PEAKS)["flops"] for k in (1, 2)}
    assert flops[2] - flops[1] == pytest.approx(
        4 * 2 * B * S * routed / cfg.num_experts)


@pytest.mark.parametrize("name,pair", [
    ("granite-moe-3b-a800m", lambda c: 4 * c.num_heads * c.head_dim),
    ("deepseek-v2-236b", lambda c: 2 * c.num_heads * (
        c.qk_nope_head_dim + c.qk_rope_head_dim + c.v_head_dim))])
def test_train_bound_counts_attention_at_each_layers_widths(name, pair):
    """GQA: the score and value products of head_dim a head; MLA:
    qk_nope + qk_rope for the scores, v_head_dim for the values; over the
    full (S, S) scores of every layer, four times a step; the optimizer's
    bytes by the state's own dtypes."""
    cs = _chip_smoke()
    cfg = ttiny(tget(name))
    state = _meta_state(cfg)
    got = cs.train_bounds(cfg, state, B, S, PEAKS)
    assert got["attention_flops"] == 4 * cfg.num_layers * pair(cfg) \
        * B * S * S
    nbytes = {k: v.numel() * v.element_size()
              for k, v in flatten(state).items() if k != "opt.step"}
    assert got["bytes"] == sum(3 * n if k.startswith("params.") else 2 * n
                               for k, n in nbytes.items())


def test_train_bound_of_mamba2_is_unchanged():
    """mamba2-370m at full size (meta tensors): no attention and no
    experts, so the count is the one before routed experts and attention
    were counted: T (4 (2 N_seg + SSD) + 6 d V) operations and 28 bytes a
    parameter for AdamW over fp32 weights."""
    cs = _chip_smoke()
    from repro_torch.models import ssm
    from repro_torch.models.layers import padded_vocab

    cfg = tget("mamba2-370m")
    state = _meta_state(cfg)
    leaves = flatten(state["params"])
    n = sum(v.numel() for v in leaves.values())
    matmul = sum(v.numel() for k, v in leaves.items() if k.startswith("seg")
                 and k.rsplit(".", 1)[1] not in cs.NOT_MATMUL)
    _, G, N, P, H, _, conv_ch = ssm._dims(cfg)
    Q, T = min(cfg.ssd_chunk, 1024), 4 * 1024
    ssd = cfg.num_layers * (2 * (G * Q * N + H * Q * P + 2 * H * N * P)
                            + 2 * cfg.ssm_conv_k * conv_ch)
    got = cs.train_bounds(cfg, state, 4, 1024, PEAKS)
    assert got["flops"] == T * (4 * (2 * matmul + ssd)
                                + 6 * cfg.d_model * padded_vocab(
                                    cfg.vocab_size))
    assert got["bytes"] == 28 * n and got["attention_flops"] == 0


def test_train_runs_without_checkpoints(tmp_path, monkeypatch):
    """``train(ckpt_dir=None)``: no checkpoint written or read."""
    from repro_torch.launch import train

    monkeypatch.chdir(tmp_path)
    cfg = ttiny(tget("deepseek-v2-236b")).replace(param_dtype="bfloat16")
    run = train.train(cfg, steps_total=2, batch=2, seq=8, ckpt_dir=None,
                      device="cpu")
    assert (run.step, run.restarts) == (2, 0)
    assert sorted(run.metrics) == [0, 1]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name,accum", [("qwen2-0.5b", 2),
                                        ("jamba-1.5-large-398b", 1)])
def test_apply_on_batch_grads_is_the_train_step_bitwise(name, accum):
    """``train_step.apply(state, *batch_grads(...))``, the step from
    gradients already taken (how chip_smoke's parity lines take the CPU's
    step once), is ``train_step(state, batch)`` bitwise."""
    from repro_torch.data import TokenPipeline

    cfg = ttiny(tget(name))
    state = steps.init_state(cfg, 0, "cpu")
    batch = TokenPipeline(cfg.vocab_size, 16, 2, seed=3).batch(0, "cpu")
    ts = steps.make_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=4,
                               accum=accum)
    want, wm = ts(state, batch)
    got, gm = ts.apply(state, *steps.batch_grads(cfg, state["params"],
                                                  batch, accum))
    for k, v in flatten(want).items():
        assert torch.equal(flatten(got)[k], v), k
    assert all(torch.equal(gm[k], wm[k]) for k in wm)


def test_train_keeps_no_copy_of_the_first_state(monkeypatch):
    """``train`` hands its first state to the loop and keeps no name on
    it: after the first step only the loop's state is alive (on the card
    the first state would be a second copy of the weights and optimizer
    state through the whole run)."""
    import gc
    import weakref

    from repro_torch.launch import train

    cfg = ttiny(tget("qwen2-0.5b"))
    first, alive = [], []
    draw = steps.init_state

    def init_state(*a, **kw):
        state = draw(*a, **kw)
        first.append(weakref.ref(flatten(state)["params.embed.table"]))
        return state

    def probe(step):
        gc.collect()
        alive.append(first[0]() is not None)
    monkeypatch.setattr(steps, "init_state", init_state)
    train.train(cfg, steps_total=3, batch=2, seq=8, ckpt_dir=None,
                device="cpu", fail_injector=probe)
    assert alive == [True, False, False]
