"""The port's serving under a mesh on the CPU: the sharded prefill and
decode steps (``steps.prefill_step`` / ``decode_step(..., mesh=)``, the
split-KV decode of ``models.layers``, ``ssm.mamba_decode`` on channel and
head shards, the prefill's caches placed as a decode cell reads them) of
six tiny families on four ``gloo`` ranks of a 2x2 (data, model) mesh
against the unsharded steps, ``serve.generate`` with a mesh, the (1, 1)
mesh bitwise, and the reference's own sharded steps across packages.

The reference's side runs in a subprocess with 4 forced host devices, as
``tests/test_torch_mesh_train.py`` runs it, and hands its parameters,
prompt, tokens and logits over in an ``.npz``. Bound: max|y - ref| /
max|ref| <= 2e-5 in fp32 over the real vocab; greedy tokens equal where
the reference's top-1 leads by more than that share of its largest
logit.
"""
import numpy as np

import torch_mesh_workers as W
from test_torch_mesh_train import _Reference

FP32 = W.FP32
FAMILIES = ("qwen2-0.5b", "mamba2-370m", "granite-moe-3b-a800m",
            "deepseek-v2-236b", "jamba-1.5-large-398b", "whisper-base")
# the attention families whose decode cache is split along its sequence:
# GQA's K and V, MLA's latent and rope key, (B, L, ...) fp32 a layer
KV_BYTES = {"qwen2-0.5b": lambda cfg, B, L: 2 * B * L * cfg.num_kv_heads
            * cfg.head_dim * 4,
            "deepseek-v2-236b": lambda cfg, B, L: B * L * (
                cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 4}


def test_sharded_serving_matches_unsharded_on_a_2x2_mesh(tmp_path):
    """Each family: the prefill and 4 decode steps within 2e-5 of the
    unsharded steps, greedy tokens equal (the near-tie rule), every cache
    on ``input_specs``' placements after each step; GQA and MLA decode
    steps move fewer bytes in all than one layer's K and V cache (of 512
    positions): no cache block moves. ``compute_params`` keeps the
    weights' placements; ``generate`` sharded gives the unsharded
    tokens."""
    from repro_torch.configs import get, tiny_variant

    results = W.spawn("serving", tmp_path, list(FAMILIES))
    mine = results[0]
    for arch in FAMILIES:
        rec = mine[arch]
        assert max(rec["logits"]) <= FP32, (arch, rec["logits"])
        assert all(rec["greedy"]), (arch, rec["greedy"])
        assert rec["caches"] <= FP32, (arch, rec["caches"])
        assert rec["compute_params_placed"], arch
        for step in rec["placements"]:
            assert step and all(step.values()), (arch, step)
    for arch, kv in KV_BYTES.items():
        cfg = tiny_variant(get(arch))
        limit = kv(cfg, 4, mine[arch]["cache_len"])
        for r in results:
            for step in r[arch]["bytes"]:
                moved = sum(v for k, v in step.items() if k != "largest")
                assert 0 < moved < limit, (arch, step, limit)
                assert step["largest"] < limit / 4, (arch, step, limit)
    for r in results:
        gen = r["generate"]
        assert gen["sharded"].shape == (4, 5)
        assert np.array_equal(gen["sharded"].numpy(),
                              gen["unsharded"].numpy())


def test_one_by_one_mesh_is_bitwise_unsharded(tmp_path):
    """On a (1, 1) gloo mesh every family's sharded prefill and decode
    steps are bitwise the unsharded ones, their caches on the
    placements."""
    for arch, rec in W.one_rank_serving(FAMILIES, tmp_path).items():
        assert all(rec["bitwise"]), (arch, rec["bitwise"])
        assert all(all(step.values()) for step in rec["placements"]), arch


def test_qwen2_sharded_serving_matches_the_reference_sharded_steps(
        tmp_path):
    """The reference's ``make_prefill_step`` and ``make_decode_step`` on
    a (2, 2) mesh of 4 forced host devices and the port's sharded steps
    on 4 gloo ranks, from the same parameters and prompt, teacher-forced
    on the reference's greedy tokens: each step's logits within 2e-5."""
    npz = tmp_path / "ref.npz"
    ref_run = _Reference(f"""
        import os
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get, tiny_variant
        from repro.launch import steps
        from repro.models import spec as pspec
        from repro.sharding.rules import rules_for
        cfg = tiny_variant(get("qwen2-0.5b"))
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        rules = rules_for(cfg, mesh)
        B, S, L, NEW = 4, 12, 64, 4
        tokens = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        with mesh:
            params = steps.init_state(cfg, 0)["params"]
            sh = pspec.param_shardings(steps.state_specs(cfg)["params"],
                                       mesh, rules)
            params = jax.tree.map(jax.device_put, params, sh)
            prefill = jax.jit(steps.make_prefill_step(cfg, mesh, rules,
                                                      cache_len=L))
            decode = jax.jit(steps.make_decode_step(cfg, mesh, rules))
            logits, caches = prefill(params, {{"tokens": jnp.asarray(
                tokens)}})
            outs, fed = [np.asarray(logits)], []
            for i in range(NEW):
                tok = np.asarray(jnp.argmax(
                    logits[:, -1, :cfg.vocab_size], -1)).astype(
                        np.int32)[:, None]
                fed.append(tok)
                logits, caches = decode(params, jnp.asarray(tok), caches,
                                        jnp.asarray(S + i, jnp.int32))
                outs.append(np.asarray(logits))

        flat = {{}}
        def walk(node, path):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], path + (k,))
            else:
                flat["p." + ".".join(path)] = np.asarray(node)
        walk(params, ())
        np.savez({str(npz) + ".part.npz"!r}, tokens=tokens,
                 fed=np.concatenate(fed, 1), cache_len=L,
                 **{{f"l{{i}}": o for i, o in enumerate(outs)}}, **flat)
        os.replace({str(npz) + ".part.npz"!r}, {str(npz)!r})
    """, tmp_path)
    # the ranks start beside the reference and wait for its file
    ranks = W.start("reference_serving", tmp_path / "ranks", str(npz))
    try:
        ref_run.wait()
    except BaseException:
        ranks.kill()
        raise
    res = ranks.join()[0]
    assert len(res["logits"]) == 5
    assert max(res["logits"]) <= FP32, res["logits"]
