"""Serving loop (``repro/launch/serve.py``): one batched prefill, then
one decode step per new token, replayed as CUDA graphs on the card.

    python -m repro_torch.launch.serve --arch mamba2-370m | qwen2-0.5b \\
        | granite-moe-3b-a800m | jamba-1.5-large-398b [--tiny] \\
        [--batch 4] [--prompt-len 32] [--max-new 32] [--device cpu]

runs on the card, replaying CUDA graphs, unless ``--device`` names
another device, and raises without a card. Every decoder-only LM runs:
the ssm family (mamba2-370m), the dense GQA family (qwen2-0.5b,
granite-3-2b, granite-8b, minitron-8b), the moe family
(granite-moe-3b-a800m; deepseek-v2-236b), the hybrid family
(jamba-1.5-large-398b) and internvl2-26b's backbone on tokens alone;
the largest fit only tiny or cut in depth. ``generate`` takes tokens
only, as the reference's does: an encoder-decoder (whisper-base) needs
its frame embeddings, and is served through ``steps`` (``StepGraphs``'s
``prefill(tokens, frames=...)`` and ``decode``, or ``steps.prefill_step``
and ``steps.decode_step``), as is a prompt with patch embeddings
(``prefix_embeds=``). Weights come from seed 0 and the prompts from a
``torch.Generator`` seeded 1.

With ``--mesh`` it serves sharded under ``torchrun``, one rank a device
(NCCL on the cards, gloo with ``--device cpu``), on a (1, world size)
mesh (``local``) or a production one (``pod`` 16x16, ``multipod``
2x16x16), the weights and the caches placed by the config's
``rules_for``; the first rank prints:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen2-0.5b --tiny --mesh local --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import get, tiny_variant
from repro_torch.core.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.mesh import first_rank, mesh_device, mesh_from_env


def generate(cfg, params, prompts, *, max_new: int, cache_len: int,
             temperature: float = 0.0, generator=None, replay=None,
             graphs=None, mesh=None, rules=None):
    """prompts: (B, S) integer tokens -> (B, max_new) int32 samples:
    greedy at ``temperature`` 0, else drawn from the tempered softmax with
    ``generator`` (a ``torch.Generator`` on the logits' device).

    On the card ``generate`` replays CUDA graphs (``steps.StepGraphs``,
    the counterpart of the reference's ``jax.jit`` of both steps): the
    prefill's, then the decode step's ``max_new - 1`` times. ``graphs``, a
    ``StepGraphs`` of these ``params``, keeps the graphs across calls and
    implies replay (default: a new one, so the call captures both
    graphs). ``replay=False``
    dispatches every op eagerly, the only kind on the CPU; asking for
    replay there raises. Either way the weights are cast to the compute
    dtype once, not at every step, and sampling runs outside the graphs.

    With a ``mesh`` every rank of it calls ``generate`` alike, with
    ``params`` placed by ``rules`` (the config's ``rules_for`` unless
    given; ``steps.init_params(cfg, mesh=mesh)``) and the same prompts:
    the steps run sharded (``StepGraphs(cfg, params, mesh, rules)`` on
    the card) and every rank samples from the whole logits, so each draws
    the same tokens (at a temperature, from a generator seeded alike on
    every rank). DTensor's views fail in inference mode, so a mesh runs
    under ``no_grad``."""
    _tokens_only(cfg)
    B, S = prompts.shape
    on_card = prompts.device.type == "cuda"
    replay = (on_card if replay is None else bool(replay)) \
        or graphs is not None
    if replay and not on_card:
        raise ValueError(f"CUDA graphs run on the card, not on "
                         f"{prompts.device}: pass replay=False")
    with torch.inference_mode() if mesh is None else torch.no_grad():
        if replay:
            if graphs is None:
                graphs = steps.StepGraphs(cfg, params, mesh, rules)
            elif graphs.source is not params or graphs.cfg != cfg \
                    or graphs.mesh is not mesh:
                raise ValueError("graphs were built for other params, "
                                 "another config or another mesh")
            logits, caches = graphs.prefill(prompts, cache_len)

            def step(tok, pos):
                return graphs.decode(tok, caches, pos)
        else:
            cparams = steps.compute_params(params, cfg)
            logits, caches = steps.prefill_step(cparams, cfg, prompts,
                                                cache_len=cache_len,
                                                mesh=mesh, rules=rules)

            def step(tok, pos):
                nonlocal caches
                logits, caches = steps.decode_step(cparams, cfg, tok,
                                                   caches, pos, mesh=mesh,
                                                   rules=rules)
                return logits
        tok = _sample(_whole(logits)[:, -1], temperature, generator, cfg)
        outs = [tok]
        for i in range(max_new - 1):
            logits = step(tok[:, None], S + i)
            tok = _sample(_whole(logits)[:, 0], temperature, generator, cfg)
            outs.append(tok)
    return torch.stack(outs, dim=1)


def _whole(logits):
    """The logits whole on every rank (a sharded step's are a DTensor)."""
    return logits.full_tensor() if isinstance(logits, DTensor) else logits


def _tokens_only(cfg):
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: generate takes tokens only; "
            "serve it through repro_torch.launch.steps (StepGraphs.prefill("
            "tokens, cache_len, frames=...) then StepGraphs.decode, or "
            "steps.prefill_step(..., frames=...) then steps.decode_step)")


def _sample(logits, temperature, generator, cfg):
    logits = logits[:, :cfg.vocab_size]
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a "
                         "torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"],
                    default=None, help="serve sharded, under torchrun")
    ap.add_argument("--repeat", type=int, default=1,
                    help="generate this many times on the same graphs; "
                         "the last call is timed alone")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.tiny:
        cfg = tiny_variant(cfg)
    _tokens_only(cfg)
    mesh = mesh_from_env(args.mesh, args.device) if args.mesh else None
    try:
        device = mesh_device(mesh) if mesh is not None \
            else resolve_device(args.device)
        params = steps.init_params(cfg, 0, device, mesh=mesh)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len),
                                generator=torch.Generator().manual_seed(1)
                                ).to(device)
        graphs = steps.StepGraphs(cfg, params, mesh) \
            if device.type == "cuda" else None
        times = []
        for _ in range(max(args.repeat, 1)):
            t0 = time.perf_counter()
            out = generate(cfg, params, prompts, max_new=args.max_new,
                           cache_len=args.prompt_len + args.max_new,
                           graphs=graphs, mesh=mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        if first_rank(mesh):
            _report(args, mesh, device, times, out)
        # the graphs hold the communicators' captured work: gone first
        del graphs
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    return out


def _report(args, mesh, device, times, out):
    total = args.batch * args.max_new
    where = device if mesh is None else \
        f"a {tuple(mesh.shape)} mesh of {mesh.device_type} ranks"
    print(f"generated {total} tokens on {where} in {times[0]:.2f}s "
          f"({total / times[0]:.1f} tok/s incl. the kernels' first "
          f"build and the graphs' capture)")
    if len(times) > 1:
        print(f"last of {len(times)} calls: {times[-1] * 1e3:.2f} ms "
              f"({total / times[-1]:.1f} tok/s; "
              f"{times[-1] * 1e3 / args.max_new:.3f} ms a step)")
    print("sample row:", out[0][:16].tolist())
    print("tokens sha256:", hashlib.sha256(
        out.cpu().numpy().tobytes()).hexdigest(), flush=True)


if __name__ == "__main__":
    main()
