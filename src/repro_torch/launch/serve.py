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
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get, tiny_variant
from repro_torch.core.device import resolve_device
from repro_torch.launch import steps


def generate(cfg, params, prompts, *, max_new: int, cache_len: int,
             temperature: float = 0.0, generator=None, replay=None,
             graphs=None):
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
    """
    _tokens_only(cfg)
    B, S = prompts.shape
    on_card = prompts.device.type == "cuda"
    replay = (on_card if replay is None else bool(replay)) \
        or graphs is not None
    if replay and not on_card:
        raise ValueError(f"CUDA graphs run on the card, not on "
                         f"{prompts.device}: pass replay=False")
    with torch.inference_mode():
        if replay:
            if graphs is None:
                graphs = steps.StepGraphs(cfg, params)
            elif graphs.source is not params or graphs.cfg != cfg:
                raise ValueError("graphs were built for other params or "
                                 "another config")
            logits, caches = graphs.prefill(prompts, cache_len)

            def step(tok, pos):
                return graphs.decode(tok, caches, pos)
        else:
            cparams = steps.compute_params(params, cfg)
            logits, caches = steps.prefill_step(cparams, cfg, prompts,
                                                cache_len=cache_len)

            def step(tok, pos):
                nonlocal caches
                logits, caches = steps.decode_step(cparams, cfg, tok,
                                                   caches, pos)
                return logits
        tok = _sample(logits[:, -1], temperature, generator, cfg)
        outs = [tok]
        for i in range(max_new - 1):
            logits = step(tok[:, None], S + i)
            tok = _sample(logits[:, 0], temperature, generator, cfg)
            outs.append(tok)
    return torch.stack(outs, dim=1)


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
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.tiny:
        cfg = tiny_variant(cfg)
    _tokens_only(cfg)
    device = resolve_device(args.device)
    params = steps.init_params(cfg, 0, device)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(
                                device)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, max_new=args.max_new,
                   cache_len=args.prompt_len + args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.batch * args.max_new
    print(f"generated {total} tokens on {device} in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. the kernels' first build and "
          f"the graphs' capture)")
    print("sample row:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
