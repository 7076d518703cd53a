"""Serving loop (``repro/launch/serve.py``): one batched prefill, then
one decode step per new token.

    python -m repro_torch.launch.serve --arch mamba2-370m [--tiny] \\
        [--batch 4] [--prompt-len 32] [--max-new 32] [--device cpu]

runs on the card unless ``--device`` names another device, and raises
without a card. Weights come from seed 0 and the prompts from a
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
             temperature: float = 0.0, generator=None):
    """prompts: (B, S) integer tokens -> (B, max_new) int32 samples:
    greedy at ``temperature`` 0, else drawn from the tempered softmax with
    ``generator`` (a ``torch.Generator`` on the logits' device)."""
    B, S = prompts.shape
    with torch.inference_mode():
        logits, caches = steps.prefill_step(params, cfg, prompts,
                                            cache_len=cache_len)
        tok = _sample(logits[:, -1], temperature, generator, cfg)
        outs = [tok]
        for i in range(max_new - 1):
            logits, caches = steps.decode_step(params, cfg, tok[:, None],
                                               caches, S + i)
            tok = _sample(logits[:, 0], temperature, generator, cfg)
            outs.append(tok)
    return torch.stack(outs, dim=1)


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
    device = resolve_device(args.device)
    params = steps.init_state(cfg, 0, device)["params"]
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
          f"({total / dt:.1f} tok/s incl. the kernels' first build)")
    print("sample row:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
