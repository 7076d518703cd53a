"""Hold the port's sharded serving steps against its unsharded ones, by
their logits, across the ranks of ``torchrun``.

Each rank takes one card (NCCL; gloo with ``--device cpu``) of a (1,
world size) ("data", "model") mesh (``launch.mesh.make_local_mesh``).
For each config the unsharded fp32 eager prefill of ``--batch`` x
``--prompt-len`` tokens (the prompts of ``launch.serve``'s ``main``,
weights from seed 0) and ``--steps`` greedy decode steps give the tokens
every later run is fed. For each ``--dtype`` the sharded and the
unsharded steps then run on every rank, and the first rank prints one
JSON line a config and dtype: for the prefill and each decode step,
max|sharded - unsharded| / max|unsharded| of the logits, the same of the
unsharded run against the unsharded fp32 one (the dtype's own rounding),
the smallest lead of a row's top-1 over its top-2 in the first unit, and
whether each row's greedy token agrees, beside the card's name and power
limit.

    torchrun --nproc-per-node 4 tools/mesh_serve_logits.py \\
        --arch mamba2-370m --arch qwen2-0.5b

On the CPU, cut in depth (``--layers``) or ``--tiny``:

    torchrun --nproc-per-node 4 tools/mesh_serve_logits.py \\
        --arch mamba2-370m --layers 2 --device cpu --dtype float32
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get, tiny_variant  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.sharding.rules import rules_for  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every config to this many layers")
    ap.add_argument("--dtype", action="append", default=None,
                    help="compute dtypes (default: bfloat16 and float32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda:
        # fp32 means IEEE fp32, as chip_smoke.py sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl", device_id=torch.device(
            "cuda", torch.cuda.current_device()))
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        torch.set_num_threads(1)
        dist.init_process_group("gloo")
        card, device = None, torch.device("cpu")
    mesh = make_local_mesh(args.device)
    try:
        for arch in args.arch:
            base = tiny_variant(get(arch)) if args.tiny else get(arch)
            if args.layers:
                base = base.replace(num_layers=args.layers)
            ref = unsharded(base.replace(dtype="float32"), device, args)
            for dt in args.dtype or ["bfloat16", "float32"]:
                rec = compare(base.replace(dtype=dt), mesh, device, args,
                              ref)
                if dist.get_rank() == 0:
                    print(json.dumps({"arch": arch, "dtype": dt,
                                      "layers": base.num_layers,
                                      "mesh": list(mesh.shape),
                                      "batch": args.batch,
                                      "prompt": args.prompt_len, **rec,
                                      "card": card}), flush=True)
    finally:
        dist.destroy_process_group()


def _prompts(cfg, device, args):
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=torch.Generator().manual_seed(1)
                         ).to(device)


def _run(params, cfg, prompts, fed, cache_len, mesh=None, rules=None):
    """The prefill's and each decode step's last-position logits, the
    decode steps fed ``fed`` (B, steps), or the greedy tokens if None ->
    (logits (B, V') a step, the tokens fed)."""
    S = prompts.shape[1]
    out, toks = [], []
    with torch.no_grad():  # DTensor's views fail in inference mode
        logits, caches = steps.prefill_step(params, cfg, prompts,
                                            cache_len=cache_len, mesh=mesh,
                                            rules=rules)
        for i in range(cache_len - S + 1):
            last = logits[:, -1]
            out.append(last.full_tensor() if isinstance(last, DTensor)
                       else last)
            if i == cache_len - S:
                break
            tok = out[-1][:, :cfg.vocab_size].argmax(-1)[:, None] \
                if fed is None else fed[:, i:i + 1]
            toks.append(tok)
            logits, caches = steps.decode_step(params, cfg, tok, caches,
                                               S + i, mesh=mesh, rules=rules)
    return out, torch.cat(toks, dim=1)


def unsharded(cfg, device, args):
    """The unsharded fp32 run: its logits a step and its greedy tokens."""
    params = steps.compute_params(steps.init_params(cfg, 0, device), cfg)
    return _run(params, cfg, _prompts(cfg, device, args), None,
                args.prompt_len + args.steps)


def compare(cfg, mesh, device, args, ref):
    """The sharded and unsharded steps of ``cfg`` on the same prompts, fed
    ``ref``'s tokens -> one record a step."""
    rules = rules_for(cfg, mesh)
    sharded = steps.compute_params(
        steps.init_params(cfg, 0, device, mesh=mesh, rules=rules), cfg)
    plain = steps.compute_params(steps.init_params(cfg, 0, device), cfg)
    prompts, cache_len = _prompts(cfg, device, args), \
        args.prompt_len + args.steps
    fp32, fed = ref
    slog, _ = _run(sharded, cfg, prompts, fed, cache_len, mesh, rules)
    plog, _ = _run(plain, cfg, prompts, fed, cache_len)
    V = cfg.vocab_size
    recs = [_step(s, p, f, V) for s, p, f in zip(slog, plog, fp32)]
    return {"steps": recs,
            "max_rel_err": max(r["rel_err"] for r in recs),
            "max_rel_err_unsharded_vs_fp32": max(
                r["unsharded_vs_fp32"] for r in recs),
            "tokens_agree": all(all(r["agree"]) for r in recs)}


def _step(sharded, plain, fp32, V):
    """One step's last-position logits (B, V'): sharded against plain,
    and plain against the unsharded fp32 run's."""
    s, p, f = (t[:, :V].float() for t in (sharded, plain, fp32))
    scale = p.abs().max()
    top = torch.topk(p, 2, dim=-1).values
    return {"rel_err": float((s - p).abs().max() / scale),
            "unsharded_vs_fp32": float((p - f).abs().max()
                                       / f.abs().max()),
            "min_top2_lead": float((top[:, 0] - top[:, 1]).min() / scale),
            "agree": (s.argmax(-1) == p.argmax(-1)).tolist()}


if __name__ == "__main__":
    main()
