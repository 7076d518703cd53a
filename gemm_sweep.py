#!/usr/bin/env python3
"""Time the port's ``gemm`` kernel on one CUDA card at every split of the
contraction, at ResNet-18's product classes, beside ``gemm.plan``'s pick.

    python3 gemm_sweep.py

For each class (im2col's four products and Winograd's three batched
ones, 224² input) and each operand pairing (fp32; bf16 on the tensor
cores; bf16 against an fp32 ``b`` on the CUDA cores), every split the
kernel accepts is checked against the plain version within
``tolerance(dtype)`` and timed as ``chip_smoke.time_ms`` times a kernel
(a CUDA graph of 10 launches, CUDA events, the median of 15). One JSON
line per class and pairing: the ms of each split, the plan's split and
the fastest. The card's name and power limit come first. ``gemm.plan``'s
constants (``MIN_CTAS``, ``MIN_SPLIT_CHUNKS``) are read from these lines.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# (M, Kc, N, batch_b): im2col's products, then Winograd's 16 of an image
CLASSES = [(3136, 576, 64, 1), (784, 1152, 128, 1), (196, 2304, 256, 1),
           (49, 4608, 512, 1), (784, 64, 64, 16), (196, 128, 128, 16),
           (49, 256, 256, 16)]
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: no CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import gemm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    planned = gemm.plan
    for M, Kc, N, batch_b in CLASSES:
        for dt, bdt in PAIRS:
            if batch_b == 1 and bdt != dt:
                continue  # im2col's filters are in the compute dtype
            a = torch.randn(batch_b, M, Kc, device="cuda", generator=gen)
            b = torch.randn(batch_b, Kc, N, device="cuda", generator=gen)
            a, b = a.to(dt), (b * Kc ** -0.5).to(bdt)
            if batch_b == 1:
                b = b[0]
            ref = gemm.plain(a, b).float()
            chunks = -(-Kc // gemm.CHUNK[gemm.path(dt, bdt)])
            ms = {}
            try:
                for split in (1, 2, 4, 8, 16):
                    if split > chunks:
                        break
                    gemm.plan = lambda *_, s=split: (gemm.TILE, s)
                    y = gemm.gemm(a, b).float()
                    rel = ((y - ref).abs().max() / ref.abs().max()).item()
                    chip_smoke.require(
                        rel <= tolerance(dt),
                        f"gemm {M}x{Kc}x{N} split {split}: {rel}")
                    ms[split] = chip_smoke.time_ms(lambda: gemm.gemm(a, b))
            finally:
                gemm.plan = planned
            print(json.dumps({
                "M": M, "Kc": Kc, "N": N, "batch_b": batch_b,
                "a": str(dt).removeprefix("torch."),
                "b": str(bdt).removeprefix("torch."), "ms_by_split": ms,
                "plan_split": planned(M, N, Kc, batch_b, dt, bdt)[1],
                "fastest_split": min(ms, key=ms.get)}), flush=True)


if __name__ == "__main__":
    main()
