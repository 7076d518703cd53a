#!/usr/bin/env python3
"""Time the kernels on the port's split-K GEMM tile (``gemm``,
``pointwise_conv``, ``libdnn_conv``) and on its conv tile (``ilpm_conv``,
``fused_residual_conv``) on one CUDA card at every split of the
contraction, beside the plan's pick.

    python3 gemm_sweep.py

For each ``gemm`` class (ResNet-18's im2col products and Winograd's three
batched ones, 224² input) and each operand pairing (fp32; bf16 on the
tensor cores; bf16 against an fp32 ``b`` on the CUDA cores), and for each
conv class (``pointwise_conv`` at every 1x1 layer of MobileNetV2 and
ResNet-18, ``libdnn_conv`` at the paper's four 3x3 layers) in fp32 and
bf16, every split the kernel accepts is checked against the plain version
within ``tolerance(dtype)`` and timed as ``chip_smoke.time_ms`` times a
kernel (a CUDA graph of 10 launches, CUDA events, the median of 15). Then
the conv tile's classes (every ``ilpm_conv`` site of ResNet-18 on any of
its paths and MobileNetV2's stem, every ``fused_residual_conv`` block of
ResNet-18 and ResNet-50's 1x1 one) in fp32 and bf16, at every pair of a
channel-chunk split and a filter-row split the kernels accept. One JSON
line per class and dtype: the ms of each split (``"split x rsplit"`` on
the conv tile), the plan's split and the fastest. The card's name and
power limit come first. Then ``direct_conv`` at every class of forced
ResNet-18 direct, at a ladder of slice counts (1, 2, 3, 4, 6, 8, 12, 16,
24, 32, ... up to the chunks of the contraction, the least that fits
shared memory first), beside the plan's pick; then
``fused_inverted_residual`` at every block class of MobileNetV2 at every
tile its kernel accepts (the tiles of ``fused_block.IR_TILES`` within
``MAX_RECOMPUTE`` whose projection fits the accumulators and whose CTA
fits shared memory), beside the plan's pick; both in fp32 and bf16, every
option checked against the plain version; then ``depthwise_conv`` at every
depthwise class of MobileNetV2 (and the multiplier-2 class chip_smoke.py
runs) at every tile of ``depthwise_conv.options`` (on the plan's channel
group), beside the plan's pick, in fp32 and bf16. An fp32
``pointwise_conv`` has one split, its 32-channel slabs (``gemm.SLAB``),
so its lines time that one. ``gemm.plan``'s constants (``MIN_CTAS``,
``MIN_SPLIT_CHUNKS``), which the convs' ``gemm.conv_plan`` shares,
``ilpm_conv.plan``'s (``MIN_CTAS``, ``ROW_SPLIT_BELOW``),
``direct_conv.plan``'s (``MIN_CTAS``, ``MAX_SLICES``) and
``fused_block.plan``'s (``MAX_RECOMPUTE``, ``SLAB_COST``,
``CTAS_PER_SM``) and ``depthwise_conv.plan``'s tile rule are read from
these lines.

    python3 gemm_sweep.py direct ir dw

runs only the named parts (``gemm``, ``conv``, ``tile``, ``direct``,
``ir``, ``dw``, ``unroll``, ``wout``).

    python3 gemm_sweep.py unroll [--parent DIR]

times the two gathers: first the launch floor (``chip_smoke.launch_floor``:
one one-CTA op on 16 bytes, graph replay and profiler device time), then
``im2col_unroll`` at the paper's four 3x3 layers (forced im2col's 13
sites) and at chip_smoke.py's ragged class, at every option of
``im2col_conv.options`` beside the plan's pick, and
``winograd_input_transform`` (no plan: one launch shape) at ResNet-18's
three even 3x3/1 layers and at its ragged class, in fp32 and bf16, each
checked against the plain version exactly (a copy, and add/sub chains in
the plain version's order and rounding). Each line has the profiler's
device time of the kernel (the plan's pick) and of the library call, and
with ``--parent DIR`` (a checkout of an earlier tree) also the
graph-replay and device times of that tree's kernel on the same inputs,
built from its ``csrc`` with the same flags.

    python3 gemm_sweep.py wout [--parent DIR]

times ``winograd_output_transform`` the same way: the launch floor, then
ResNet-18's three even 3x3/1 layers and chip_smoke.py's ragged class
(``OUTPUT_CLASSES``) in fp32 and bf16, at every option of
``winograd_conv.options`` beside the plan's pick, each checked against the
plain version exactly, with each option's CTAs, threads and profiler
device time, the library call's, and with ``--parent`` the earlier tree's
kernel's (it must equal the plain version bitwise too: it rounds the
epilogue once).

    python3 gemm_sweep.py conv1d [--parent DIR]

times ``causal_conv1d`` at its classes (S and T: Mamba-2's 4 x 1024 x 2304
prefill and train class, bf16, and T in fp32; F: its 1 x 300 fp32 prefill;
J and J2: Jamba's 4 x 1024 x 17408 bf16 and 1 x 300 fp32; all on the xBC
view of the in-projection, K 4; and a ragged class whose view forces a
narrow vector) at every walk and block size, at the pick's vector and at
half of it, beside the pick, each option equal to the plain version, with
the ``F.conv1d(groups=C)`` call and a copy of the view (the same bytes);
then ``causal_conv1d_bwd`` at T (fp32, bf16) and the ragged class the same
way (the pick bitwise the plain version at its tile, the other options
within ``tolerance``) beside one ``aten.convolution_backward`` call, and
the forward plus backward beside ``F.conv1d`` with its autograd, then
(last: a profiler session slows later graph replays) the profiler's device
time of the backward's two kernels; with ``--parent DIR`` (a checkout of
an earlier tree) also that tree's forward kernel on the same inputs and
its forward plus backward as its ``CausalConv1d`` computed it (dx by the
forward kernel on the reversed dy, dw and db by eager reductions). The
parent's kernel takes the entry point of ``_PARENT_ARGS``.
"""
from __future__ import annotations

import ctypes
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


def conv_classes():
    """(kernel, H, C, K, R, stride) at 224² input: every 1x1 layer of
    ResNet-18 and MobileNetV2 (``pointwise_conv``), then every stride-1
    3x3 layer of ResNet-18 (``libdnn_conv`` under forced libdnn), each
    class once."""
    from repro_torch.configs import get
    from repro_torch.models import mobilenet, resnet

    classes = set()
    for name, model in (("resnet18", resnet), ("mobilenet_v2", mobilenet)):
        for _, spec in model.conv_specs(get(name)):
            if spec.groups == 1 and spec.r == 1:
                classes.add(("pointwise_conv", spec.h, spec.c, spec.k, 1,
                             spec.stride))
            elif name == "resnet18" and spec.r == 3 and spec.stride == 1:
                classes.add(("libdnn_conv", spec.h, spec.c, spec.k, 3, 1))
    return sorted(classes, key=lambda c: (c[0] != "pointwise_conv", c))


def conv_tile_classes():
    """(kernel, H, C, K, R, stride) at 224² input of the conv tile: every
    dense site of ResNet-18 but the stride-1 1x1s (ilpm on the tuned and
    forced paths), MobileNetV2's stem, ResNet-18's fused residual blocks
    and ResNet-50's 1x1 one, each class once."""
    from repro_torch.configs import get
    from repro_torch.models import mobilenet, resnet

    classes = {("fused_residual_conv", 56, 64, 256, 1, 1)}
    for name, model in (("resnet18", resnet), ("mobilenet_v2", mobilenet)):
        for site, spec in model.conv_specs(get(name)):
            if spec.groups != 1 or (spec.r == 1 and spec.stride == 1) or (
                    name == "mobilenet_v2" and spec.c != 3):
                continue
            classes.add(("ilpm_conv", spec.h, spec.c, spec.k, spec.r,
                         spec.stride))
            if name == "resnet18" and spec.r == 3 and spec.stride == 1:
                classes.add(("fused_residual_conv", spec.h, spec.c, spec.k,
                             3, 1))
    return sorted(classes)


def conv_tile_sweep(call, planned, C, R, tol):
    """ms by (split, rsplit) of ``call()`` on the conv tile, each pair
    forced through ``ilpm_conv.plan`` (the plan's chunk kept) and checked
    against ``call(plain=True)`` within ``tol``."""
    from repro_torch.kernels import ilpm_conv

    chunks = -(-C // planned.chunk)
    options = {f"{split}x{rsplit}": {"split": split, "rsplit": rsplit}
               for split in (1, 2, 4, 8, 16) if split <= chunks
               for rsplit in range(1, R + 1)}
    line = forced_sweep(call, ilpm_conv, planned, options, tol)
    return {"ms_by_split": line["ms"],
            "plan_split": f"{planned.split}x{planned.rsplit}",
            "fastest_split": line["fastest"]}


def sweep(call, kc, kind, planned_split, tol):
    """ms by split of ``call()`` over a contraction ``kc`` deep on path
    ``kind``, each split forced through ``gemm.plan`` and checked against
    ``call(plain=True)`` within ``tol``; with the plan's split and the
    fastest."""
    import chip_smoke
    from repro_torch.kernels import gemm

    ref = call(plain=True).float()
    chunks = -(-kc // gemm.CHUNK[kind])
    planned, ms = gemm.plan, {}
    try:
        for split in (1, 2, 4, 8, 16):
            if split > chunks:
                break
            gemm.plan = lambda *_, s=split: (gemm.TILE, s)
            y = call().float()
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            chip_smoke.require(rel <= tol, f"split {split}: {rel} > {tol}")
            ms[split] = chip_smoke.time_ms(call)
    finally:
        gemm.plan = planned
    return {"ms_by_split": ms, "plan_split": planned_split,
            "fastest_split": min(ms, key=ms.get)}


PARTS = ("gemm", "conv", "tile", "direct", "ir", "dw", "unroll", "wout",
         "conv1d")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: no CUDA card")
    args = sys.argv[1:]
    parent = None
    if "--parent" in args:
        i = args.index("--parent")
        parent = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    parts = args or PARTS
    if set(parts) - set(PARTS):
        raise SystemExit(f"gemm_sweep: parts are {PARTS}, got {parts}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "gemm" in parts:
        sweep_gemm(gen)
    if "conv" in parts:
        sweep_conv(gen)
    if "tile" in parts:
        sweep_conv_tile(gen)
    if "direct" in parts:
        sweep_direct(gen)
    if "ir" in parts:
        sweep_inverted_residual(gen)
    if "dw" in parts:
        sweep_depthwise(gen)
    if "unroll" in parts:
        sweep_unroll(gen, parent)
    if "wout" in parts:
        sweep_output_transform(gen, parent)
    if "conv1d" in parts:
        sweep_conv1d(gen, parent)


def sweep_gemm(gen):
    """``gemm``'s lines (``CLASSES`` x ``PAIRS``), inputs from ``gen``."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import gemm

    for M, Kc, N, batch_b in CLASSES:
        for dt, bdt in PAIRS:
            if batch_b == 1 and bdt != dt:
                continue  # im2col's filters are in the compute dtype
            a = torch.randn(batch_b, M, Kc, device="cuda", generator=gen)
            b = torch.randn(batch_b, Kc, N, device="cuda", generator=gen)
            a, b = a.to(dt), (b * Kc ** -0.5).to(bdt)
            if batch_b == 1:
                b = b[0]

            def call(plain=False, a=a, b=b):
                return (gemm.plain if plain else gemm.gemm)(a, b)
            line = sweep(call, Kc, gemm.path(dt, bdt),
                         gemm.plan(M, N, Kc, batch_b, dt, bdt)[1],
                         tolerance(dt))
            print(json.dumps({
                "kernel": "gemm", "M": M, "Kc": Kc, "N": N,
                "batch_b": batch_b, "a": str(dt).removeprefix("torch."),
                "b": str(bdt).removeprefix("torch."), **line}), flush=True)


def sweep_conv(gen):
    """The split-K convs' lines (``conv_classes``), inputs from ``gen``."""
    import chip_smoke
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import gemm, libdnn_conv, pointwise_conv, ref

    for kernel, H, C, K, R, stride in conv_classes():
        mod = pointwise_conv if kernel == "pointwise_conv" else libdnn_conv
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(1, H, H, C, device="cuda", generator=gen).to(dt)
            w = (torch.randn(R, R, C, K, device="cuda", generator=gen)
                 * (R * R * C) ** -0.5).to(dt)
            scale = torch.rand(K, device="cuda", generator=gen) + 0.5
            bias = torch.randn(K, device="cuda", generator=gen) * 0.1
            kw = dict(scale=scale, bias=bias, act="relu")
            if kernel == "pointwise_conv":
                kw["stride"] = stride
                split = mod.plan(x, w, stride)[1]
            else:
                x = ref.pad_same(x, R, R)
                split = mod.plan(x, w)[1]

            def call(plain=False, x=x, w=w, kw=kw, mod=mod, kernel=kernel):
                fn = mod.plain if plain else getattr(mod, kernel)
                return fn(x, w, **kw)
            if kernel == "pointwise_conv" and dt == torch.float32:
                # one split a slab, the only split its kernel takes
                y, ref_y = call().float(), call(plain=True).float()
                rel = ((y - ref_y).abs().max() / ref_y.abs().max()).item()
                chip_smoke.require(rel <= tolerance(dt), f"{rel}")
                line = {"ms_by_split": {split: chip_smoke.time_ms(call)},
                        "plan_split": split, "fastest_split": split}
            else:
                line = sweep(call, R * R * C, gemm.conv_path(x, w), split,
                             tolerance(dt))
            Ho = -(-H // stride)
            print(json.dumps({
                "kernel": kernel, "H": H, "C": C, "K": K, "R": R,
                "stride": stride, "M": Ho * Ho, "Kc": R * R * C, "N": K,
                "dtype": str(dt).removeprefix("torch."), **line}),
                flush=True)


def sweep_conv_tile(gen):
    """The conv tile's lines (``conv_tile_classes``), inputs from ``gen``."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import fused_block, ilpm_conv, ref

    for kernel, H, C, K, R, stride in conv_tile_classes():
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(1, H, H, C, device="cuda", generator=gen).to(dt)
            w = (torch.randn(R, R, C, K, device="cuda", generator=gen)
                 * (R * R * C) ** -0.5).to(dt)
            scale = torch.rand(K, device="cuda", generator=gen) + 0.5
            bias = torch.randn(K, device="cuda", generator=gen) * 0.1
            xp = ref.pad_same(x, R, R, stride)
            Ho = -(-H // stride)
            if kernel == "ilpm_conv":
                args = (xp, w)
                kw = dict(stride=stride, scale=scale, bias=bias, act="relu")
                mod = ilpm_conv
            else:
                args = (xp, {"w": w, "scale": scale, "bias": bias})
                kw = dict(res=torch.randn(1, Ho, Ho, K, device="cuda",
                                          generator=gen).to(dt), act="relu")
                mod = fused_block

            def call(plain=False, args=args, kw=kw, mod=mod, kernel=kernel):
                fn = mod.plain if plain else getattr(mod, kernel)
                return fn(*args, **kw)
            planned = ilpm_conv.plan(xp, w, stride)
            line = conv_tile_sweep(call, planned, C, R, tolerance(dt))
            print(json.dumps({
                "kernel": kernel, "H": H, "C": C, "K": K, "R": R,
                "stride": stride, "dtype": str(dt).removeprefix("torch."),
                "path": planned.path, "chunk": planned.chunk, **line}),
                flush=True)


def forced_sweep(call, module, planned, options, tol, device=False):
    """ms by option of ``call()``, each plan ``planned._replace(**option)``
    forced through ``module.plan`` and checked against ``call(plain=True)``
    within ``tol``; with the plan's option and the fastest. ``options``:
    label -> the fields to replace. With ``device``, also each option's
    profiler device time (``device_us_by_option``, µs)."""
    import chip_smoke

    ref = call(plain=True).float()
    plan, ms, dev = module.plan, {}, {}
    try:
        for label, fields in options.items():
            module.plan = lambda *_, f=fields: planned._replace(**f)
            y = call().float()
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            chip_smoke.require(rel <= tol, f"{label}: {rel} > {tol}")
            ms[label] = chip_smoke.time_ms(call)
            if device:
                dev[label] = chip_smoke.device_us(call)
    finally:
        module.plan = plan
    out = {"ms": ms, "fastest": min(ms, key=ms.get)}
    if device:
        out["device_us_by_option"] = dev
    return out


def _ladder(lo, hi):
    """1, 2, 3, 4, 6, 8, 12, 16, 24, ... within [lo, hi], and lo and hi."""
    steps, v = {lo, hi}, 1
    while v <= hi:
        steps.update(u for u in (v, 3 * v // 2) if lo <= u <= hi)
        v *= 2
    return sorted(steps)


def direct_classes():
    """(H, C, K, R, stride) of every conv site of ResNet-18 at 224² input
    (forced direct's 20 launches), each class once."""
    from repro_torch.configs import get
    from repro_torch.models import resnet

    return sorted({(spec.h, spec.c, spec.k, spec.r, spec.stride)
                   for _, spec in resnet.conv_specs(get("resnet18"))})


def sweep_direct(gen):
    """``direct_conv``'s lines (``direct_classes``), inputs from ``gen``."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import direct_conv, ref

    for H, C, K, R, stride in direct_classes():
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(1, H, H, C, device="cuda", generator=gen).to(dt)
            w = (torch.randn(R, R, C, K, device="cuda", generator=gen)
                 * (R * R * C) ** -0.5).to(dt)
            scale = torch.rand(K, device="cuda", generator=gen) + 0.5
            bias = torch.randn(K, device="cuda", generator=gen) * 0.1
            xp = ref.pad_same(x, R, R, stride)
            kw = dict(stride=stride, scale=scale, bias=bias, act="relu")

            def call(plain=False, xp=xp, w=w, kw=kw):
                fn = direct_conv.plain if plain else direct_conv.direct_conv
                return fn(xp, w, **kw)
            p = direct_conv.plan(xp, w, stride)
            chunks = -(-R * R * C // p.chunk)
            least = 1
            while direct_conv.smem_bytes(
                    p.path, x.element_size(), p.chunk,
                    direct_conv.slice_depth(chunks, p.chunk, least)) \
                    > direct_conv.MAX_SMEM:
                least += 1
            options = {str(s): {"slices": s}
                       for s in sorted({*_ladder(least, chunks), p.slices})}
            line = forced_sweep(call, direct_conv, p, options, tolerance(dt))
            print(json.dumps({
                "kernel": "direct_conv", "H": H, "C": C, "K": K, "R": R,
                "stride": stride, "dtype": str(dt).removeprefix("torch."),
                "path": p.path, "chunk": p.chunk,
                "plan": str(p.slices), **line}), flush=True)


def inverted_residual_classes():
    """(H, Cin, mid, Cout, R, stride, residual, expanded) of every block
    of MobileNetV2 at 224² input, each class once."""
    from repro_torch.configs import get
    from repro_torch.models import mobilenet

    return sorted({(b.h, b.cin, b.mid, b.cout, b.r, b.stride, b.residual,
                    b.expanded)
                   for _, b in mobilenet.block_specs(get("mobilenet_v2"))})


def sweep_inverted_residual(gen):
    """``fused_inverted_residual``'s lines, inputs from ``gen``."""
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import fused_block as fb

    for H, Cin, mid, Cout, R, stride, residual, expanded in \
            inverted_residual_classes():
        for dt in (torch.float32, torch.bfloat16):
            def randn(*dims, scale=1.0):
                return (torch.randn(*dims, device="cuda", generator=gen)
                        * scale).to(dt)

            def bn(n):
                return (torch.rand(n, device="cuda", generator=gen) + 0.5,
                        torch.randn(n, device="cuda", generator=gen) * 0.1)
            x = randn(1, H, H, Cin)
            weights = {}
            if expanded:
                weights["w1"] = randn(1, 1, Cin, mid, scale=Cin ** -0.5)
                weights["s1"], weights["b1"] = bn(mid)
            weights["wdw"] = randn(R, R, 1, mid, scale=1 / R)
            weights["sdw"], weights["bdw"] = bn(mid)
            weights["w2"] = randn(1, 1, mid, Cout, scale=mid ** -0.5)
            weights["s2"], weights["b2"] = bn(Cout)
            kw = dict(stride=stride, residual=residual)

            def call(plain=False, x=x, weights=weights, kw=kw):
                fn = fb.plain_inverted_residual if plain \
                    else fb.fused_inverted_residual
                return fn(x, weights, **kw)
            p = fb.plan(H, H, Cin, mid, Cout, R, R, stride, expanded, dt)
            options = {
                str(tile): {"tile": tile} for tile in fb.IR_TILES
                if fb.recompute(tile, stride, R, R) <= fb.MAX_RECOMPUTE
                and fb.acc_blocks(p.path, tile, Cout) <= fb.IR_MAX_ACC
                and fb.ir_smem_bytes(p.path, x.element_size(), tile, stride,
                                     R, R, Cin, Cout, expanded)
                <= fb.MAX_SMEM}
            line = forced_sweep(call, fb, p, options, tolerance(dt))
            print(json.dumps({
                "kernel": "fused_inverted_residual", "H": H, "Cin": Cin,
                "mid": mid, "Cout": Cout, "stride": stride,
                "residual": residual, "dtype": str(dt).removeprefix("torch."),
                "path": p.path, "parts": p.parts, "plan": str(p.tile),
                **line}),
                flush=True)


def depthwise_classes():
    """(H, C, M, R, stride) of every depthwise site of MobileNetV2 at 224²
    input, each class once, and the channel-multiplier-2 class that
    chip_smoke.py runs."""
    from repro_torch.configs import get
    from repro_torch.models import mobilenet

    return sorted({(spec.h, spec.c, spec.channel_multiplier, spec.r,
                    spec.stride)
                   for _, spec in mobilenet.conv_specs(get("mobilenet_v2"))
                   if spec.groups != 1} | {(14, 32, 2, 3, 2)})


def sweep_depthwise(gen):
    """``depthwise_conv``'s lines (``depthwise_classes``), every tile of
    ``depthwise_conv.options`` beside the plan's pick, inputs from
    ``gen``; with each option's bytes on the busiest SM, CTAs and threads,
    and the profiler's device time of the pick and of cuDNN's call."""
    import chip_smoke
    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import depthwise_conv as dw
    from repro_torch.kernels import ref

    for H, C, M, R, stride in depthwise_classes():
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(1, H, H, C, device="cuda", generator=gen).to(dt)
            w = (torch.randn(R, R, 1, M * C, device="cuda", generator=gen)
                 / R).to(dt)
            scale = torch.rand(M * C, device="cuda", generator=gen) + 0.5
            bias = torch.randn(M * C, device="cuda", generator=gen) * 0.1
            xp = ref.pad_same(x, R, R, stride)
            kw = dict(stride=stride, scale=scale, bias=bias, act="relu6")

            def call(plain=False, xp=xp, w=w, kw=kw):
                fn = dw.plain if plain else dw.depthwise_conv
                return fn(xp, w, **kw)
            p = dw.plan(xp, w, stride)
            Ho = -(-H // stride)
            opts = dw.options(Ho, Ho, M * C, R, R, stride, dt)

            def label(o):
                return f"{o.tile_h}x{o.tile_w}x{o.channels}"
            line = forced_sweep(call, dw, p, {label(o): o._asdict()
                                              for o in opts}, tolerance(dt))
            w_lib = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_lib = xp.permute(0, 3, 1, 2)
            print(json.dumps({
                "kernel": "depthwise_conv", "H": H, "C": C, "M": M, "R": R,
                "stride": stride, "dtype": str(dt).removeprefix("torch."),
                "plan": label(p),
                "sm_bytes": {label(o): dw.sm_bytes(o, Ho, Ho, M * C, R, R,
                                                   stride, dt)
                             for o in opts},
                "ctas": {label(o): dw.ctas(o, Ho, Ho, M * C) for o in opts},
                "threads": {label(o): dw.threads(o, dt) for o in opts},
                "device_us": {
                    "plan": chip_smoke.device_us(call, "dw"),
                    "library": chip_smoke.device_us(
                        lambda: torch.nn.functional.conv2d(
                            x_lib, w_lib, stride=stride, groups=C))},
                **line}), flush=True)


# im2col_unroll's classes (H, W, C, R): the paper's four layers, which
# forced im2col's 13 sites launch, and chip_smoke.py's ragged one; the
# input transform's (H, W, C): ResNet-18's even 3x3/1 layers and the ragged
# one
UNROLL_CLASSES = [(56, 56, 64, 3), (28, 28, 128, 3), (14, 14, 256, 3),
                  (7, 7, 512, 3), (9, 11, 6, 3)]
TRANSFORM_CLASSES = [(56, 56, 64), (28, 28, 128), (14, 14, 256),
                     (10, 14, 12)]
# (H, W, K): ResNet-18's three even 3x3/1 layers and chip_smoke.py's ragged
# class of the output transform (40- and 20-byte channel runs)
OUTPUT_CLASSES = [(56, 56, 64), (28, 28, 128), (14, 14, 256), (10, 14, 10)]


# The entry points of the kernels ``--parent`` builds, as the trees before
# their redesigns declared them: the two gathers before their plans
# (ef7b161), the output transform before its plan (4bd70e4), the causal
# conv before its plan (6349c9a): a dtype code, then the pointers, ints,
# long longs and ints of each group, then a stream.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PARENT_ARGS = {
    "im2col_unroll": [_I] + [_P] * 2 + [_I] * 8 + [_P],
    "winograd_input_transform": [_I] + [_P] * 2 + [_I] * 4 + [_P],
    "winograd_output_transform": [_I] + [_P] * 4 + [_I] * 5 + [_P],
    "causal_conv1d": [_I] + [_P] * 4 + [_I] * 4 + [_L] * 2 + [_I] + [_P]}


def parent_library(parent, kernels):
    """ctypes handle of ``kernels`` of the tree at ``parent`` (their
    ``csrc/<kernel>.cu``, whose entry points take the arguments of
    ``_PARENT_ARGS``), built with the port's nvcc flags into
    ``_build/parent-<hash>/``."""
    import hashlib
    import subprocess

    from repro_torch.kernels import _build

    csrc = parent / "src" / "repro_torch" / "csrc"
    srcs = [csrc / f"{k}.cu" for k in kernels]
    h = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(
        csrc.iterdir())) + " ".join(kernels).encode())
    out = _build.BUILD_ROOT / f"parent-{h.hexdigest()[:16]}"
    lib = out / "libparent.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), *map(str, srcs)], check=True,
                       capture_output=True)
    handle = ctypes.CDLL(str(lib))
    for k in kernels:
        getattr(handle, f"{k}_launch").argtypes = _PARENT_ARGS[k]
    return handle


def sweep_unroll(gen, parent):
    """The launch floor, then ``im2col_unroll``'s and the input
    transform's lines (``UNROLL_CLASSES``, ``TRANSFORM_CLASSES``), inputs
    from ``gen``; with each option's CTAs and bytes on the busiest SM, the
    profiler's device time of the pick, of the library call and (with
    ``parent``) of the parent tree's kernel, and that kernel's graph time."""
    import chip_smoke

    print(json.dumps(chip_smoke.launch_floor(device=True)), flush=True)
    old = parent_library(parent, ("im2col_unroll",
                                  "winograd_input_transform")) \
        if parent else None
    for kernel, classes in (("im2col_unroll", UNROLL_CLASSES),
                            ("winograd_input_transform", TRANSFORM_CLASSES)):
        for shape in classes:
            for dt in (torch.float32, torch.bfloat16):
                print(json.dumps(unroll_case(kernel, shape, dt, gen, old)),
                      flush=True)


def unroll_case(kernel, shape, dt, gen, old):
    """One line of ``sweep_unroll``: ``old`` is the parent's library or
    None."""
    import chip_smoke
    from repro_torch.kernels import _build, im2col_conv, ref, winograd_conv

    H, W, C = shape[:3]
    x = torch.randn(1, H, W, C, device="cuda", generator=gen).to(dt)
    xp = ref.pad_same(x, 3, 3)
    Hp, Wp = xp.shape[1], xp.shape[2]
    code = _build.DTYPE_CODES[dt]
    line = {"kernel": kernel, "H": H, "W": W, "C": C,
            "dtype": str(dt).removeprefix("torch.")}
    if kernel == "im2col_unroll":
        R = shape[3]
        p = im2col_conv.plan(xp, R, R)
        opts = im2col_conv.options(H, W, C, R, R, dt)

        def label(o):
            return f"{o.pixels}x{o.channels}"

        def call(plain=False):
            return (im2col_conv.plain if plain
                    else im2col_conv.im2col_unroll)(xp, R, R)

        def library():
            return torch.as_strided(
                xp, (1, H, W, R, R, C),
                (Hp * Wp * C, Wp * C, C, Wp * C, C, 1)).contiguous()
        out = torch.empty(1, H * W, R * R * C, dtype=dt, device="cuda")

        def parent_call():  # on the stream current at the call (a graph's)
            _build.check(old.im2col_unroll_launch(
                code, xp.data_ptr(), out.data_ptr(), 1, Hp, Wp, C, R, R, H,
                W, _build.stream(xp.device)), "parent im2col_unroll")
        # tolerance 0: each option must give the plain version exactly
        line.update(
            plan=label(p),
            ctas={label(o): im2col_conv.ctas(o, H, W, C) for o in opts},
            sm_bytes={label(o): im2col_conv.sm_bytes(o, H, W, C, R, R, dt)
                      for o in opts},
            **forced_sweep(call, im2col_conv, p,
                           {label(o): o._asdict() for o in opts}, 0.0,
                           device=True))
    else:
        th, tw = H // 2, W // 2
        bt = ref._BT.to("cuda", dt)

        def call(plain=False):
            return (winograd_conv.plain_input_transform if plain
                    else winograd_conv.winograd_input_transform)(xp, H, W)

        def library():  # the stride-2 4x4 windows, then Bᵀ d B
            d = torch.as_strided(xp, (1, th, tw, 4, 4, C),
                                 (Hp * Wp * C, 2 * Wp * C, 2 * C, Wp * C,
                                  C, 1))
            return torch.einsum("ar,bijrsc,es->baeijc", bt, d, bt)
        out = torch.empty(1, 4, 4, th * tw, C, dtype=dt, device="cuda")

        def parent_call():
            _build.check(old.winograd_input_transform_launch(
                code, xp.data_ptr(), out.data_ptr(), 1, Hp, Wp, C,
                _build.stream(xp.device)), "parent winograd_input_transform")
        chip_smoke.require(torch.equal(call(), call(True)),
                           f"{kernel} {shape} {dt}: not the plain version")
        line["ms"] = chip_smoke.time_ms(call)
    line["library_ms"] = chip_smoke.time_ms(library)
    line["device_us"] = {"plan": chip_smoke.device_us(call),
                         "library": chip_smoke.device_us(library)}
    if old is not None:
        # the parent's input transform rounded once in 16 bits: bitwise
        # to the plain version in fp32 only
        parent_call()
        exact = kernel == "im2col_unroll" or dt == torch.float32
        want = call(True)
        rel = ((out.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        chip_smoke.require(rel == 0.0 if exact else rel <= 1e-2,
                           f"parent {kernel} {shape} {dt}: {rel} off the "
                           "plain version")
        line["parent_ms"] = chip_smoke.time_ms(parent_call)
        line["device_us"]["parent"] = chip_smoke.device_us(parent_call)
    return line



def sweep_output_transform(gen, parent):
    """The launch floor, then ``winograd_output_transform``'s lines at
    ``OUTPUT_CLASSES`` in fp32 and bf16, inputs from ``gen``:
    every option of ``winograd_conv.options`` beside the plan's pick, each
    checked against the plain version exactly, with its CTAs and threads,
    and the profiler's device time of each option, of the library call and
    (with ``parent``) of the parent tree's kernel, and that kernel's graph
    time."""
    import chip_smoke
    from repro_torch.kernels import _build, ref, winograd_conv

    print(json.dumps(chip_smoke.launch_floor(device=True)), flush=True)
    old = parent_library(parent, ("winograd_output_transform",)) \
        if parent else None
    for H, W, K in OUTPUT_CLASSES:
        for dt in (torch.float32, torch.bfloat16):
            th, tw = H // 2, W // 2
            m = (torch.randn(1, 4, 4, th * tw, K, device="cuda",
                             generator=gen) * 3).to(dt)
            scale = torch.rand(K, device="cuda", generator=gen) + 0.5
            bias = torch.randn(K, device="cuda", generator=gen) * 0.1
            at = ref._AT.to("cuda", dt)
            s_lib, b_lib = scale.to(dt), bias.to(dt)
            kw = dict(scale=scale, bias=bias, act="relu")

            def call(plain=False, m=m, kw=kw):
                return (winograd_conv.plain_output_transform if plain
                        else winograd_conv.winograd_output_transform)(
                            m, H, W, **kw)

            def library(m=m, at=at, s_lib=s_lib, b_lib=b_lib, th=th, tw=tw):
                y = torch.einsum("ar,brstk,es->btaek", at, m, at)
                y = y.reshape(1, th, tw, 2, 2, K).permute(0, 1, 3, 2, 4, 5)
                return torch.relu(y.reshape(1, H, W, K) * s_lib + b_lib)
            p = winograd_conv.plan(m, H, W)
            opts = winograd_conv.options(H, W, K, dt)

            def label(o):
                return f"{o.tiles}x{o.channels}x{o.unit}"
            # tolerance 0: each option must give the plain version exactly
            line = {"kernel": "winograd_output_transform", "H": H, "W": W,
                    "K": K, "dtype": str(dt).removeprefix("torch."),
                    "plan": label(p),
                    "ctas": {label(o): winograd_conv.ctas(o, H, W, K)
                             for o in opts},
                    "threads": {label(o): winograd_conv.threads(o, dt)
                                for o in opts},
                    **forced_sweep(call, winograd_conv, p,
                                   {label(o): o._asdict() for o in opts},
                                   0.0, device=True)}
            chip_smoke.require(torch.equal(call(), call(True)),
                               f"output transform {H}x{W}x{K} {dt}: not "
                               "the plain version")
            line["library_ms"] = chip_smoke.time_ms(library)
            line["device_us"] = {
                "plan": line["device_us_by_option"][label(p)],
                "library": chip_smoke.device_us(library)}
            if old is not None:
                out = torch.empty(1, H, W, K, dtype=dt, device="cuda")

                def parent_call(m=m, out=out):
                    _build.check(old.winograd_output_transform_launch(
                        _build.DTYPE_CODES[dt], m.data_ptr(),
                        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), 1,
                        H, W, K, _build.act_code("relu"),
                        _build.stream(m.device)),
                        "parent winograd_output_transform")
                parent_call()
                want = call(True)
                # the parent kernel rounds once too: bitwise in every dtype
                chip_smoke.require(torch.equal(out, want),
                                   f"parent output transform {H}x{W}x{K} "
                                   f"{dt}: off the plain version")
                line["parent_ms"] = chip_smoke.time_ms(parent_call)
                line["device_us"]["parent"] = chip_smoke.device_us(
                    parent_call)
            print(json.dumps(line), flush=True)



# causal_conv1d's classes: (B, L, C, K, row stride, channel offset) of the
# xBC view and the dtype, by the names PERF.md's row 12 gives them
CONV1D_CLASSES = {
    "S": ((4, 1024, 2304, 4, 4384, 2048), torch.bfloat16),
    "T/fp32": ((4, 1024, 2304, 4, 4384, 2048), torch.float32),
    "F": ((1, 300, 2304, 4, 4384, 2048), torch.float32),
    "J": ((4, 1024, 17408, 4, 33920, 16384), torch.bfloat16),
    "J2": ((1, 300, 17408, 4, 33920, 16384), torch.float32),
    "ragged/fp32": ((2, 333, 1030, 3, 1037, 3), torch.float32),
    "ragged/bf16": ((2, 333, 1030, 3, 1037, 3), torch.bfloat16),
}
# the backward's: Mamba-2's train class (T; its bf16 is S's shape) and the
# ragged class
CONV1D_BWD_CLASSES = ("T/fp32", "S", "ragged/fp32", "ragged/bf16")


def conv1d_inputs(shape, dt, gen):
    """x (the xBC view of a wider buffer), w, b and dy of one class."""
    B, L, C, K, row, lo = shape
    x = torch.randn(B, L, row, device="cuda", generator=gen).to(dt)[
        ..., lo:lo + C]
    w = (torch.randn(K, C, device="cuda", generator=gen) * K ** -0.5).to(dt)
    b = (torch.randn(C, device="cuda", generator=gen) * 0.1).to(dt)
    dy = torch.randn(B, L, C, device="cuda", generator=gen).to(dt)
    return x, w, b, dy


def conv1d_label(vec, steps, threads):
    return f"v{vec}:{steps}x{threads}"


def conv1d_options(shape, dt, p):
    """label -> plan fields: every walk and block size at the pick's
    vector and at half of it."""
    from repro_torch.kernels import causal_conv1d as cc

    B, L, C = shape[:3]
    return {conv1d_label(v, s, t): {
                "vec": v, "steps": s, "threads": t,
                "blocks": -(-(C // v * -(-L // s) * B) // t)}
            for v in sorted({p.vec, max(p.vec // 2, 1)})
            for s in cc.BWD_STEPS for t in cc.THREADS}


def sweep_conv1d(gen, parent):
    """``causal_conv1d``'s forward at ``CONV1D_CLASSES`` and its backward
    at ``CONV1D_BWD_CLASSES`` (see the module's docstring), inputs from
    ``gen``."""
    import chip_smoke
    import torch.nn.functional as F

    from repro_torch.core.dtypes import tolerance
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import causal_conv1d as cc

    peaks = chip_smoke.CARD_PEAKS["H100 80GB HBM3"]
    print(json.dumps(chip_smoke.launch_floor()), flush=True)
    old = parent_library(parent, ("causal_conv1d",)) if parent else None

    def parent_conv(x, w, b):
        """The parent tree's kernel: two channels a thread where aligned."""
        B, L, C = x.shape
        out = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
        pair = cc.align_bytes(x, w, b, out) >= 2 * x.element_size()
        _build.check(old.causal_conv1d_launch(
            _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), B, L, C,
            w.shape[0], x.stride(0), x.stride(1),
            2 if pair and C % 2 == 0 else 1, _build.stream(x.device)),
            "parent causal_conv1d")
        return out

    def label(p):
        return conv1d_label(p.vec, p.steps, p.threads)

    plan_fn, profiled = cc.plan, {}
    for name, (shape, dt) in CONV1D_CLASSES.items():
        B, L, C, K, row, lo = shape
        x, w, b, dy = conv1d_inputs(shape, dt, gen)
        p = cc.plan(B, L, C, K, dt, cc.align_bytes(x, w, b))

        def call(plain=False, x=x, w=w, b=b):
            return (cc.plain if plain else cc.causal_conv1d)(x, w, b)
        chip_smoke.require(torch.equal(call(), call(True)),
                           f"causal_conv1d {name}: not the plain version")
        w_lib = w.t()[:, None].contiguous()
        nbytes = 2 * x.numel() * x.element_size() \
            + (K + 1) * C * x.element_size()
        size = str(dt).removeprefix("torch.")
        line = {"kernel": "causal_conv1d", "class": name, "shape": shape,
                "dtype": size, "plan": {**p._asdict(), "halo_share":
                                        cc.halo_share(p, L, K)},
                "pick": label(p),
                **forced_sweep(call, cc, p, conv1d_options(shape, dt, p),
                               0.0),
                "library_ms": chip_smoke.time_ms(
                    lambda x=x, w_lib=w_lib, b=b: F.conv1d(
                        x.transpose(1, 2), w_lib, b, padding=K - 1,
                        groups=C)[..., :L]),
                "bound_ms": max(2 * K * B * L * C / peaks[size],
                                nbytes / peaks["mem_bw"]) * 1e3,
                # the same bytes moved by PyTorch's copy of the view
                "copy_ms": chip_smoke.time_ms(
                    lambda x=x, out=torch.empty_like(x, memory_format=
                                                     torch.contiguous_format):
                    out.copy_(x))}
        if old is not None:
            chip_smoke.require(torch.equal(parent_conv(x, w, b), call()),
                               f"parent causal_conv1d {name}: differs")
            line["parent_ms"] = chip_smoke.time_ms(
                lambda x=x, w=w, b=b: parent_conv(x, w, b))
        print(json.dumps(line), flush=True)
        if name not in CONV1D_BWD_CLASSES:
            continue
        p = cc.plan(B, L, C, K, dt, cc.align_bytes(dy, x, w), backward=True)

        def bwd(x=x, w=w, dy=dy):
            return cc.causal_conv1d_bwd(dy, x, w, True)
        want = cc.plain_bwd(dy, x, w, True, p.steps)
        chip_smoke.require(all(map(torch.equal, bwd(), want)),
                           f"causal_conv1d_bwd {name}: not the plain version")
        flip = torch.flip(cc.causal_conv1d(torch.flip(dy, (1,)).contiguous(),
                                           w), (1,))
        chip_smoke.require(torch.equal(cc.causal_conv1d_bwd(dy, x, w, True)[0],
                                       flip),
                           f"causal_conv1d_bwd {name}: dx off the flip path")
        gy = F.pad(dy.transpose(1, 2), (0, K - 1)).contiguous()
        xt = x.transpose(1, 2)

        def library(gy=gy, xt=xt, w_lib=w_lib, C=C, K=K):
            return torch.ops.aten.convolution_backward(
                gy, xt, w_lib, [C], [1], [K - 1], [1], False, [0], C,
                [True, True, True])

        def fwd_bwd(x=x, w=w, b=b, dy=dy):
            cc.causal_conv1d(x, w, b)
            return cc.causal_conv1d_bwd(dy, x, w, True)
        xg = x.detach().requires_grad_()
        wg, bg = w.detach().requires_grad_(), b.detach().requires_grad_()

        def library_fwd_bwd(xg=xg, wg=wg, bg=bg, dy=dy, C=C, K=K, L=L):
            y = F.conv1d(xg.transpose(1, 2), wg.t()[:, None, :], bg,
                         padding=K - 1, groups=C)[..., :L].transpose(1, 2)
            return torch.autograd.grad(y, (xg, wg, bg), dy)
        nbytes = 3 * x.numel() * x.element_size() \
            + 2 * (K + 1) * C * x.element_size()
        ms = {}
        try:  # each option within tolerance of the plain version at the
            # pick's tile (another tile sums dw and db in another order)
            for key, fields in conv1d_options(shape, dt, p).items():
                cc.plan = lambda *_, f=fields, **__: p._replace(**f)
                errs = [chip_smoke.rel_err(g.float(), r.float())
                        for g, r in zip(bwd(), want)]
                chip_smoke.require(max(errs) <= tolerance(dt),
                                   f"causal_conv1d_bwd {name} {key}: {errs}")
                ms[key] = chip_smoke.time_ms(bwd)
        finally:
            cc.plan = plan_fn
        line = {"kernel": "causal_conv1d_bwd", "class": name, "shape": shape,
                "dtype": size, "pick": label(p), "ms": ms,
                "fastest": min(ms, key=ms.get),
                "library_ms": chip_smoke.time_ms(library),
                "bound_ms": max((4 * K + 1) * B * L * C / peaks[size],
                                nbytes / peaks["mem_bw"]) * 1e3,
                "fwd_bwd_ms": chip_smoke.time_ms(fwd_bwd),
                "library_fwd_bwd_ms": chip_smoke.time_ms(library_fwd_bwd)}
        if old is not None:
            def parent_fwd_bwd(x=x, w=w, b=b, dy=dy, K=K, L=L):
                """The parent tree's CausalConv1d: its forward kernel on
                the reversed dy for dx, eager reductions for dw and db."""
                parent_conv(x, w, b)
                dx = torch.flip(parent_conv(torch.flip(dy, (1,))
                                            .contiguous(), w, None), (1,))
                dy32 = dy.float()
                dw = torch.stack([
                    (dy32 * F.pad(x, (0, 0, K - 1 - j, 0))[:, :L].float())
                    .sum(dim=(0, 1)) for j in range(K)]).to(w.dtype)
                return dx, dw, dy32.sum(dim=(0, 1)).to(b.dtype)
            line["parent_fwd_bwd_ms"] = chip_smoke.time_ms(parent_fwd_bwd)
        print(json.dumps(line), flush=True)
        profiled[name] = bwd
    # last (a profiler session slows later graph replays): the device µs
    # of the backward's pass and of its ordered sum
    for name, bwd in profiled.items():
        print(json.dumps({
            "kernel": "causal_conv1d_bwd", "class": name, "device_us": {
                k: chip_smoke.device_us(bwd, f"causal_conv1d_{k}")
                for k in ("bwd_kernel", "bwd_reduce")}}), flush=True)


if __name__ == "__main__":
    main()
