"""Fused blocks as CUDA kernels for Hopper.

Replace the two Pallas kernels of ``src/repro/kernels/fused_block.py``:

* ``fused_residual_conv`` (source ``csrc/fused_residual_conv.cu`` over the
  halo-resident, split conv tile of ``csrc/conv_tile.cuh``, which
  ``ilpm_conv`` shares): a ResNet block's last conv with the shortcut add
  and the outer activation in its output write. A ResNet-18 block's second
  conv does 0.23 GFLOP per launch and must move 1-10 MB, so in IEEE fp32
  (CUDA cores, 67 TFLOP/s) the arithmetic bounds it (the tuned path's 8
  launches: 0.0276 ms per image) and in bf16 the bytes do. The tile and
  its launch plan are ``ilpm_conv``'s (``ilpm_conv.plan`` at stride 1): an
  8x8-output halo'd tile staged once per channel chunk with ``cp.async``,
  every tap read from it against a 64-channel filter slab, the contraction
  split over channel chunks (and filter rows) by shape and dtype alone so
  the deep layers fill the card, ``mma.sync`` for bf16 and fp16 where C
  and K are multiples of 8, IEEE ``fmaf`` otherwise. The epilogue converts
  ``acc*scale + bias`` to the compute dtype, adds ``res`` and applies the
  activation, the op order of the unfused ``act(conv(x) + identity)``;
  after a split it runs once, in the reduction that sums the parts in
  order.
* ``fused_inverted_residual`` (source ``csrc/fused_inverted_residual.cu``):
  MobileNetV2's expand -> depthwise -> project block with the identity add,
  whose expanded tensor never reaches device memory. At MobileNetV2's
  shapes its fp32 operations on CUDA cores bound it. One block owns a
  ``tile`` x ``tile`` patch of output pixels, all output channels and one
  image, and loops over 32-channel slabs of the expanded width; neighbouring
  blocks recompute the expansion of their shared halo. ``choose_tile``
  picks the tile (8, 4, 2 or 1) that minimises an estimate of the time per
  launch, within a block's shared memory, so a 7x7 image still spreads
  over many SMs.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(``ref.<name>``) for a CPU tensor; ``<wrapper>.launches`` counts the
wrapper's launches (a split ``fused_residual_conv`` is two device kernels).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemm, ilpm_conv, ref

plain = ref.fused_residual_conv
plain_inverted_residual = ref.fused_inverted_residual

# csrc/fused_inverted_residual.cu: the mid slab width, the rows a thread
# carries in a block product, and a block's shared-memory limit on sm_90
IR_SLAB = 32
IR_GEMM_ROWS = 4
MAX_SMEM = 232448


def fused_residual_conv(x_padded, weights, *, res, act="relu"):
    """x_padded: (B, H+R-1, W+S-1, C) pre-padded, stride 1; weights:
    ``w`` (R, S, C, K) and optional ``scale``/``bias`` (K,); res: the
    (B, H, W, K) shortcut -> (B, H, W, K)."""
    if x_padded.device.type == "cpu":
        return plain(x_padded, weights, res=res, act=act)
    if x_padded.device.type != "cuda":
        raise ValueError(f"fused_residual_conv: no kernel for "
                         f"{x_padded.device}")
    w = weights["w"]
    B, Hp, Wp, C = x_padded.shape
    R, S, Cw, K = w.shape
    H, W = Hp - R + 1, Wp - S + 1
    if Cw != C or H < 1 or W < 1:
        raise ValueError(f"fused_residual_conv: bad geometry x "
                         f"{tuple(x_padded.shape)} w {tuple(w.shape)}")
    dev, dt = x_padded.device, x_padded.dtype
    name = "fused_residual_conv"
    code = _build.kernel_dtype(name, x_padded)
    _build.check_operand(name, "x_padded", x_padded, dev, dt)
    _build.check_operand(name, "w", w, dev, dt)
    _build.check_operand(name, "res", res, dev, dt, (B, H, W, K))
    sc, bi = _build.epilogue_vectors(weights.get("scale"),
                                     weights.get("bias"), K, dev)
    p = ilpm_conv.plan(x_padded, w, 1)
    out = torch.empty((B, H, W, K), dtype=dt, device=dev)
    ws = gemm.workspace(p.parts, B, H * W, K, dev)
    err = _build.library().fused_residual_conv_launch(
        code, x_padded.data_ptr(), w.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), res.data_ptr(), out.data_ptr(), B, Hp, Wp, C, R, S,
        K, _build.act_code(act), *ilpm_conv.launch_args(p, ws, dev))
    _build.check(err, name)
    fused_residual_conv.launches += 1
    return out


fused_residual_conv.launches = 0


def ir_smem_bytes(tile, stride, r, s, cin, cout, expanded):
    """Shared memory of one ``fused_inverted_residual`` block: the input
    halo, the w1 slab, the expanded and depthwise slabs, the w2 slab and
    the fp32 accumulator, all fp32."""
    npi = ((tile - 1) * stride + r) * ((tile - 1) * stride + s)
    npo = tile * tile
    return 4 * (npi * cin + (cin * IR_SLAB if expanded else 0)
                + npi * IR_SLAB + npo * IR_SLAB + IR_SLAB * cout
                + npo * cout)


def choose_tile(h, w, cin, mid, cout, r, s, stride, expanded, *, batch=1,
                sms=132):
    """The output tile of ``fused_inverted_residual``: among 8, 4, 2 and 1,
    within a block's shared memory, the one with the least estimated time,
    the larger of one block's FMAs (the block products padded to 4 rows
    and 32 columns, as the kernel computes them) and all blocks' FMAs over
    ``sms``. A tie goes to the larger tile."""
    def gemm(m, n, k):
        return -(-m // IR_GEMM_ROWS) * IR_GEMM_ROWS * -(-n // 32) * 32 * k

    oh, ow = -(-h // stride), -(-w // stride)
    best = None
    for tile in (8, 4, 2, 1):
        if ir_smem_bytes(tile, stride, r, s, cin, cout, expanded) > MAX_SMEM:
            continue
        npi = ((tile - 1) * stride + r) * ((tile - 1) * stride + s)
        npo = tile * tile
        work = -(-mid // IR_SLAB) * (
            (gemm(npi, IR_SLAB, cin) if expanded else 0)
            + npo * IR_SLAB * r * s + gemm(npo, cout, IR_SLAB))
        blocks = -(-oh // tile) * -(-ow // tile) * batch
        est = max(work, blocks * work / sms)
        if best is None or est < best[0]:
            best = (est, tile)
    if best is None:
        raise ValueError(f"fused_inverted_residual: no tile fits shared "
                         f"memory for Cin {cin}, Cout {cout}")
    return best[1]


def fused_inverted_residual(x, weights, *, stride=1, residual=False,
                            act="relu6", out_act=None):
    """x: (B, H, W, Cin) unpadded; weights: optional ``w1`` (1, 1, Cin,
    mid) with ``s1``/``b1`` (absent for t == 1 blocks), ``wdw`` (R, S, 1,
    mid) with ``sdw``/``bdw``, ``w2`` (1, 1, mid, Cout) with ``s2``/``b2``
    -> (B, ceil(H/stride), ceil(W/stride), Cout). ``residual`` adds ``x``
    (stride 1, Cin == Cout)."""
    if x.device.type == "cpu":
        return plain_inverted_residual(x, weights, stride=stride,
                                       residual=residual, act=act,
                                       out_act=out_act)
    name = "fused_inverted_residual"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    B, H, W, Cin = x.shape
    w1, wdw, w2 = weights.get("w1"), weights["wdw"], weights["w2"]
    R, S, one, mid = wdw.shape
    Cout = w2.shape[-1]
    expanded = w1 is not None
    if (one != 1 or stride not in (1, 2) or tuple(w2.shape) != (1, 1, mid, Cout)
            or (expanded and tuple(w1.shape) != (1, 1, Cin, mid))
            or (not expanded and mid != Cin)
            or (residual and (stride != 1 or Cin != Cout))):
        raise ValueError(
            f"{name}: bad geometry x {tuple(x.shape)} w1 "
            f"{None if w1 is None else tuple(w1.shape)} wdw "
            f"{tuple(wdw.shape)} w2 {tuple(w2.shape)} stride {stride} "
            f"residual {residual}")
    dev, dt = x.device, x.dtype
    code = _build.kernel_dtype(name, x)
    _build.check_operand(name, "x", x, dev, dt)
    _build.check_operand(name, "wdw", wdw, dev, dt)
    _build.check_operand(name, "w2", w2, dev, dt)
    ptrs = []
    if expanded:
        _build.check_operand(name, "w1", w1, dev, dt)
        s1, b1 = _build.epilogue_vectors(weights.get("s1"),
                                         weights.get("b1"), mid, dev)
        ptrs += [w1.data_ptr(), s1.data_ptr(), b1.data_ptr()]
    else:
        ptrs += [None, None, None]
    sdw, bdw = _build.epilogue_vectors(weights.get("sdw"),
                                       weights.get("bdw"), mid, dev)
    s2, b2 = _build.epilogue_vectors(weights.get("s2"), weights.get("b2"),
                                     Cout, dev)
    tile = choose_tile(H, W, Cin, mid, Cout, R, S, stride, expanded,
                       batch=B, sms=_sm_count(dev))
    out = torch.empty((B, -(-H // stride), -(-W // stride), Cout), dtype=dt,
                      device=dev)
    err = _build.library().fused_inverted_residual_launch(
        code, x.data_ptr(), *ptrs, wdw.data_ptr(), sdw.data_ptr(),
        bdw.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B, H, W, Cin, mid, Cout, R, S, stride, tile,
        _build.act_code(act), _build.act_code(out_act), int(residual),
        _build.stream(dev))
    _build.check(err, name)
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
