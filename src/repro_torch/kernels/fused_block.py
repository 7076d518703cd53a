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
* ``fused_inverted_residual`` (source ``csrc/fused_inverted_residual.cu``,
  on ``gemm_tile.cuh``'s copies, ``ldmatrix``, ``mma.sync`` and split
  reduction): MobileNetV2's expand -> depthwise -> project block with the
  identity add, whose expanded tensor never reaches device memory. The 17
  blocks do 0.56 GFLOP per image, so in IEEE fp32 (CUDA cores) the
  arithmetic bounds them (0.0084 ms per image). A CTA owns a ``tile`` x
  ``tile`` patch of output pixels of one image and one 32-channel slab of
  the mid width: it stages its input halo and the slab's weights with
  ``cp.async``, expands the halo, runs the depthwise taps and projects the
  slab into fp32 accumulators held in registers. The first kernel could
  reach more CTAs only by shrinking the tile (49 CTAs at 14² and 7², each
  re-expanding 4-9x its outputs' halo), multiplied with one column a
  thread and kept the projection sum in shared memory; now the mid width
  is split into its slabs, ``plan`` picks the tile from the shape and
  dtype alone (never the number of images) with a halo recompute of at
  most ``MAX_RECOMPUTE``, and a second kernel of the same launch sums the
  slabs' fp32 partials in order, with the projection epilogue, the cast
  and the identity add. A CTA walking several slabs was slower at every
  MobileNetV2 block (``gemm_sweep.py``): fewer CTAs, each a chain of
  dependent stages. fp32 runs IEEE ``fmaf`` on 4x4 register blocks, and
  its expand, like its project, sums each 32-channel slab of the
  contraction from 0 and folds the slabs in order: the order of the fp32
  ``pointwise_conv`` (``gemm.SLAB``), so the fused and the per-layer
  plans give bitwise equal logits. bf16 and fp16 run the expand and the
  project on ``mma.sync`` where Cin, mid and Cout are multiples of 8, the
  depthwise taps on the CUDA cores in fp32.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(``ref.<name>``) for a CPU tensor; ``<wrapper>.launches`` counts the
wrapper's launches (a split launch of either is two device kernels).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, gemm, ilpm_conv, ref

plain = ref.fused_residual_conv
plain_inverted_residual = ref.fused_inverted_residual

# csrc/fused_inverted_residual.cu: the mid slab width (the fp32 1x1
# contractions' slab, which pointwise_conv shares), threads and warps of
# a CTA, the projection blocks a thread (CUDA cores: 4x4 outputs) or a
# warp (tensor cores: 16x16) holds at most, and a block's shared-memory
# limit on sm_90
IR_SLAB = gemm.SLAB
IR_THREADS = 256
IR_WARPS = 8
IR_MAX_ACC = 8
MAX_SMEM = 232448
# The plan's search: output tile sides and the most halo recompute a tile
# may cost. Its estimate of a launch: waves of CTAs (CTAS_PER_SM of a
# path on one SM, 1 where the fp32 path holds more than 2 projection
# blocks a thread; shared memory may allow fewer) times a slab's
# multiply-adds plus SLAB_COST, the latency of a slab's three dependent
# stages in multiply-adds. Read from gemm_sweep.py (``ir``, every tile at
# MobileNetV2's 12 block classes, fp32 and bf16, one H100): the pick is
# within 7% of the fastest at all 24, for SLAB_COST anywhere in 50k-1M;
# 2 CTAs a SM on the tensor cores, as on the CUDA cores, put it 23% off
# at the 112² stride-2 block.
IR_TILES = (8, 7, 6, 5, 4, 3, 2, 1)
MAX_RECOMPUTE = 2.3
SLAB_COST = 380_000
CTAS_PER_SM = {"fp32": 2, "tensor": 4}
SM_SMEM = 233472  # shared memory of one SM, 1 KB a CTA reserved


class IRPlan(NamedTuple):
    """A launch plan of ``fused_inverted_residual``: its path (``"fp32"``:
    CUDA cores, ``"tensor"``: mma.sync), output tile side and parts of the
    mid width (its 32-channel slabs, one a CTA)."""
    path: str
    tile: int
    parts: int


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


def _up(v, m):
    return -(-v // m) * m


def ir_path(cin, mid, cout, dtype) -> str:
    """``"tensor"`` (mma.sync) for a 16-bit block whose Cin, mid and Cout
    are multiples of 8, else ``"fp32"`` (CUDA-core fmaf)."""
    return "tensor" if dtype in gemm.HALF and cin % 8 == 0 \
        and mid % 8 == 0 and cout % 8 == 0 else "fp32"


def recompute(tile, stride, r, s) -> float:
    """Halo pixels a CTA expands over the input pixels its outputs
    cover: ((tile-1)·stride + R)·((tile-1)·stride + S) / (stride·tile)²."""
    return ((tile - 1) * stride + r) * ((tile - 1) * stride + s) \
        / (stride * tile) ** 2


def _geometry(path, tile, stride, r, s, cin, cout):
    """(npi, npo, npi_pad, npo_pad, kin, cout_pad) as the launcher derives
    them: halo and output pixels, rows padded to the products' M granule
    (16 on the tensor cores, 4 on the CUDA cores), Cin and Cout padded
    to it."""
    g = 16 if path == "tensor" else 4
    npi = ((tile - 1) * stride + r) * ((tile - 1) * stride + s)
    npo = tile * tile
    return npi, npo, _up(npi, g), _up(npo, g), _up(cin, g), _up(cout, g)


def ir_smem_bytes(path, itemsize, tile, stride, r, s, cin, cout, expanded):
    """Shared memory of one CTA, as ``csrc/fused_inverted_residual.cu``
    lays it out: the input halo, the slab's w1, wdw and w2 slices, the
    expanded slab (fp32) and the depthwise slab (T on the tensor cores,
    else fp32), rows padded as the kernel pads them."""
    v = 16 // itemsize
    npi, _, npi_pad, npo_pad, kin, cout_pad = _geometry(
        path, tile, stride, r, s, cin, cout)
    weights = (_up(kin * (IR_SLAB + v) * itemsize, 16) if expanded else 0) \
        + _up(r * s * IR_SLAB * itemsize, 16) \
        + _up(IR_SLAB * (_up(cout_pad, v) + v) * itemsize, 16)
    d = npo_pad * (IR_SLAB + 8) * itemsize if path == "tensor" \
        else npo_pad * (IR_SLAB + 4) * 4
    return (_up(npi_pad * (_up(kin, v) + v) * itemsize, 16)
            + weights + _up(npi * (IR_SLAB + 4) * 4, 16) + d)


def acc_blocks(path, tile, cout) -> int:
    """Projection blocks one thread (CUDA cores, 4x4) or warp (tensor
    cores, 16x16) holds: at most ``IR_MAX_ACC``."""
    _, _, _, npo_pad, _, cout_pad = _geometry(path, tile, 1, 1, 1, 1, cout)
    if path == "tensor":
        return -(-(npo_pad // 16 * (cout_pad // 16)) // IR_WARPS)
    return -(-(npo_pad // 4 * (cout_pad // 4)) // IR_THREADS)


def slab_work(path, tile, stride, r, s, cin, cout, expanded) -> int:
    """Multiply-adds of one slab of one CTA, padded as the kernel pads
    them: the expand over the halo, the depthwise taps, the project."""
    _, npo, npi_pad, npo_pad, kin, cout_pad = _geometry(
        path, tile, stride, r, s, cin, cout)
    return ((npi_pad * IR_SLAB * kin if expanded else 0)
            + npo * IR_SLAB * r * s + npo_pad * cout_pad * IR_SLAB)


def ctas_per_sm(path, itemsize, tile, stride, r, s, cin, cout, expanded):
    """CTAs one SM holds at once: the path's ``CTAS_PER_SM`` (1 where the
    fp32 path holds more than 2 projection blocks a thread), fewer where
    their shared memory does not fit."""
    regs = 1 if path == "fp32" and acc_blocks(path, tile, cout) > 2 \
        else CTAS_PER_SM[path]
    smem = ir_smem_bytes(path, itemsize, tile, stride, r, s, cin, cout,
                         expanded)
    return max(1, min(regs, SM_SMEM // (smem + 1024)))


@functools.lru_cache(maxsize=1024)
def plan(h, w, cin, mid, cout, r, s, stride, expanded, dtype) -> IRPlan:
    """The launch plan of ``fused_inverted_residual`` on an (h, w, cin)
    input: one part a 32-channel slab of the mid width and, among the
    tiles of ``IR_TILES`` whose halo recompute is at most
    ``MAX_RECOMPUTE``, whose projection fits the accumulators and whose
    CTA fits a block's shared memory, the one with the least estimated
    time: waves of CTAs over ``gemm.SMS`` SMs times (a slab's
    multiply-adds + ``SLAB_COST``). A tie goes to the larger tile. A pure
    function of shape and dtype: never sees the number of images or the
    device. Memoised: the search takes about 50 µs of host time, and an
    engine calls it for every block of every image."""
    path = ir_path(cin, mid, cout, dtype)
    size = torch.empty(0, dtype=dtype).element_size()
    slabs = -(-mid // IR_SLAB)
    oh, ow = -(-h // stride), -(-w // stride)
    best = None
    for tile in IR_TILES:
        if recompute(tile, stride, r, s) > MAX_RECOMPUTE \
                or acc_blocks(path, tile, cout) > IR_MAX_ACC \
                or ir_smem_bytes(path, size, tile, stride, r, s, cin, cout,
                                 expanded) > MAX_SMEM:
            continue
        ctas = -(-oh // tile) * -(-ow // tile) * slabs
        per_sm = ctas_per_sm(path, size, tile, stride, r, s, cin, cout,
                             expanded)
        work = slab_work(path, tile, stride, r, s, cin, cout, expanded)
        est = -(-ctas // (gemm.SMS * per_sm)) * (work + SLAB_COST)
        if best is None or est < best[0]:
            best = (est, IRPlan(path, tile, slabs))
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
    p = plan(H, W, Cin, mid, Cout, R, S, stride, expanded, dt)
    if p.path == "tensor" and any(
            t.data_ptr() % 16 for t in (x, wdw, w2, *([w1] if expanded
                                                      else []))):
        raise ValueError(f"{name}: the {dt} tensor-core path needs 16-byte "
                         f"aligned x, w1, wdw and w2")
    OH, OW = -(-H // stride), -(-W // stride)
    out = torch.empty((B, OH, OW, Cout), dtype=dt, device=dev)
    ws = gemm.workspace(p.parts, B, OH * OW, Cout, dev)
    err = _build.library().fused_inverted_residual_launch(
        code, x.data_ptr(), *ptrs, wdw.data_ptr(), sdw.data_ptr(),
        bdw.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B, H, W, Cin, mid, Cout, R, S, stride,
        _build.act_code(act), _build.act_code(out_act), int(residual),
        p.tile, ws.data_ptr() if ws is not None else None,
        _build.stream(dev))
    _build.check(err, name)
    fused_inverted_residual.launches += 1
    return out


fused_inverted_residual.launches = 0

