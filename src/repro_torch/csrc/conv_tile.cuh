// The halo-resident, split conv tile that ilpm_conv.cu and
// fused_residual_conv.cu share: out (B, H, W, K) = epilogue(conv(x_padded,
// w, stride)), x_padded (B, Hp, Wp, C) NHWC, w (R, S, C, K) HWIO,
// accumulated in fp32, in the dtype T of x.
//
// It replaces the Pallas kernels `ilpm_conv` (src/repro/kernels/
// ilpm_conv.py:59) and `fused_residual_conv` (src/repro/kernels/
// fused_block.py:234), and keeps their ILP-M idea: a CTA stages a halo'd
// input tile once per channel chunk and reads every one of the R*S taps of
// that chunk from shared memory, as shifted (at stride 2, strided) windows
// of the staged tile, against a 64-channel filter slab. libdnn regathers
// each tap's patch from device memory for every K tile; here each input
// element leaves device memory once per K slab, and the patch is never
// built.
//
// What bounds it on the H100. ResNet-18's 3x3 layers do 0.12-0.23 GFLOP
// over 1-10 MB a launch: in IEEE fp32 on the CUDA cores (67 TFLOP/s) the
// operations bound them (the tuned path's 9 ilpm and 8 fused launches:
// 0.0260 and 0.0276 ms per image), in bf16 on the tensor cores the bytes.
// What held the first tile back: one CTA of 8x8 pixels x 64 channels of
// one image walked the whole C*R*S contraction alone (8 CTAs at 7², 16 at
// 14² for 132 SMs), staged every element by a scalar load converted to
// fp32 with no overlap of staging and compute, and ran bf16 on the CUDA
// cores. The design:
// - Split. A CTA owns 8x8 output pixels, 64 output channels, one image and
//   one part of the contraction: a range of channel chunks (`split`, a
//   power of two) and a range of filter rows (`rsplit`, where chunks alone
//   cannot fill the card). The Python wrapper's `ilpm_conv.plan` picks
//   them from the shape and dtype alone, never from the batch. Part p
//   writes its fp32 partial tile to the workspace (parts, B, H*W, K);
//   gemm_tile.cuh's `splitk_reduce`, launched by the same call, sums the
//   parts in order 0..parts-1, applies the epilogue once and casts once,
//   so run_batch stays bitwise equal to run. With one part the epilogue
//   runs in registers before the store.
// - Staging. A chunk (the halo'd tile of `chunk` channels and the filter
//   rows of its taps) is copied with cp.async in 16-byte runs where C (for
//   x) and K (for w) allow it, else element by element (4-byte cp.async
//   for fp32, batched loads for 16-bit types), in the input's dtype;
//   chunks are double-buffered, so the next chunk's copies fly while this
//   one's taps run. A halo row keeps the columns of one stride phase
//   together (column x at (x % stride) * half + x / stride), so the 8
//   pixels of an output row are 8 consecutive staged pixels at either
//   stride. The copies and the tap walk divide by no runtime value (a
//   chunk is a power of two, a thread walks the tile row by row): the
//   C = 3 stems, 27-147 products a pixel, leave the integer work exposed.
// - CUDA-core path (fp32, and any 16-bit shape the tensor cores cannot
//   take: C = 3 stems, ragged C or K): IEEE fmaf, never TF32. 128 threads,
//   each 8 pixels (one output column of the tile) x 4 channels; a tap's 4
//   channels of a pixel are one 16-byte (8-byte) shared load, broadcast
//   across the 8 threads of a load phase.
// - Tensor-core path (bf16, fp16; C and K multiples of 8, x and w 16-byte
//   aligned): mma.sync.m16n8k16 with fp32 accumulators, four warps of 32
//   pixels x 32 channels. The A fragments come from ldmatrix, each lane's
//   row address pointing at its pixel's shifted position in the staged
//   tile; staged pixels are padded to an odd number of 16-byte units, so
//   an ldmatrix phase (8 consecutive staged pixels) hits 8 bank groups.
//   The filter slab is read by ldmatrix.trans from rows padded likewise.
//   mma.sync, not wgmma: at these sizes the bytes bound the 16-bit convs.
//
// Pixels past H or W, channels past C or K and filter rows past R are
// zero-filled by the copies or never stored. Everything here has internal
// linkage, as in gemm_tile.cuh, whose primitives it uses.
#pragma once

#include "gemm_tile.cuh"

namespace {

constexpr int CONV_TILE = 8;       // output pixels per CTA: 8 x 8
constexpr int CONV_TILE_K = 64;    // output channels per CTA
constexpr int CONV_THREADS = 128;  // four warps, both paths
constexpr int CONV_TC_PAD = 8;     // tensor cores: elements padding a row
constexpr int MAX_SMEM = 232448;   // a block's shared-memory limit on sm_90

// The residual block's tail: act(T(v * scale[n] + bias[n]) + res[i]), the
// folded-BN result converted to T first, then the shortcut added, then the
// activation, as the reference's unfused act(conv(x) + identity) does.
template <typename T>
struct ScaleBiasRes {
  const float* scale;
  const float* bias;
  const T* res;
  int act;
  __device__ float operator()(float v, int n, size_t i) const {
    const float y = fmaf(v, scale[n], bias[n]);
    return ilpm::apply_act(ilpm::to_f32(ilpm::from_f32<T>(y)) +
                               ilpm::to_f32(res[i]),
                           act);
  }
};

// One launch's geometry, as the launcher derives it.
struct ConvGeom {
  int Hp, Wp, C, R, S, K, H, W, stride, batch;
  int chunk;     // channels per chunk, a power of two
  int lchunk;    // log2(chunk)
  int pix_ld;    // staged elements per pixel: chunk (+ CONV_TC_PAD)
  int b_ld;      // staged elements per filter row: 64 (+ CONV_TC_PAD)
  int split;     // channel-chunk splits
  int rsplit;    // filter-row splits
  int IW, half, IWp;  // halo columns; stored columns per stride phase, all
  int tiles_w;
  int halo_elems;     // per stage, a multiple of 16 bytes
  int stage_elems;
  bool vec_x, vec_w;  // 16-byte runs of x's channels, of w's rows
};

// The filter rows [*r0, *r0 + *nr) of row split sr.
__device__ __forceinline__ void row_range(const ConvGeom& g, int sr, int* r0,
                                          int* nr) {
  *r0 = sr * g.R / g.rsplit;
  *nr = (sr + 1) * g.R / g.rsplit - *r0;
}

// Where a halo row stores input column x: each stride phase's columns
// together.
__device__ __forceinline__ int phase_col(const ConvGeom& g, int x) {
  if (g.stride == 1) return x;
  if (g.stride == 2) return (x & 1) * g.half + (x >> 1);
  return x % g.stride * g.half + x / g.stride;
}

// A thread's walk over a (rows, L) array, CONV_THREADS elements a step
// from element threadIdx.x: one division to start, none after.
struct RowWalk {
  int row, j, L;
  __device__ explicit RowWalk(int L_) : L(L_) {
    row = threadIdx.x / L;
    j = threadIdx.x - row * L;
  }
  __device__ void step() {
    j += CONV_THREADS;
    while (j >= L) {
      j -= L;
      ++row;
    }
  }
};

// Element-by-element copies through registers, CONV_BATCH loads a thread
// in flight: `at(e, &src, &dst)` names element e's source (null: a zero)
// and destination; e = threadIdx.x, + CONV_THREADS, ... in order.
constexpr int CONV_BATCH = 8;
template <typename T, typename At>
__device__ __forceinline__ void scalar_copy(int n, At at) {
  for (int e0 = threadIdx.x; e0 < n; e0 += CONV_BATCH * CONV_THREADS) {
    T v[CONV_BATCH];
    T* dst[CONV_BATCH];
#pragma unroll
    for (int u = 0; u < CONV_BATCH; ++u) {
      const int e = e0 + u * CONV_THREADS;
      const T* src = nullptr;
      dst[u] = nullptr;
      if (e < n) at(e, &src, &dst[u]);
      v[u] = src ? *src : ilpm::from_f32<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < CONV_BATCH; ++u)
      if (dst[u]) *dst[u] = v[u];
  }
}

// Copy one chunk (channels [c0, c0 + chunk)) into a stage: the halo'd tile
// of input rows [ih0, ih0 + IH) and columns [iw0, iw0 + IW), then the
// filter rows of taps (r0 .. r0 + nr - 1, 0 .. S - 1) for output channels
// [k0, k0 + 64); commits one cp.async group. Where x has no aligned
// 16-byte runs its elements are copied one by one: 4-byte cp.async for
// fp32, batched loads for 16-bit types.
template <typename T>
__device__ __forceinline__ void conv_stage(const ConvGeom& g, const T* xb,
                                           const T* w, T* halo, int c0,
                                           int r0, int nr, int ih0, int iw0,
                                           int k0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LV = V == 4 ? 2 : 3;  // log2(V)
  const int IH = (CONV_TILE - 1) * g.stride + nr;
  T* bs = halo + g.halo_elems;
  // the halo as (IH, IW << lq) units: 16-byte runs or single elements
  const int lq = g.vec_x ? g.lchunk - LV : g.lchunk;
  const int n_x = IH * (g.IW << lq);
  RowWalk it(g.IW << lq);
  // the walk's current unit: its staged address, and its source (null
  // past the image or past C)
  auto unit = [&](T** dst) -> const T* {
    const int hx = it.j >> lq, q = it.j & ((1 << lq) - 1);
    const int c = g.vec_x ? q * V : q;
    const int gy = ih0 + it.row, gx = iw0 + hx;
    *dst = halo + (it.row * g.IWp + phase_col(g, hx)) * g.pix_ld + c;
    return gy < g.Hp && gx < g.Wp && c0 + c < g.C
               ? xb + ((size_t)gy * g.Wp + gx) * g.C + c0 + c
               : nullptr;
  };
  if (g.vec_x || sizeof(T) == 4) {
    for (int e = threadIdx.x; e < n_x; e += CONV_THREADS, it.step()) {
      T* dst;
      const T* src = unit(&dst);
      if (g.vec_x)
        cp_async16(dst, src ? src : xb, src != nullptr);
      else
        cp_async4(dst, src ? src : xb, src != nullptr);
    }
  } else {
    scalar_copy<T>(n_x, [&](int, const T** src, T** dst) {
      *src = unit(dst);
      it.step();
    });
  }
  // the taps of rows r0.. are contiguous in w: staged row t * chunk + c is
  // w row (r0 * S + t) * C + c0 + c
  const int rows = nr * g.S << g.lchunk;
  if (g.vec_w) {
    constexpr int RUNS = CONV_TILE_K / V;
    for (int e = threadIdx.x; e < rows * RUNS; e += CONV_THREADS) {
      const int n = e % RUNS * V, row = e / RUNS;
      const int c = row & (g.chunk - 1), t = row >> g.lchunk;
      const bool ok = c0 + c < g.C && k0 + n < g.K;
      cp_async16(bs + row * g.b_ld + n,
                 ok ? w + ((size_t)(r0 * g.S + t) * g.C + c0 + c) * g.K +
                          k0 + n
                    : w,
                 ok);
    }
  } else {
    scalar_copy<T>(rows * CONV_TILE_K, [&](int e, const T** src, T** dst) {
      const int n = e % CONV_TILE_K, row = e / CONV_TILE_K;
      const int c = row & (g.chunk - 1), t = row >> g.lchunk;
      if (c0 + c < g.C && k0 + n < g.K)
        *src = w + ((size_t)(r0 * g.S + t) * g.C + c0 + c) * g.K + k0 + n;
      *dst = bs + row * g.b_ld + n;
    });
  }
  cp_async_commit();
}

// f(t, toff) for each tap t = (r - r0) * S + s of rows r0 .. r0 + nr - 1,
// toff its staged offset from its pixel's, in elements.
template <typename F>
__device__ __forceinline__ void for_each_tap(const ConvGeom& g, int nr,
                                             F f) {
  int t = 0;
  for (int r = 0; r < nr; ++r) {
    int sp = 0, sq = 0;  // s % stride, s / stride
    for (int s = 0; s < g.S; ++s, ++t) {
      f(t, (r * g.IWp + sp * g.half + sq) * g.pix_ld);
      if (++sp == g.stride) {
        sp = 0;
        ++sq;
      }
    }
  }
}

// What a CTA works on: its output tile, channel slab, image and part.
struct ConvBlock {
  int oh0, ow0, k0, z, part, cb, ce, r0, nr;
};

__device__ __forceinline__ ConvBlock conv_block(const ConvGeom& g) {
  ConvBlock b;
  b.oh0 = blockIdx.x / g.tiles_w * CONV_TILE;
  b.ow0 = blockIdx.x % g.tiles_w * CONV_TILE;
  b.k0 = blockIdx.y * CONV_TILE_K;
  const int parts = g.split * g.rsplit;
  b.z = blockIdx.z / parts;
  b.part = blockIdx.z % parts;
  split_range(g.C, g.chunk, g.split, b.part / g.rsplit, &b.cb, &b.ce);
  row_range(g, b.part % g.rsplit, &b.r0, &b.nr);
  return b;
}

// Walk the CTA's chunks, double-buffered: `taps(stage)` runs one staged
// chunk.
template <typename T, typename Taps>
__device__ __forceinline__ void conv_main_loop(const ConvGeom& g,
                                               const ConvBlock& b,
                                               const T* x, const T* w,
                                               T* smem, Taps taps) {
  const T* xb = x + (size_t)b.z * g.Hp * g.Wp * g.C;
  const int ih0 = b.oh0 * g.stride + b.r0, iw0 = b.ow0 * g.stride;
  conv_stage(g, xb, w, smem, b.cb, b.r0, b.nr, ih0, iw0, b.k0);
  for (int c0 = b.cb, st = 0; c0 < b.ce; c0 += g.chunk, st ^= 1) {
    if (c0 + g.chunk < b.ce) {
      conv_stage(g, xb, w, smem + (st ^ 1) * g.stage_elems, c0 + g.chunk,
                 b.r0, b.nr, ih0, iw0, b.k0);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait_one();
    __syncthreads();
    taps(smem + st * g.stage_elems);
    __syncthreads();
  }
}

// ---- CUDA-core path ---------------------------------------------------

template <typename T, typename Epi>
__global__ void __launch_bounds__(CONV_THREADS) conv_f32_kernel(
    ConvGeom g, const T* __restrict__ x, const T* __restrict__ w,
    T* __restrict__ out, float* __restrict__ ws, Epi epi) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const ConvBlock b = conv_block(g);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels k0 + 4 tx + {0..3}
  const int ty = tid / 16;  // pixels (i, ty) of the tile, i = 0..7
  int aoff[CONV_TILE];
#pragma unroll
  for (int i = 0; i < CONV_TILE; ++i)
    aoff[i] = (i * g.stride * g.IWp + ty) * g.pix_ld;
  float acc[CONV_TILE][4];
#pragma unroll
  for (int i = 0; i < CONV_TILE; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  conv_main_loop(g, b, x, w, reinterpret_cast<T*>(conv_smem),
                 [&](const T* halo) {
    const T* bs = halo + g.halo_elems + 4 * tx;
    for_each_tap(g, b.nr, [&](int t, int toff) {
      const T* xt = halo + toff;
      const T* bt = bs + t * g.chunk * g.b_ld;
      for (int c = 0; c < g.chunk; c += 4) {
        float av[CONV_TILE][4], bv[4][4];
#pragma unroll
        for (int i = 0; i < CONV_TILE; ++i) load4(xt + aoff[i] + c, av[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(bt + (c + q) * g.b_ld, bv[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < CONV_TILE; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
      }
    });
  });

  const int n = b.k0 + 4 * tx;
  const int valid = min(4, g.K - n);
  if (valid <= 0) return;
  const bool vec = g.K % 4 == 0;
  const size_t total = (size_t)g.batch * g.H * g.W * g.K;
#pragma unroll
  for (int i = 0; i < CONV_TILE; ++i) {
    const int oh = b.oh0 + i, ow = b.ow0 + ty;
    if (oh >= g.H || ow >= g.W) continue;
    const size_t o = (((size_t)b.z * g.H + oh) * g.W + ow) * g.K + n;
    if (g.split * g.rsplit > 1) {
      store4(ws + b.part * total + o, acc[i], valid, vec);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = j < valid ? epi(acc[i][j], n + j, o + j) : 0.f;
      store4(out + o, v, valid, vec);
    }
  }
}

// ---- tensor-core path (bf16 / fp16) -------------------------------------

template <typename T, typename Epi>
__global__ void __launch_bounds__(CONV_THREADS) conv_tc_kernel(
    ConvGeom g, const T* __restrict__ x, const T* __restrict__ w,
    T* __restrict__ out, float* __restrict__ ws, Epi epi) {
  constexpr int MI = 2, NI = 4;  // a warp: 2 x 16 pixels, 4 x 8 channels
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const ConvBlock b = conv_block(g);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  // this lane's ldmatrix row of m tile i: tile pixel wm*32 + 16 i + lane%16,
  // channels (lane / 16) * 8 on
  int aoff[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int p = wm * 32 + 16 * i + lane % 16;
    aoff[i] = (p / CONV_TILE * g.stride * g.IWp + p % CONV_TILE) * g.pix_ld +
              lane / 16 * 8;
  }
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  conv_main_loop(g, b, x, w, reinterpret_cast<T*>(conv_smem),
                 [&](const T* halo) {
    const T* bs = halo + g.halo_elems + (lane % 16) * g.b_ld + wn * 32 +
                  lane / 16 * 8;
    for_each_tap(g, b.nr, [&](int t, int toff) {
      const T* xt = halo + toff;
      const T* bt = bs + t * g.chunk * g.b_ld;
      for (int ks = 0; ks < g.chunk; ks += 16) {
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], xt + aoff[i] + ks);
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, bt + ks * g.b_ld + 8 * j);
          bf[j][0] = r[0]; bf[j][1] = r[1];
          bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma16816<T>(acc[i][j], af[i], bf[j]);
      }
    });
  });

  // accumulator q of tile (i, j): pixel row lane/4 (+8 for q >= 2),
  // channels 2 (lane % 4) + {0, 1}
  const bool split = g.split * g.rsplit > 1;
  const size_t total = (size_t)g.batch * g.H * g.W * g.K;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * 32 + 16 * i + lane / 4 + 8 * h;
      const int oh = b.oh0 + p / CONV_TILE, ow = b.ow0 + p % CONV_TILE;
      if (oh >= g.H || ow >= g.W) continue;
      const size_t pix = ((size_t)b.z * g.H + oh) * g.W + ow;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = b.k0 + wn * 32 + 8 * j + 2 * (lane % 4);
        if (n >= g.K) continue;  // K % 8 == 0: both channels or neither
        const size_t o = pix * g.K + n;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (split) {
          *reinterpret_cast<float2*>(ws + b.part * total + o) =
              make_float2(v0, v1);
        } else {
          uint32_t u;
          T* t = reinterpret_cast<T*>(&u);
          t[0] = ilpm::from_f32<T>(epi(v0, n, o));
          t[1] = ilpm::from_f32<T>(epi(v1, n + 1, o + 1));
          *reinterpret_cast<uint32_t*>(out + o) = u;
        }
      }
    }
}

// ---- the launch ----------------------------------------------------------

// Validate and launch one conv: the main kernel on the tensor cores (T
// 16-bit, C and K multiples of 8, x and w 16-byte aligned) or the CUDA
// cores, then, where the contraction is split, the reduction. tile: the
// output tile's side (8); chunk: channels per chunk (4, 8 or 16 on the
// CUDA cores, 16 or 32 on the tensor cores); split: channel-chunk splits
// (a power of two, at most 16, at most the number of chunks); rsplit:
// filter-row splits (1 to R); ws: the fp32 workspace (split * rsplit, B,
// H*W, K) where split * rsplit > 1.
template <typename T, typename Epi>
cudaError_t launch_conv_tile(const void* x, const void* w, void* out,
                             void* ws, int B, int Hp, int Wp, int C, int R,
                             int S, int K, int H, int W, int stride,
                             int tile, int chunk, int split, int rsplit,
                             const Epi& epi, cudaStream_t stream) {
  if (!x || !w || !out || B < 1 || C < 1 || R < 1 || S < 1 || K < 1 ||
      H < 1 || W < 1 || stride < 1 || (H - 1) * stride + R > Hp ||
      (W - 1) * stride + S > Wp || tile != CONV_TILE)
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  ConvGeom g;
  g.Hp = Hp; g.Wp = Wp; g.C = C; g.R = R; g.S = S; g.K = K; g.H = H;
  g.W = W; g.stride = stride; g.batch = B;
  g.vec_w = K % V == 0 && aligned16(w);
  const bool tensor =
      sizeof(T) == 2 && C % 8 == 0 && K % 8 == 0 && aligned16(x) &&
      aligned16(w);
  const bool chunk_ok = tensor ? (chunk == 16 || chunk == 32)
                               : (chunk == 4 || chunk == 8 || chunk == 16);
  const int chunks = (C + chunk - 1) / chunk;
  const int parts = split * rsplit;
  if (!chunk_ok || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) || split > chunks || rsplit < 1 || rsplit > R ||
      (parts > 1 && (!ws || !aligned16(ws))))
    return cudaErrorInvalidValue;
  g.chunk = chunk; g.split = split; g.rsplit = rsplit;
  g.lchunk = chunk == 4 ? 2 : chunk == 8 ? 3 : chunk == 16 ? 4 : 5;
  g.vec_x = C % V == 0 && chunk % V == 0 && aligned16(x);
  g.pix_ld = tensor ? chunk + CONV_TC_PAD : chunk;
  g.b_ld = tensor ? CONV_TILE_K + CONV_TC_PAD : CONV_TILE_K;
  const int nr = (R + rsplit - 1) / rsplit;  // the most rows a part takes
  const int IH = (CONV_TILE - 1) * stride + nr;
  g.IW = (CONV_TILE - 1) * stride + S;
  g.half = (g.IW + stride - 1) / stride;
  g.IWp = g.half * stride;
  g.tiles_w = (W + CONV_TILE - 1) / CONV_TILE;
  g.halo_elems = (IH * g.IWp * g.pix_ld + V - 1) / V * V;
  g.stage_elems = g.halo_elems + nr * S * chunk * g.b_ld;
  const int stages = (chunks + split - 1) / split > 1 ? 2 : 1;
  const size_t smem = (size_t)stages * g.stage_elems * sizeof(T);
  const long long tiles =
      (long long)((H + CONV_TILE - 1) / CONV_TILE) * g.tiles_w;
  if (smem > (size_t)MAX_SMEM || tiles > 0x7fffffffLL ||
      (K + CONV_TILE_K - 1) / CONV_TILE_K > 65535 ||
      (long long)B * parts > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (K + CONV_TILE_K - 1) / CONV_TILE_K,
                  B * parts);
  const T* tx = static_cast<const T*>(x);
  const T* tw = static_cast<const T*>(w);
  T* tout = static_cast<T*>(out);
  float* fws = static_cast<float*>(ws);
  cudaError_t err;
  if (tensor) {
    if constexpr (sizeof(T) == 2) {
      auto kern = conv_tc_kernel<T, Epi>;
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kern<<<grid, CONV_THREADS, smem, stream>>>(g, tx, tw, tout, fws, epi);
    }
  } else {
    auto kern = conv_f32_kernel<T, Epi>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, CONV_THREADS, smem, stream>>>(g, tx, tw, tout, fws, epi);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  return launch_splitk_reduce(fws, tout, (size_t)B * H * W * K, K, parts,
                              epi, stream);
}

}  // namespace
