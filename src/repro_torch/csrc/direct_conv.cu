// Direct convolution for sm_90a: the Hopper counterpart of the Pallas
// kernel `direct_conv` in src/repro/kernels/direct_conv.py:51.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = (Hp - R) / stride + 1, stride 1 or 2, and the fused epilogue
// act(acc * scale + bias), converted once on the store.
//
// Direct keeps the structure of the TPU kernel, the paper's
// CONV_CACHE_FILTER: the filter bank is the operand held on chip and the
// pixels stream past it (its index map ignores the pixel axis). That is
// what sets it apart from libdnn (both operands streamed) and from ILP-M
// (the image held). A 3x3x512x512 fp32 bank is 9.4 MB and does not fit a
// block's 227 KB, so the bank is cut into slices:
// - A CTA owns a 64-wide K tile x a contiguous slice of the flattened
//   R*S*C contraction (row (r*S + s)*C + c) x one 64-pixel tile of one
//   image: grid (K tiles x slices x pixel tiles, B). It copies its whole
//   filter slice into shared memory first, with cp.async, in the input's
//   dtype, then gathers its tile's patch rows of the slice chunk by chunk
//   into a double-buffered shared tile (16-byte cp.async runs where C is a
//   multiple of 16 bytes' worth, else predicated scalar loads; the next
//   chunk flies while this one computes) and multiplies them against the
//   resident slice. Each pixel tile's CTA reads its filter slice again,
//   from L2: a CTA walking several tiles past one staged slice was slower
//   at every ResNet-18 class (gemm_sweep.py), as it had fewer CTAs.
// - The Python wrapper's `direct_conv.plan` picks the slices from the
//   shape and dtype alone, never from the batch. With slices > 1 each
//   slice writes its fp32 partial to the workspace (slices, B, H*W, K) and
//   gemm_tile.cuh's `splitk_reduce`, launched by the same call, sums them
//   in slice order, applies the epilogue once and casts once, so run_batch
//   stays bitwise equal to run; with one slice the epilogue runs before
//   the store.
//
// What bounds it on the H100: ResNet-18's convs do 0.12-0.23 GFLOP against
// 1-10 MB a launch, so IEEE fp32 on the CUDA cores (67 TFLOP/s) is bound by
// the operations (forced direct's 20 launches: 0.0541 ms per image) and
// bf16 on the tensor cores by the bytes. The first kernel walked the whole
// contraction in 8-28 CTAs, one scalar global load per 4 FMAs, and ran
// bf16 on the fp32 loop. Now:
// - fp32 (and a 16-bit shape the tensor cores cannot take: the C = 3 stem,
//   ragged C or K): IEEE fmaf, never TF32; 256 threads, each 4 pixels x 4
//   channels, both operands read from shared memory in 16-byte (8-byte)
//   runs, chunks 16 rows deep;
// - bf16 and fp16 where C and K are multiples of 8 and x and w are 16-byte
//   aligned: mma.sync.m16n8k16 with fp32 accumulators, four warps of 32
//   pixels x 32 channels, A from ldmatrix on the gathered patch, B from
//   ldmatrix.trans on the resident slice, chunks 32 deep, rows padded by 16
//   bytes so an ldmatrix phase hits 8 bank groups.
//
// Pixels past H*W, channels past K and the contraction's tail are zero-
// filled by the copies or never stored.
#include "gemm_tile.cuh"

namespace {

constexpr int DTILE = 64;      // output pixels of a tile
constexpr int DTILE_K = 64;    // output channels of a CTA
constexpr int D_F32_THREADS = 256;
constexpr int D_MAX_SMEM = 232448;  // a block's shared-memory limit, sm_90

// Row p of image z: the patch of output pixel (p / W, p % W); column k:
// tap k / C = r * S + s, channel k % C.
template <typename T>
struct StridedPatch {
  const T* base;
  int Hp, Wp, C, S, W, stride;
  __device__ const T* row(int z, int p) const {
    return base + (((size_t)z * Hp + p / W * stride) * Wp +
                   p % W * stride) * C;
  }
  __device__ int col(int k) const {
    const int tap = k / C;
    return (tap / S * Wp + tap % S) * C + (k - tap * C);
  }
};

// One launch's geometry, as the launcher derives it.
struct DirectGeom {
  int HW, K, Kc, batch;
  int chunk, slices, ktiles;
  int depth;     // staged filter rows: the most a slice takes
  bool vec_w;    // 16-byte runs of w's rows
};

// What a CTA works on: its K tile, slice, pixel tile and image.
struct DirectBlock {
  int k0, s, t, z, kb, ke;
};

__device__ __forceinline__ DirectBlock direct_block(const DirectGeom& g) {
  DirectBlock b;
  const int kt = blockIdx.x % g.ktiles;
  const int rest = blockIdx.x / g.ktiles;
  b.s = rest % g.slices;
  b.t = rest / g.slices;
  b.k0 = kt * DTILE_K;
  b.z = blockIdx.y;
  split_range(g.Kc, g.chunk, g.slices, b.s, &b.kb, &b.ke);
  return b;
}

// Copy the CTA's filter slice, rows [kb, ke) of w (Kc, K) at columns
// [k0, k0 + 64), into bs (depth, ld); rows past ke and columns past K are
// zeros. Commits nothing: the first gather's group carries it.
template <typename T, int THREADS>
__device__ __forceinline__ void stage_slice(const DirectGeom& g,
                                            const DirectBlock& b,
                                            const T* w, T* bs, int ld) {
  constexpr int V = 16 / sizeof(T);
  if (g.vec_w) {
    constexpr int RUNS = DTILE_K / V;
    for (int e = threadIdx.x; e < g.depth * RUNS; e += THREADS) {
      const int r = e / RUNS, n = e % RUNS * V;
      const bool ok = b.kb + r < b.ke && b.k0 + n < g.K;
      cp_async16(bs + r * ld + n,
                 ok ? w + (size_t)(b.kb + r) * g.K + b.k0 + n : w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < g.depth * DTILE_K; e += THREADS) {
      const int r = e / DTILE_K, n = e % DTILE_K;
      const bool ok = b.kb + r < b.ke && b.k0 + n < g.K;
      const T* src = ok ? w + (size_t)(b.kb + r) * g.K + b.k0 + n : w;
      if constexpr (sizeof(T) == 4) {
        cp_async4(bs + r * ld + n, src, ok);
      } else {
        bs[r * ld + n] = ok ? *src : ilpm::from_f32<T>(0.f);
      }
    }
  }
}

// The walk over a CTA's chunks, double-buffered: `gather(stage, k0)`
// fills a stage and commits, `chunk(stage, koff)` computes one staged
// chunk (koff: its first row in the slice).
template <typename Gather, typename Chunk>
__device__ __forceinline__ void direct_walk(const DirectGeom& g,
                                            const DirectBlock& b,
                                            Gather gather, Chunk chunk) {
  const int nch = (b.ke - b.kb + g.chunk - 1) / g.chunk;
  gather(0, b.kb);  // its group also holds the filter slice
  for (int c = 0, stage = 0; c < nch; ++c, stage ^= 1) {
    if (c + 1 < nch) {
      gather(stage ^ 1, b.kb + (c + 1) * g.chunk);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait_one();
    __syncthreads();
    chunk(stage, c * g.chunk);
    __syncthreads();
  }
}

// ---- CUDA-core path ---------------------------------------------------

// 256 threads: thread (ty, tx) keeps pixels ty + 16 i (i < 4) of the tile
// and channels k0 + 4 tx + {0..3}. VEC_X: the patch rows are copied in
// 16-byte runs (a compile-time choice).
template <bool VEC_X, typename T, typename Epi>
__global__ void __launch_bounds__(D_F32_THREADS, 2) direct_f32_kernel(
    DirectGeom g, StridedPatch<T> src, const T* __restrict__ w,
    T* __restrict__ out, float* __restrict__ ws, Epi epi) {
  constexpr int BK = F32_CHUNK;
  constexpr int V = 16 / sizeof(T);
  constexpr int A_LD = BK + V;  // rows padded by 16 bytes
  constexpr int A_STAGE = DTILE * A_LD;
  extern __shared__ __align__(16) unsigned char direct_smem[];
  T* as = reinterpret_cast<T*>(direct_smem);  // [2][64][A_LD]
  T* bs = as + 2 * A_STAGE;                   // [depth][64]
  const DirectBlock b = direct_block(g);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* a0 = src.base;  // any valid address, for a zero fill

  // the rows and column of the patch this thread copies: VEC_X, one
  // 16-byte run (row tid / (BK / V), column (tid % (BK / V)) * V; threads
  // past 64 rows copy none); else 4 rows (tid / BK + 16 i) of column
  // tid % BK
  constexpr int A_PER_ROW = BK / V;
  constexpr int NROWS = VEC_X ? 1 : 4;
  const int r0 = VEC_X ? tid / A_PER_ROW : tid / BK;
  const int kq = VEC_X ? tid % A_PER_ROW * V : tid % BK;
  const T* rows[NROWS];
#pragma unroll
  for (int i = 0; i < NROWS; ++i) {
    const int p = b.t * DTILE + r0 + 16 * i;
    rows[i] = r0 + 16 * i < DTILE && p < g.HW ? src.row(b.z, p) : nullptr;
  }

  auto gather = [&](int stage, int k0) {
    T* dst = as + stage * A_STAGE;
    const bool kin = k0 + kq < b.ke;
    const int off = kin ? src.col(k0 + kq) : 0;
    if constexpr (VEC_X) {
      if (r0 < DTILE) {
        const bool ok = kin && rows[0] != nullptr;
        cp_async16(dst + r0 * A_LD + kq, ok ? rows[0] + off : a0, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NROWS; ++i) {
        const bool ok = kin && rows[i] != nullptr;
        T* d = dst + (r0 + 16 * i) * A_LD + kq;
        if constexpr (sizeof(T) == 4) {
          cp_async4(d, ok ? rows[i] + off : a0, ok);
        } else {
          *d = ok ? rows[i][off] : ilpm::from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto chunk = [&](int stage, int koff) {
    const T* at = as + stage * A_STAGE;
    const T* bt = bs + koff * DTILE_K + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[4][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(at + (ty + 16 * i) * A_LD + kk, av[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(bt + (kk + q) * DTILE_K, bv[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
    }
  };

  stage_slice<T, D_F32_THREADS>(g, b, w, bs, DTILE_K);
  direct_walk(g, b, gather, chunk);

  const int n = b.k0 + 4 * tx;
  const int valid = min(4, g.K - n);
  const bool vec_c = g.K % 4 == 0;
  const size_t total = (size_t)g.batch * g.HW * g.K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = b.t * DTILE + ty + 16 * i;
    if (valid <= 0 || p >= g.HW) continue;
    const size_t o = ((size_t)b.z * g.HW + p) * g.K + n;
    if (g.slices > 1) {
      store4(ws + b.s * total + o, acc[i], valid, vec_c);
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = j < valid ? epi(acc[i][j], n + j, o + j) : 0.f;
      store4(out + o, v, valid, vec_c);
    }
  }
}

// ---- tensor-core path (bf16 / fp16) -------------------------------------

// Four warps in 2 x 2, each 32 pixels x 32 channels of the tile.
template <typename T, typename Epi>
__global__ void __launch_bounds__(TC_THREADS) direct_tc_kernel(
    DirectGeom g, StridedPatch<T> src, const T* __restrict__ w,
    T* __restrict__ out, float* __restrict__ ws, Epi epi) {
  constexpr int BK = TC_CHUNK;
  constexpr int A_LD = BK + 8;        // 80-byte rows: 8 rows, 8 bank groups
  constexpr int B_LD = DTILE_K + 8;   // 144-byte rows
  constexpr int A_STAGE = DTILE * A_LD;
  constexpr int MI = 2, NI = 4;
  constexpr int A_PER_ROW = BK / 8;
  constexpr int A_RUNS = DTILE * A_PER_ROW / TC_THREADS;
  constexpr int step = TC_THREADS / A_PER_ROW;
  extern __shared__ __align__(16) unsigned char direct_smem[];
  T* as = reinterpret_cast<T*>(direct_smem);  // [2][64][A_LD]
  T* bs = as + 2 * A_STAGE;                   // [depth][B_LD]
  const DirectBlock b = direct_block(g);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const T* a0 = src.base;
  const int r0 = tid / A_PER_ROW, kq = tid % A_PER_ROW * 8;
  const T* rows[A_RUNS];
#pragma unroll
  for (int i = 0; i < A_RUNS; ++i) {
    const int p = b.t * DTILE + r0 + i * step;
    rows[i] = p < g.HW ? src.row(b.z, p) : nullptr;
  }

  auto gather = [&](int stage, int k0) {
    T* dst = as + stage * A_STAGE;
    const bool kin = k0 + kq < b.ke;
    const int off = kin ? src.col(k0 + kq) : 0;
#pragma unroll
    for (int i = 0; i < A_RUNS; ++i) {
      const bool ok = kin && rows[i] != nullptr;
      cp_async16(dst + (r0 + i * step) * A_LD + kq, ok ? rows[i] + off : a0,
                 ok);
    }
    cp_async_commit();
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto chunk = [&](int stage, int koff) {
    const T* at = as + stage * A_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], at + (wm * 32 + 16 * i + lane % 16) * A_LD + ks +
                               lane / 16 * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (koff + ks + lane % 16) * B_LD + wn * 32 +
                                 8 * j + lane / 16 * 8);
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma16816<T>(acc[i][j], af[i], bf[j]);
    }
  };

  stage_slice<T, TC_THREADS>(g, b, w, bs, B_LD);
  direct_walk(g, b, gather, chunk);

  // accumulator q of tile (i, j): pixel row lane/4 (+8 for q >= 2),
  // channels 2 (lane % 4) + {0, 1}
  const size_t total = (size_t)g.batch * g.HW * g.K;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = b.t * DTILE + wm * 32 + 16 * i + lane / 4 + 8 * h;
      if (p >= g.HW) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = b.k0 + wn * 32 + 8 * j + 2 * (lane % 4);
        if (n >= g.K) continue;  // K % 8 == 0: both channels or neither
        const size_t o = ((size_t)b.z * g.HW + p) * g.K + n;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (g.slices > 1) {
          *reinterpret_cast<float2*>(ws + b.s * total + o) =
              make_float2(v0, v1);
        } else {
          uint32_t u;
          T* tt = reinterpret_cast<T*>(&u);
          tt[0] = ilpm::from_f32<T>(epi(v0, n, o));
          tt[1] = ilpm::from_f32<T>(epi(v1, n + 1, o + 1));
          *reinterpret_cast<uint32_t*>(out + o) = u;
        }
      }
    }
}

// ---- the launch ----------------------------------------------------------

// Shared memory of one CTA: two stages of the gathered patch tile and the
// resident filter slice, each row padded as the path pads it.
template <typename T>
size_t direct_smem_bytes(bool tensor, int depth) {
  constexpr int V = 16 / sizeof(T);
  if (tensor)
    return sizeof(T) * ((size_t)2 * DTILE * (TC_CHUNK + 8) +
                        (size_t)depth * (DTILE_K + 8));
  return sizeof(T) * ((size_t)2 * DTILE * (F32_CHUNK + V) +
                      (size_t)depth * DTILE_K);
}

template <typename T, typename Kern>
cudaError_t launch_kernel(Kern kern, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const DirectGeom& g,
                          const StridedPatch<T>& src, const T* w, T* out,
                          float* ws, const ScaleBiasAct& epi) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(g, src, w, out, ws, epi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_direct(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int R, int S, int K, int H, int W,
                          int stride, int act, int tile, int slices,
                          void* ws, cudaStream_t stream) {
  if (!x || !w || !scale || !bias || !out || B < 1 || B > 65535 || C < 1 ||
      R < 1 || S < 1 || K < 1 || H < 1 || W < 1 || stride < 1 ||
      (H - 1) * stride + R > Hp || (W - 1) * stride + S > Wp ||
      tile != DTILE)
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  DirectGeom g;
  g.HW = H * W; g.K = K; g.Kc = R * S * C; g.batch = B;
  const bool vec_x = C % V == 0 && aligned16(x);
  g.vec_w = K % V == 0 && aligned16(w);
  const bool tensor = sizeof(T) == 2 && C % 8 == 0 && K % 8 == 0 &&
                      aligned16(x) && aligned16(w);
  g.chunk = tensor ? TC_CHUNK : F32_CHUNK;
  const int chunks = (g.Kc + g.chunk - 1) / g.chunk;
  g.ktiles = (K + DTILE_K - 1) / DTILE_K;
  const int tiles = (g.HW + DTILE - 1) / DTILE;
  if (slices < 1 || slices > chunks ||
      (slices > 1 && (!ws || !aligned16(ws))))
    return cudaErrorInvalidValue;
  g.slices = slices;
  g.depth = (chunks + slices - 1) / slices * g.chunk;
  const size_t smem = direct_smem_bytes<T>(tensor, g.depth);
  const long long ctas = (long long)g.ktiles * slices * tiles;
  if (smem > (size_t)D_MAX_SMEM || ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas, B);
  const StridedPatch<T> src{static_cast<const T*>(x), Hp, Wp, C, S, W,
                            stride};
  const ScaleBiasAct epi{static_cast<const float*>(scale),
                         static_cast<const float*>(bias), act};
  const T* tw = static_cast<const T*>(w);
  T* tout = static_cast<T*>(out);
  float* fws = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (tensor) {
    if constexpr (sizeof(T) == 2)
      err = launch_kernel(direct_tc_kernel<T, ScaleBiasAct>, grid,
                          TC_THREADS, smem, stream, g, src, tw, tout, fws,
                          epi);
  } else if (vec_x) {
    err = launch_kernel(direct_f32_kernel<true, T, ScaleBiasAct>, grid,
                        D_F32_THREADS, smem, stream, g, src, tw, tout, fws,
                        epi);
  } else {
    err = launch_kernel(direct_f32_kernel<false, T, ScaleBiasAct>, grid,
                        D_F32_THREADS, smem, stream, g, src, tw, tout, fws,
                        epi);
  }
  if (err != cudaSuccess || slices == 1) return err;
  return launch_splitk_reduce(fws, tout, (size_t)B * g.HW * K, K, slices,
                              epi, stream);
}

}  // namespace

// tile: output pixels of a tile (64); slices: contraction slices (1 to the
// number of chunks of the path: 16 rows on the CUDA cores, 32 on the
// tensor cores); ws: the fp32 workspace (slices, B, H*W, K) where
// slices > 1. The tensor cores
// take a 16-bit x where C and K are multiples of 8 and x and w are
// 16-byte aligned.
extern "C" int direct_conv_launch(int dtype, const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int Hp, int Wp, int C,
                                  int R, int S, int K, int H, int W,
                                  int stride, int act, int tile, int slices,
                                  void* ws, void* stream) {
  if (act < ilpm::ACT_NONE || act > ilpm::ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_direct<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                   S, K, H, W, stride, act, tile, slices,
                                   ws,
                                   static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
