// The split-K GEMM tile that gemm.cu, pointwise_conv.cu and libdnn_conv.cu
// share: c (batch, M, N) = epilogue(A @ b), accumulated in fp32, in the
// dtype T of A.
//
// The three kernels differ only in two things, the template arguments:
// - an A-row source, which says where element (m, k) of A lies for image
//   z: at `base[row(z, m) + col(k)]`, `row` the offset of (m, 0) and
//   `col` that of column k from it. A plain matrix (gemm), the pixel
//   x[oh*s, ow*s, :] of a 1x1 conv (pointwise) or the patch of a pixel
//   gathered from a padded image (libdnn) are all rows of A. The caller
//   says whether a 16-byte run of A that starts at a multiple of 16
//   bytes' worth of columns is contiguous and aligned (`vec_a`): then it
//   is one cp.async, else each element is a predicated scalar load;
// - an epilogue applied to the fp32 sum of each output, with its column:
//   identity for gemm, act(fmaf(v, scale[n], bias[n])) for the convs.
//
// What bounds these products on the H100, and what the tile does about
// it. The layers of ResNet-18 and MobileNetV2 are products of 0.01-0.23
// GFLOP over 0.1-10 MB: in IEEE fp32 on the CUDA cores (67 TFLOP/s) the
// operations bound the deep ones, in bf16 on the tensor cores the bytes
// do. What held the first kernels back was the grid: one CTA per 64 x 64
// tile of c walking the whole contraction leaves 3-16 CTAs for 132 SMs at
// the 7² and 14² layers, whose contractions are 160-4608 deep. So:
// - Split-K. A CTA owns a 64 x 64 tile of c and one split of the
//   contraction; the Python wrapper's `gemm.plan` picks `split`, a power
//   of two up to 16, from the product's shape and dtypes alone, never
//   from the batch. Split s walks chunks [s*chunks/split,
//   (s+1)*chunks/split) and writes its fp32 partial tile to the
//   workspace (split, batch, M, N); `splitk_reduce`, launched by the same
//   call, sums the splits in order 0..split-1 in fp32, applies the
//   epilogue once and casts once. The result does not depend on the
//   batch, so run_batch stays bitwise equal to run. With split = 1 the
//   main kernel applies the epilogue on its store.
// - Slab splits (`slabs`, the fp32 pointwise conv): split s takes the
//   contraction's channels [s*SLAB, (s+1)*SLAB), any number of splits.
//   Each SLAB-channel slab is then one fmaf chain from 0 and the
//   reduction folds the slabs left to right: the order in which
//   fused_inverted_residual.cu sums its expand and its project, so the
//   per-layer and the fused MobileNetV2 agree to the bit in fp32.
// - CUDA-core path (`tile_f32_kernel`): IEEE fmaf in contraction order,
//   never TF32. 64 threads, each keeping 8 x 8 fp32 accumulators (rows
//   ty + 8 i, columns 4 tx + {0..3} and 32 + 4 tx + {0..3}); A and b
//   chunks 16 deep are double-buffered with cp.async. A's rows are padded
//   by 16 bytes so a warp's row reads fall on distinct banks. Each thread
//   copies the same columns of a fixed set of rows in every chunk, so it
//   asks the source for its rows once, before the main loop (16-byte
//   runs; the scalar loads of a shape that has none ask once a chunk),
//   and for one column offset a chunk: the gather's index math (libdnn's
//   divisions) costs a few instructions a chunk, not one a load. b is
//   fp32 (gemm), or in T (a 16-bit conv whose shape the tensor cores
//   cannot take: converted to fp32 as it is read from shared memory).
// - Tensor-core path (`tile_tc_kernel`, bf16 and fp16): mma.sync.m16n8k16
//   with fp32 accumulators, fed by ldmatrix (b with .trans) from
//   cp.async-filled, double-buffered chunks 32 deep, rows padded by 16
//   bytes so the 8 rows an ldmatrix reads fall on distinct bank groups.
//   Four warps, each a 32 x 32 tile of c. Needs 16-byte runs of A
//   (`vec_a`), Kc and N multiples of 8 and b 16-byte aligned. With
//   split = 1 the finished tile goes through shared memory, so that c is
//   written in 16-byte runs along its rows. mma.sync, not wgmma: at these
//   sizes the bytes bound the products, and mma.sync is far above what
//   they allow.
//
// Rows and columns past M and N, and the tail of the contraction, are
// filled with 0 by the copies (a zero source size), which adds nothing.
//
// conv_tile.cuh (ilpm_conv.cu, fused_residual_conv.cu) includes this
// header for its copies, ldmatrix, mma.sync and split reduction; an
// epilogue also gets the output's flat index, so the residual one can read
// its shortcut.
//
// Everything here has internal linkage (an unnamed namespace): each
// source that includes the header instantiates its own kernels.
#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TILE = 64;  // rows and columns of c per CTA
constexpr int F32_THREADS = 64;
constexpr int F32_CHUNK = 16;  // contraction depth of a chunk, CUDA cores
constexpr int TC_CHUNK = 32;   // and on the tensor cores
constexpr int TC_THREADS = 128;
constexpr int MAX_SPLIT = 16;
// The fp32 1x1 contractions' slab (kernels/gemm.py `SLAB`): pointwise
// splits and fused_inverted_residual's mid slabs and expand folds
constexpr int SLAB = 32;

// ---- A-row sources and epilogues -----------------------------------------

// A (batch, M, Kc) row-major.
template <typename T>
struct RowMajorA {
  const T* base;
  int M, Kc;
  __device__ size_t row(int z, int m) const {
    return ((size_t)z * M + m) * Kc;
  }
  __device__ int col(int k) const { return k; }
};

// An epilogue maps the fp32 sum v of output i (flat index), column n, to
// the value stored; these two do not read i.
struct Identity {
  __device__ float operator()(float v, int, size_t = 0) const { return v; }
};

// The convs' folded-BN epilogue: act(v * scale[n] + bias[n]) in fp32.
struct ScaleBiasAct {
  const float* scale;
  const float* bias;
  int act;
  __device__ float operator()(float v, int n, size_t = 0) const {
    return ilpm::apply_act(fmaf(v, scale[n], bias[n]), act);
  }
};

// ---- copies --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; a false `pred` writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, for a source with no aligned 16-byte runs; a
// false `pred` writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// 8 bytes global -> shared (four 16-bit channels of the causal conv); a
// false `pred` writes 8 zero bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The contraction range [k0, k1) of split s: chunks [s * chunks / split,
// (s + 1) * chunks / split), or, with `per` > 0, chunks [s * per,
// (s + 1) * per) (a slab split).
__device__ __forceinline__ void split_range(int Kc, int chunk, int split,
                                            int s, int* k0, int* k1,
                                            int per = 0) {
  if (per > 0) {
    *k0 = s * per * chunk;
    *k1 = min(Kc, (s + 1) * per * chunk);
    return;
  }
  const int chunks = (Kc + chunk - 1) / chunk;
  *k0 = s * chunks / split * chunk;
  *k1 = min(Kc, (s + 1) * chunks / split * chunk);
}

// The rows of A one thread copies as 16-byte runs: RUNS rows, `step`
// apart from the first, all at column `kq` of every chunk. A row past M
// is null; the copy of a null row writes zeros.
template <typename T, int RUNS, typename ASrc>
__device__ __forceinline__ void a_rows(const ASrc& src, int z, int m, int M,
                                       int step, const T** rows) {
#pragma unroll
  for (int i = 0; i < RUNS; ++i)
    rows[i] = m + i * step < M ? src.base + src.row(z, m + i * step)
                               : nullptr;
}

// Four consecutive elements in shared memory as fp32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void load4(const __half* p, float* v) {
  const __half2* q = reinterpret_cast<const __half2*>(p);
  const float2 lo = __half22float2(q[0]), hi = __half22float2(q[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// Up to 4 consecutive outputs of one row, converted once.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* v, int valid,
                                       bool vec) {
  if (vec && valid == 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    } else {
      uint2 u;
      T* t = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = ilpm::from_f32<T>(v[j]);
      *reinterpret_cast<uint2*>(p) = u;
      return;
    }
  }
  for (int j = 0; j < valid; ++j) p[j] = ilpm::from_f32<T>(v[j]);
}

// ---- CUDA-core path -------------------------------------------------------

// 64 x 64 tile of c per CTA, 64 threads, 8 x 8 outputs a thread; b is
// fp32 or in T. VEC_A: A's 16-byte runs are copied whole (a compile-time
// choice, so the scalar path keeps no row pointers live). per: chunks a
// slab split, 0 for the even split.
template <bool VEC_A, typename T, typename TB, typename ASrc, typename Epi>
__global__ void __launch_bounds__(F32_THREADS) tile_f32_kernel(
    ASrc src, const TB* __restrict__ b, T* __restrict__ c,
    float* __restrict__ ws, int batch, int batch_b, int M, int N, int Kc,
    int split, int per, bool vec_b, Epi epi) {
  constexpr int BK = F32_CHUNK;
  constexpr int VA = 16 / sizeof(T);   // elements of A in 16 bytes
  constexpr int VB = 16 / sizeof(TB);  // and of b
  constexpr int A_LD = BK + VA;        // rows padded by 16 bytes
  constexpr int A_PER_ROW = BK / VA;   // 16-byte runs in a row of a chunk
  constexpr int A_RUNS = TILE * A_PER_ROW / F32_THREADS;
  __shared__ __align__(16) T as[2][TILE][A_LD];
  __shared__ __align__(16) TB bs[2][BK][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int z = blockIdx.z / split, s = blockIdx.z % split;
  const TB* bb = b + (size_t)(z % batch_b) * Kc * N;
  const T* a0 = src.base;  // any valid address, for a zero fill
  int kb, ke;
  split_range(Kc, BK, split, s, &kb, &ke, per);

  // this thread's 16-byte runs of A: rows r0 + i * step, column kq
  const int r0 = tid / A_PER_ROW, kq = (tid % A_PER_ROW) * VA;
  constexpr int step = F32_THREADS / A_PER_ROW;
  const T* rows[A_RUNS];
  if constexpr (VEC_A) a_rows<T, A_RUNS>(src, z, m0 + r0, M, step, rows);

  auto load = [&](int stage, int k0) {
    if constexpr (VEC_A) {
      const bool kin = k0 + kq < ke;
      const int off = kin ? src.col(k0 + kq) : 0;
#pragma unroll
      for (int i = 0; i < A_RUNS; ++i) {
        const bool ok = kin && rows[i] != nullptr;
        cp_async16(&as[stage][r0 + i * step][kq], ok ? rows[i] + off : a0,
                   ok);
      }
    } else {
      // one column a thread, its offset found once a chunk
      const int k = tid % BK;
      const bool kin = k0 + k < ke;
      const int off = kin ? src.col(k0 + k) : 0;
#pragma unroll
      for (int r = tid / BK; r < TILE; r += F32_THREADS / BK)
        as[stage][r][k] = kin && m0 + r < M
                              ? src.base[src.row(z, m0 + r) + off]
                              : ilpm::from_f32<T>(0.f);
    }
    if (vec_b) {
      for (int e = tid; e < BK * (TILE / VB); e += F32_THREADS) {
        const int k = e / (TILE / VB), n = (e % (TILE / VB)) * VB;
        const bool ok = k0 + k < ke && n0 + n < N;
        cp_async16(&bs[stage][k][n],
                   ok ? bb + (size_t)(k0 + k) * N + n0 + n : bb, ok);
      }
    } else {
      for (int e = tid; e < BK * TILE; e += F32_THREADS) {
        const int k = e / TILE, n = e % TILE;
        bs[stage][k][n] = (k0 + k < ke && n0 + n < N)
                              ? bb[(size_t)(k0 + k) * N + n0 + n]
                              : ilpm::from_f32<TB>(0.f);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, kb);
  for (int k0 = kb, stage = 0; k0 < ke; k0 += BK, stage ^= 1) {
    if (k0 + BK < ke) {
      load(stage ^ 1, k0 + BK);
    } else {
      cp_async_commit();  // an empty group keeps wait_group 1 exact
    }
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[8][4], bv[4][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) load4(&as[stage][ty + 8 * i][kk], av[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        load4(&bs[stage][kk + q][4 * tx], bv[q]);
        load4(&bs[stage][kk + q][32 + 4 * tx], bv[q] + 4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
    }
    __syncthreads();
  }

  // the epilogue, column by column, before any store: a column's epilogue
  // operands are read once for its 8 rows
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 32 * (j / 4) + 4 * tx + j % 4;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = epi(acc[i][j], n);
    }
  }
  const bool vec_c = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 32 * h + 4 * tx;
      const int valid = min(4, N - n);
      if (valid <= 0) continue;
      const size_t off = (size_t)m * N + n;
      if (split == 1)
        store4(c + (size_t)z * M * N + off, acc[i] + 4 * h, valid, vec_c);
      else
        store4(ws + ((size_t)s * batch + z) * M * N + off, acc[i] + 4 * h,
               valid, vec_c);
    }
  }
}

// ---- tensor-core path (bf16 / fp16) ---------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d,
                                                        const uint32_t* a,
                                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a,
                                                 const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 64 x 64 tile of c per CTA, four warps in 2 x 2, each 32 x 32.
template <typename T, typename ASrc, typename Epi>
__global__ void __launch_bounds__(TC_THREADS) tile_tc_kernel(
    ASrc src, const T* __restrict__ b, T* __restrict__ c,
    float* __restrict__ ws, int batch, int batch_b, int M, int N, int Kc,
    int split, Epi epi) {
  constexpr int BK = TC_CHUNK;
  constexpr int A_LD = BK + 8;      // 80-byte rows: 8 rows, 8 bank groups
  constexpr int B_LD = TILE + 8;    // 144-byte rows
  constexpr int WM = TILE / 2, MI = WM / 16, NI = 4;
  constexpr int A_PER_ROW = BK / 8;
  constexpr int A_RUNS = TILE * A_PER_ROW / TC_THREADS;
  __shared__ __align__(16) T as[2][TILE][A_LD];
  __shared__ __align__(16) T bs[2][BK][B_LD];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int z = blockIdx.z / split, s = blockIdx.z % split;
  const T* bb = b + (size_t)(z % batch_b) * Kc * N;
  const T* a0 = src.base;
  int kb, ke;
  split_range(Kc, BK, split, s, &kb, &ke);

  const int r0 = tid / A_PER_ROW, kq = (tid % A_PER_ROW) * 8;
  constexpr int step = TC_THREADS / A_PER_ROW;
  const T* rows[A_RUNS];
  a_rows<T, A_RUNS>(src, z, m0 + r0, M, step, rows);

  auto load = [&](int stage, int k0) {
    const bool kin = k0 + kq < ke;
    const int off = kin ? src.col(k0 + kq) : 0;
#pragma unroll
    for (int i = 0; i < A_RUNS; ++i) {
      const bool ok = kin && rows[i] != nullptr;
      cp_async16(&as[stage][r0 + i * step][kq], ok ? rows[i] + off : a0, ok);
    }
    for (int e = tid; e < BK * (TILE / 8); e += TC_THREADS) {
      const int k = e / (TILE / 8), n = (e % (TILE / 8)) * 8;
      const bool ok = k0 + k < ke && n0 + n < N;
      cp_async16(&bs[stage][k][n],
                 ok ? bb + (size_t)(k0 + k) * N + n0 + n : bb, ok);
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

  load(0, kb);
  for (int k0 = kb, stage = 0; k0 < ke; k0 += BK, stage ^= 1) {
    if (k0 + BK < ke) {
      load(stage ^ 1, k0 + BK);
    } else {
      cp_async_commit();
    }
    cp_async_wait_one();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], &as[stage][wm * WM + 16 * i + lane % 16]
                               [ks + (lane / 16) * 8]);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &bs[stage][ks + lane % 16]
                                [wn * 32 + 8 * j + (lane / 16) * 8]);
        bf[j][0] = r[0]; bf[j][1] = r[1];
        bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma16816<T>(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // accumulator q of tile (i, j): row lane/4 (+8 for q >= 2), column
  // 2 (lane % 4) + q % 2
  if (split > 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * WM + 16 * i + lane / 4 + 8 * h;
          const int n = n0 + wn * 32 + 8 * j + 2 * (lane % 4);
          if (m >= M || n >= N) continue;  // N % 8 == 0: both or neither
          *reinterpret_cast<float2*>(ws + ((size_t)s * batch + z) * M * N +
                                     (size_t)m * N + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    return;
  }
  // split 1: the epilogue (a column's operands read once), then the tile
  // through shared memory (the A buffers, free after the main loop's last
  // barrier), so that c is written in 16-byte runs along its rows
  constexpr int C_LD = TILE + 8;  // 144-byte rows: a warp's pairs, 32 banks
  static_assert(TILE * C_LD <= 2 * TILE * A_LD, "c tile exceeds A's space");
  T (*cs)[C_LD] = reinterpret_cast<T (*)[C_LD]>(&as[0][0][0]);
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn * 32 + 8 * j + 2 * (lane % 4) + q;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        acc[i][j][q] = epi(acc[i][j][q], n);
        acc[i][j][2 + q] = epi(acc[i][j][2 + q], n);
      }
    }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t u;
        T* t = reinterpret_cast<T*>(&u);
        t[0] = ilpm::from_f32<T>(acc[i][j][2 * h]);
        t[1] = ilpm::from_f32<T>(acc[i][j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(
            &cs[wm * WM + 16 * i + lane / 4 + 8 * h]
               [wn * 32 + 8 * j + 2 * (lane % 4)]) = u;
      }
  __syncthreads();
  for (int e = tid; e < TILE * (TILE / 8); e += TC_THREADS) {
    const int r = e / (TILE / 8), k = (e % (TILE / 8)) * 8;
    if (m0 + r < M && n0 + k < N)  // N % 8 == 0: a run is all in or out
      *reinterpret_cast<uint4*>(c + ((size_t)z * M + m0 + r) * N + n0 + k) =
          *reinterpret_cast<const uint4*>(&cs[r][k]);
  }
}

// ---- the split-K reduction ------------------------------------------------

// c[i] = cast(epi(ws[0][i] + ws[1][i] + ... + ws[split-1][i], i % N, i)),
// the splits summed in that order.
template <typename T, typename Epi>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              T* __restrict__ c, size_t total, int N,
                              int split, Epi epi) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < split; ++s) v += ws[s * total + i];
    c[i] = ilpm::from_f32<T>(epi(v, (int)(i % N), i));
  }
}

// The reduction of `split` fp32 partial outputs (split, total) into c.
template <typename T, typename Epi>
cudaError_t launch_splitk_reduce(const float* ws, T* c, size_t total, int N,
                                 int split, const Epi& epi,
                                 cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)std::min<size_t>((total + 255) / 256, 132 * 16);
  splitk_reduce<T><<<blocks, 256, 0, stream>>>(ws, c, total, N, split, epi);
  return cudaGetLastError();
}

// ---- the launch -------------------------------------------------------

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Validate and launch one product: the main kernel on the tensor cores
// (`tensor`: T 16-bit, b in T) or the CUDA cores, then, where split > 1,
// the reduction. tile: the CTA tile's rows and columns (64); split: the
// number of contraction splits (a power of two, at most 16, at most the
// number of chunks of the path; with `slabs`, on the CUDA cores only, the
// number of SLAB-channel slabs of Kc, one a split); ws: the fp32
// workspace (split, batch, M, N) when split > 1. vec_a: 16-byte runs of A
// at multiples of 16 bytes' worth of columns are contiguous and aligned
// (the tensor cores need it); vec_b: so are b's rows (N a multiple of 16
// bytes' worth, b aligned).
template <typename T, typename TB, typename ASrc, typename Epi>
cudaError_t launch_tile(bool tensor, const ASrc& src, bool vec_a,
                        const TB* b, bool vec_b, T* c, void* ws, int batch,
                        int batch_b, int M, int N, int Kc, int tile,
                        int split, const Epi& epi, cudaStream_t stream,
                        bool slabs = false) {
  static_assert(SLAB % F32_CHUNK == 0, "a slab is whole chunks");
  const int chunk = tensor ? TC_CHUNK : F32_CHUNK;
  const int chunks = Kc < 1 ? 0 : (Kc + chunk - 1) / chunk;
  const bool split_ok =
      slabs ? !tensor && split == (Kc + SLAB - 1) / SLAB
            : split <= MAX_SPLIT && !(split & (split - 1)) && split <= chunks;
  if (!b || !c || batch < 1 || batch_b < 1 || batch % batch_b || M < 1 ||
      N < 1 || Kc < 1 || tile != TILE || split < 1 || !split_ok ||
      (split > 1 && (!ws || !aligned16(ws))) ||
      (N + TILE - 1) / TILE > 65535 || (long long)batch * split > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE,
                  batch * split);
  float* fws = static_cast<float*>(ws);
  if (tensor) {
    if constexpr (sizeof(T) == 2 && std::is_same_v<T, TB>) {
      if (!vec_a || Kc % 8 || N % 8 || !aligned16(b))
        return cudaErrorInvalidValue;
      tile_tc_kernel<T><<<grid, TC_THREADS, 0, stream>>>(
          src, b, c, fws, batch, batch_b, M, N, Kc, split, epi);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    const int per = slabs ? SLAB / F32_CHUNK : 0;
    if (vec_a)
      tile_f32_kernel<true, T, TB><<<grid, F32_THREADS, 0, stream>>>(
          src, b, c, fws, batch, batch_b, M, N, Kc, split, per, vec_b, epi);
    else
      tile_f32_kernel<false, T, TB><<<grid, F32_THREADS, 0, stream>>>(
          src, b, c, fws, batch, batch_b, M, N, Kc, split, per, vec_b, epi);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  return launch_splitk_reduce(fws, c, (size_t)batch * M * N, N, split, epi,
                              stream);
}

}  // namespace
