// Tiled matrix product for sm_90a: the Hopper counterpart of the Pallas
// kernel `gemm` in src/repro/kernels/gemm.py:32 (im2col's second phase,
// and Winograd's 16 products).
//
// a (batch, M, Kc) row-major, b (batch_b, Kc, N) -> c (batch, M, N) in the
// dtype of a, accumulated in fp32; batch element z reads b[z % batch_b].
// batch_b = 1 is im2col's filter bank shared by the batch; batch_b = 16 is
// Winograd's U, with a = V as (images * 16, tiles, C), so each image's 16
// products are 16 grid slices of one launch, as the TPU kernel's one
// pallas_call vmapped over them. b is in the dtype of a, or fp32 (the
// forced Winograd path's U, and a cached U stored wider than the compute
// dtype).
//
// What bounds it on the H100: ResNet-18's im2col products do 0.23 GFLOP
// against 1-9 MB, so in fp32 (IEEE, CUDA cores, 67 TFLOP/s: 3.4 us) the
// operations bound them, and in bf16 (tensor cores) the bytes do (0.7-2.7
// us at 3.35 TB/s); Winograd's 16 products of a layer do 0.10 GFLOP
// against 4-7 MB. What held the first kernel back was the grid: a CTA per
// 64 x 64 tile of c walking the whole contraction gives 8-26 CTAs for 132
// SMs at the deep layers, where Kc is 1152-4608.
//
// The design:
// - Split-K. A CTA owns a 64 x 64 tile of c. The Python wrapper's
//   `gemm.plan` picks `split`, a power of two up to 16, from (M, N, Kc,
//   batch_b, dtypes) alone, never from the batch, so that one image's
//   grid has at least 128 CTAs (512 of the fp32 path's 2-warp CTAs where
//   the contraction allows it). Split s walks chunks
//   [s * chunks / split, (s + 1) * chunks / split) of the contraction and
//   writes its fp32 partial tile to the workspace (split, batch, M, N);
//   `splitk_reduce`, launched by the same call, sums the splits in order
//   0..split-1 in fp32 and casts once. The result does not depend on the
//   batch, so run_batch stays bitwise equal to run. With split = 1 the
//   main kernel stores c directly.
// - fp32 path (b fp32; a fp32, or 16-bit under an fp32 b): CUDA cores,
//   IEEE fmaf in contraction order, never TF32. 64 threads, each keeping
//   8 x 8 fp32 accumulators (rows ty + 8 i, columns 4 tx + {0..3} and
//   32 + 4 tx + {0..3}); a and b chunks 16 deep are double-buffered with
//   cp.async, 16-byte copies where Kc (for a) and N (for b) allow them and
//   the pointers are aligned, predicated scalar loads otherwise. a's rows
//   are padded by 16 bytes so the row reads of a warp's 4 rows fall on
//   distinct banks; each thread reads 4 k at once from a row.
// - bf16 / fp16 path (b in the dtype of a): tensor cores through
//   mma.sync.m16n8k16 with fp32 accumulators, fed by ldmatrix (b with
//   .trans) from cp.async-filled, double-buffered chunks 32 deep; rows
//   padded by 16 bytes so the 8 rows an ldmatrix reads fall on distinct
//   bank groups. Four warps, each a 32 x 32 tile of c. Needs Kc and N
//   multiples of 8 and 16-byte aligned pointers (the wrapper raises
//   otherwise). mma.sync, not wgmma: at these sizes the bytes bound the
//   products, and mma.sync is far above what they allow.
//
// Rows and columns past M and N, and the tail of the contraction, are
// filled with 0 by the copies (a zero source size), which adds nothing.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TILE = 64;  // rows and columns of c per CTA
constexpr int F32_THREADS = 64;
constexpr int F32_CHUNK = 16;  // contraction depth of a chunk, fp32 path
constexpr int TC_CHUNK = 32;   // and on the tensor cores
constexpr int TC_THREADS = 128;
constexpr int MAX_SPLIT = 16;

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The chunk range [c0, c1) of split s, and its contraction range.
__device__ __forceinline__ void split_range(int Kc, int chunk, int split,
                                            int s, int* k0, int* k1) {
  const int chunks = (Kc + chunk - 1) / chunk;
  *k0 = s * chunks / split * chunk;
  *k1 = min(Kc, (s + 1) * chunks / split * chunk);
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

// ---- fp32 path: CUDA cores ------------------------------------------------

// 64 x 64 tile of c per CTA, 64 threads, 8 x 8 outputs a thread.
template <typename T>
__global__ void __launch_bounds__(F32_THREADS) gemm_f32_kernel(
    const T* __restrict__ a, const float* __restrict__ b, T* __restrict__ c,
    float* __restrict__ ws, int batch, int batch_b, int M, int N, int Kc,
    int split, bool vec_a, bool vec_b) {
  constexpr int BK = F32_CHUNK;
  constexpr int VA = 16 / sizeof(T);  // elements of a in 16 bytes
  constexpr int A_LD = BK + VA;       // rows padded by 16 bytes
  __shared__ __align__(16) T as[2][TILE][A_LD];
  __shared__ __align__(16) float bs[2][BK][TILE];

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int z = blockIdx.z / split, s = blockIdx.z % split;
  const T* ab = a + (size_t)z * M * Kc;
  const float* bb = b + (size_t)(z % batch_b) * Kc * N;
  int kb, ke;
  split_range(Kc, BK, split, s, &kb, &ke);

  auto load = [&](int stage, int k0) {
    if (vec_a) {
      for (int e = tid; e < TILE * (BK / VA); e += F32_THREADS) {
        const int r = e / (BK / VA), k = (e % (BK / VA)) * VA;
        const bool ok = m0 + r < M && k0 + k < ke;
        cp_async16(&as[stage][r][k],
                   ok ? ab + (size_t)(m0 + r) * Kc + k0 + k : ab, ok);
      }
    } else {
      for (int e = tid; e < TILE * BK; e += F32_THREADS) {
        const int r = e / BK, k = e % BK;
        as[stage][r][k] = (m0 + r < M && k0 + k < ke)
                              ? ab[(size_t)(m0 + r) * Kc + k0 + k]
                              : ilpm::from_f32<T>(0.f);
      }
    }
    if (vec_b) {
      for (int e = tid; e < BK * (TILE / 4); e += F32_THREADS) {
        const int k = e / (TILE / 4), n = (e % (TILE / 4)) * 4;
        const bool ok = k0 + k < ke && n0 + n < N;
        cp_async16(&bs[stage][k][n],
                   ok ? bb + (size_t)(k0 + k) * N + n0 + n : bb, ok);
      }
    } else {
      for (int e = tid; e < BK * TILE; e += F32_THREADS) {
        const int k = e / TILE, n = e % TILE;
        bs[stage][k][n] = (k0 + k < ke && n0 + n < N)
                              ? bb[(size_t)(k0 + k) * N + n0 + n]
                              : 0.f;
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

// ---- bf16 / fp16 path: tensor cores --------------------------------------

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
template <typename T>
__global__ void __launch_bounds__(TC_THREADS) gemm_tc_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    float* __restrict__ ws, int batch, int batch_b, int M, int N, int Kc,
    int split) {
  constexpr int BK = TC_CHUNK;
  constexpr int A_LD = BK + 8;      // 80-byte rows: 8 rows, 8 bank groups
  constexpr int B_LD = TILE + 8;    // 144-byte rows
  constexpr int WM = TILE / 2, MI = WM / 16, NI = 4;
  __shared__ __align__(16) T as[2][TILE][A_LD];
  __shared__ __align__(16) T bs[2][BK][B_LD];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int z = blockIdx.z / split, s = blockIdx.z % split;
  const T* ab = a + (size_t)z * M * Kc;
  const T* bb = b + (size_t)(z % batch_b) * Kc * N;
  int kb, ke;
  split_range(Kc, BK, split, s, &kb, &ke);

  auto load = [&](int stage, int k0) {
    for (int e = tid; e < TILE * (BK / 8); e += TC_THREADS) {
      const int r = e / (BK / 8), k = (e % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + k < ke;
      cp_async16(&as[stage][r][k],
                 ok ? ab + (size_t)(m0 + r) * Kc + k0 + k : ab, ok);
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
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + 16 * i + lane / 4 + 8 * h;
        const int n = n0 + wn * 32 + 8 * j + 2 * (lane % 4);
        if (m >= M || n >= N) continue;  // N % 8 == 0: both or neither
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t off = (size_t)m * N + n;
        if (split == 1) {
          T* p = c + (size_t)z * M * N + off;
          p[0] = ilpm::from_f32<T>(v0);
          p[1] = ilpm::from_f32<T>(v1);
        } else {
          *reinterpret_cast<float2*>(ws + ((size_t)s * batch + z) * M * N +
                                     off) = make_float2(v0, v1);
        }
      }
}

// ---- the split-K reduction ------------------------------------------------

// c[i] = cast(ws[0][i] + ws[1][i] + ... + ws[split-1][i]), in that order.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              T* __restrict__ c, size_t total, int split) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < split; ++s) v += ws[s * total + i];
    c[i] = ilpm::from_f32<T>(v);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch_gemm(bool b_fp32, const void* a, const void* b, void* c,
                        void* ws, int batch, int batch_b, int M, int N,
                        int Kc, int tile, int split, cudaStream_t stream) {
  const bool tensor = !b_fp32 && sizeof(T) == 2;
  const int chunk = tensor ? TC_CHUNK : F32_CHUNK;
  const int chunks = Kc < 1 ? 0 : (Kc + chunk - 1) / chunk;
  if (!a || !b || !c || batch < 1 || batch_b < 1 || batch % batch_b ||
      M < 1 || N < 1 || Kc < 1 || tile != TILE ||
      split < 1 || split > MAX_SPLIT || (split & (split - 1)) ||
      split > chunks || (split > 1 && (!ws || !aligned16(ws))) ||
      (N + TILE - 1) / TILE > 65535 || (long long)batch * split > 65535)
    return cudaErrorInvalidValue;
  if (tensor && (Kc % 8 || N % 8 || !aligned16(a) || !aligned16(b)))
    return cudaErrorInvalidValue;
  const dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE,
                  batch * split);
  const T* ta = static_cast<const T*>(a);
  T* tc = static_cast<T*>(c);
  float* fws = static_cast<float*>(ws);
  if (tensor) {
    if constexpr (sizeof(T) == 2)
      gemm_tc_kernel<T><<<grid, TC_THREADS, 0, stream>>>(
          ta, static_cast<const T*>(b), tc, fws, batch, batch_b, M, N, Kc,
          split);
  } else {
    const float* fb = static_cast<const float*>(b);
    const bool vec_a = Kc % (16 / sizeof(T)) == 0 && aligned16(a);
    const bool vec_b = N % 4 == 0 && aligned16(b);
    gemm_f32_kernel<T><<<grid, F32_THREADS, 0, stream>>>(
        ta, fb, tc, fws, batch, batch_b, M, N, Kc, split, vec_a, vec_b);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const size_t total = (size_t)batch * M * N;
  const unsigned blocks =
      (unsigned)std::min<size_t>((total + 255) / 256, 132 * 16);
  splitk_reduce<T><<<blocks, 256, 0, stream>>>(fws, tc, total, split);
  return cudaGetLastError();
}

}  // namespace

// b_fp32: b is fp32 whatever the dtype of a; else b is in the dtype of a.
// tile: the CTA tile's rows and columns (64); split: the number of
// contraction splits (a power of two, at most 16, at most the number of
// chunks); ws: the fp32 workspace (split, batch, M, N) when split > 1.
extern "C" int gemm_launch(int dtype, int b_fp32, const void* a,
                           const void* b, void* c, int batch, int batch_b,
                           int M, int N, int Kc, int tile, int split,
                           void* ws, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_fp32 != 0 && b_fp32 != 1) return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_gemm<T>(b_fp32 == 1, a, b, c, ws, batch, batch_b,
                                 M, N, Kc, tile, split, st))
  return (int)cudaErrorInvalidValue;
}
