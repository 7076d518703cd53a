// Tiled matrix product for sm_90a: the Hopper counterpart of the Pallas
// kernel `gemm` in src/repro/kernels/gemm.py (im2col's second phase, and
// Winograd's 16 products).
//
// a (batch, M, Kc) row-major, b (batch_b, Kc, N) -> c (batch, M, N) in the
// dtype of a, accumulated in fp32; batch element z reads b[z % batch_b].
// batch_b = 1 is im2col's filter bank shared by the batch; batch_b = 16 is
// Winograd's U, with a = V as (images * 16, tiles, C), so each image's 16
// products are 16 grid-z slices of one launch, as the TPU kernel's one
// pallas_call vmapped over them. b is in the dtype of a or fp32 (the
// forced Winograd path's U); both are staged as fp32 either way.
//
// One CTA owns a 64 x 64 tile of c and one batch element: grid (M tiles,
// N tiles, batch). It walks the contraction in chunks of 32, staging the
// chunk's 64 rows of a and 32 rows of b in shared memory as fp32; each
// thread accumulates 4 x 4 outputs in fp32 registers, one IEEE fmaf chain
// per output in contraction order (never TF32), and the store converts
// once. The TPU kernel zero-pads the contraction to its tile with a copy;
// here the predicated loads fill the tail of the last chunk (and the rows
// and columns past M and N) with 0, which adds nothing to any sum.
//
// What bounds it: at the paper's four layers an im2col product does 0.23
// GFLOP against 1-8 MB, so in fp32 the operations bound it and in bf16
// (against the tensor cores' peak) the bytes do. Winograd's 16 products of
// a ResNet-18 layer do 0.10 GFLOP against 4-7 MB in fp32, near the line
// between the two. This kernel runs every case on CUDA-core fp32 FMAs.
#include "common.cuh"

namespace {

constexpr int TILE_M = 64;
constexpr int TILE_N = 64;
constexpr int CHUNK = 32;
constexpr int THREADS = 256;

template <typename T, typename TB>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const T* __restrict__ a, const TB* __restrict__ b, T* __restrict__ c,
    int batch_b, int M, int N, int Kc) {
  // +1 on the rows of a keeps the two rows a warp reads on different banks.
  __shared__ float as[TILE_M][CHUNK + 1];
  __shared__ float bs[CHUNK][TILE_N];
  const int m0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * TILE_N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns n0 + tx + 16*j
  const int ty = tid / 16;  // rows m0 + ty + 16*i
  const T* ab = a + (size_t)blockIdx.z * M * Kc;
  const TB* bb = b + (size_t)(blockIdx.z % batch_b) * Kc * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kc; k0 += CHUNK) {
    for (int e = tid; e < TILE_M * CHUNK; e += THREADS) {
      const int k = e % CHUNK;
      const int m = e / CHUNK;
      float v = 0.f;
      if (m0 + m < M && k0 + k < Kc)
        v = ilpm::to_f32(ab[(size_t)(m0 + m) * Kc + k0 + k]);
      as[m][k] = v;
    }
    for (int e = tid; e < CHUNK * TILE_N; e += THREADS) {
      const int n = e % TILE_N;
      const int k = e / TILE_N;
      float v = 0.f;
      if (k0 + k < Kc && n0 + n < N)
        v = ilpm::to_f32(bb[(size_t)(k0 + k) * N + n0 + n]);
      bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < CHUNK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* cb = c + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) cb[(size_t)m * N + n] = ilpm::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, typename TB>
cudaError_t launch_gemm(const void* a, const void* b, void* c, int batch,
                        int batch_b, int M, int N, int Kc,
                        cudaStream_t stream) {
  if (batch < 1 || batch_b < 1 || batch % batch_b || M < 1 || N < 1 ||
      Kc < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((M + TILE_M - 1) / TILE_M, (N + TILE_N - 1) / TILE_N,
                  batch);
  gemm_kernel<T, TB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const TB*>(b),
      static_cast<T*>(c), batch_b, M, N, Kc);
  return cudaGetLastError();
}

}  // namespace

// b_fp32: b is fp32 whatever the dtype of a; else b is in the dtype of a.
extern "C" int gemm_launch(int dtype, int b_fp32, const void* a,
                           const void* b, void* c, int batch, int batch_b,
                           int M, int N, int Kc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)(b_fp32 ? launch_gemm<T, float>(a, b, c, batch, batch_b,
                                                  M, N, Kc, st)
                          : launch_gemm<T, T>(a, b, c, batch, batch_b, M,
                                              N, Kc, st)))
  return (int)cudaErrorInvalidValue;
}
