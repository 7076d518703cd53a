// Tiled matrix product for sm_90a: the Hopper counterpart of the Pallas
// kernel `gemm` in src/repro/kernels/gemm.py (im2col's second phase).
//
// a (batch, M, Kc) row-major, b (Kc, N) shared by every batch element
// -> c (batch, M, N) in the dtype of a, accumulated in fp32.
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
// What bounds it: at the paper's four layers a product does 0.23 GFLOP
// against 1-8 MB, so in fp32 the operations bound it and in bf16 (against
// the tensor cores' peak) the bytes do; this kernel runs both on CUDA-core
// fp32 FMAs.
#include "common.cuh"

namespace {

constexpr int TILE_M = 64;
constexpr int TILE_N = 64;
constexpr int CHUNK = 32;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    int M, int N, int Kc) {
  // +1 on the rows of a keeps the two rows a warp reads on different banks.
  __shared__ float as[TILE_M][CHUNK + 1];
  __shared__ float bs[CHUNK][TILE_N];
  const int m0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * TILE_N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns n0 + tx + 16*j
  const int ty = tid / 16;  // rows m0 + ty + 16*i
  const T* ab = a + (size_t)blockIdx.z * M * Kc;

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
        v = ilpm::to_f32(b[(size_t)(k0 + k) * N + n0 + n]);
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

template <typename T>
cudaError_t launch_gemm(const void* a, const void* b, void* c, int batch,
                        int M, int N, int Kc, cudaStream_t stream) {
  if (batch < 1 || M < 1 || N < 1 || Kc < 1) return cudaErrorInvalidValue;
  const dim3 grid((M + TILE_M - 1) / TILE_M, (N + TILE_N - 1) / TILE_N,
                  batch);
  gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, Kc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gemm_launch(int dtype, const void* a, const void* b, void* c,
                           int batch, int M, int N, int Kc, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_gemm<T>(a, b, c, batch, M, N, Kc,
                                 static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
