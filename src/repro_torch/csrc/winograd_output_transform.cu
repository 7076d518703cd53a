// Winograd F(2x2,3x3) output transform for sm_90a: the Hopper counterpart
// of the Pallas kernel `winograd_output_transform` in
// src/repro/kernels/winograd_conv.py, with its fused (scale, bias, act)
// epilogue.
//
// M (B, 4, 4, nt, K) -> y (B, H, W, K), nt = (H/2)(W/2): tile t = i*(W/2)+j
// of image b, channel k, reads its 16 values M[b, :, :, t, k] as fp32,
// computes Aᵀ m A (rows then columns, left to right, as the plain version
// does), applies act(y * scale[k] + bias[k]) in fp32 and writes the 2x2
// block at (2i, 2j) with one cast each, in the dtype of M.
//
// What bounds it: add/sub and one multiply-add an output, so bytes bound
// it: M is 4x the output. The TPU kernel holds one image's whole M block
// in VMEM (16 x 784 x 64 fp32 at 56² is 3.2 MB); here one thread owns one
// (image, tile, channel) in registers and uses no shared memory. Lanes
// take neighbouring channels, so the 16 loads and 4 stores coalesce along
// K in NHWC.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) output_transform_kernel(
    const T* __restrict__ m, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ y, int W, int K,
    int tw, int nt, int act, long long total) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * THREADS) {
    const int k = (int)(i % K);
    const long long bt = i / K;  // b * nt + t
    const int t = (int)(bt % nt);
    const long long b = bt / nt;
    const T* mb = m + (b * 16 * nt + t) * K + k;
    float mv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mv[a][e] = ilpm::to_f32(mb[(long long)(a * 4 + e) * nt * K]);
    // rows: r[a][e] = sum_x Aᵀ[a][x] m[x][e]
    float r[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[0][e] = mv[0][e] + mv[1][e] + mv[2][e];
      r[1][e] = mv[1][e] - mv[2][e] - mv[3][e];
    }
    const float sc = scale[k], bi = bias[k];
    const int H = 2 * (nt / tw);
    const int h0 = 2 * (t / tw), w0 = 2 * (t % tw);
    T* yb = y + ((b * H + h0) * W + w0) * K + k;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float y0 = r[a][0] + r[a][1] + r[a][2];
      const float y1 = r[a][1] - r[a][2] - r[a][3];
      yb[(long long)a * W * K] =
          ilpm::from_f32<T>(ilpm::apply_act(fmaf(y0, sc, bi), act));
      yb[(long long)a * W * K + K] =
          ilpm::from_f32<T>(ilpm::apply_act(fmaf(y1, sc, bi), act));
    }
  }
}

template <typename T>
cudaError_t launch(const void* m, const float* scale, const float* bias,
                   void* y, int B, int H, int W, int K, int act,
                   cudaStream_t stream) {
  const int tw = W / 2;
  const int nt = (H / 2) * tw;
  const long long total = (long long)B * nt * K;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  output_transform_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(m), scale, bias, static_cast<T*>(y), W, K, tw,
      nt, act, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int winograd_output_transform_launch(
    int dtype, const void* m, const void* scale, const void* bias, void* y,
    int B, int H, int W, int K, int act, void* stream) {
  if (B < 1 || K < 1 || H < 2 || W < 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch<T>(m, static_cast<const float*>(scale),
                            static_cast<const float*>(bias), y, B, H, W, K,
                            act, static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
