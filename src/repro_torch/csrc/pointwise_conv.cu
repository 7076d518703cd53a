// Pointwise (1x1) convolution for sm_90a: the Hopper counterpart of the
// Pallas kernel `pointwise_conv` in src/repro/kernels/pointwise_conv.py.
//
// x (B, H, W, C) unpadded, w (1, 1, C, K) -> out (B, Ho, Wo, K) with
// Ho = ceil(H / stride); output pixel (oh, ow) reads x[oh*stride, ow*stride],
// so a strided 1x1 (the ResNet projection shortcut) subsamples in the load
// and reads only the pixels it uses. Epilogue act(acc * scale + bias).
//
// A 1x1 conv is one (pixels, C) @ (C, K) product with no halo, so the
// tile is a flat run of 64 output pixels by a 64-wide channel slab. The
// CTA walks C in chunks of 32, staging the chunk's pixel rows and filter
// rows in shared memory as fp32; each thread accumulates 4 pixels x 4
// channels in fp32 registers on CUDA-core FMAs and the store converts
// once. Blocks are independent: grid (pixel tiles, K slabs, batch).
#include "common.cuh"

namespace {

constexpr int TILE_P = 64;
constexpr int TILE_K = 64;
constexpr int CHUNK = 32;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) pointwise_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int H, int W, int C, int K, int Ho, int Wo,
    int stride, int act) {
  // +1 on the pixel rows keeps the two pixel rows a warp reads on
  // different banks.
  __shared__ float xs[TILE_P][CHUNK + 1];
  __shared__ float ws[CHUNK][TILE_K];
  const int P = Ho * Wo;
  const int p0 = blockIdx.x * TILE_P;
  const int k0 = blockIdx.y * TILE_K;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels k0 + tx + 16*j
  const int ty = tid / 16;  // pixels p0 + ty + 16*i
  const T* xb = x + (size_t)b * H * W * C;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int cn = min(CHUNK, C - c0);
    for (int e = tid; e < TILE_P * CHUNK; e += THREADS) {
      const int c = e % CHUNK;
      const int p = e / CHUNK;
      const int q = p0 + p;
      float v = 0.f;
      if (c < cn && q < P) {
        const int ih = (q / Wo) * stride;
        const int iw = (q % Wo) * stride;
        v = ilpm::to_f32(xb[((size_t)ih * W + iw) * C + c0 + c]);
      }
      xs[p][c] = v;
    }
    for (int e = tid; e < CHUNK * TILE_K; e += THREADS) {
      const int k = e % TILE_K;
      const int c = e / TILE_K;
      float v = 0.f;
      if (c < cn && k0 + k < K) v = ilpm::to_f32(w[(size_t)(c0 + c) * K + k0 + k]);
      ws[c][k] = v;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = p0 + ty + 16 * i;
    if (q >= P) continue;
    const size_t base = ((size_t)b * P + q) * K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k >= K) continue;
      const float y = fmaf(acc[i][j], scale[k], bias[k]);
      out[base + k] = ilpm::from_f32<T>(ilpm::apply_act(y, act));
    }
  }
}

template <typename T>
cudaError_t launch_pointwise(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int B, int H, int W,
                             int C, int K, int stride, int act,
                             cudaStream_t stream) {
  const int Ho = (H + stride - 1) / stride;
  const int Wo = (W + stride - 1) / stride;
  const dim3 grid((Ho * Wo + TILE_P - 1) / TILE_P, (K + TILE_K - 1) / TILE_K, B);
  pointwise_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, C, K, Ho, Wo, stride, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pointwise_conv_launch(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int B, int H, int W, int C,
                                     int K, int stride, int act,
                                     void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_pointwise<T>(x, w, scale, bias, out, B, H, W, C, K,
                                      stride, act,
                                      static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
