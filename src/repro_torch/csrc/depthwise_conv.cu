// Depthwise convolution for sm_90a: the Hopper counterpart of the Pallas
// kernel `depthwise_conv` in src/repro/kernels/depthwise_conv.py.
//
// x_padded (B, Hp, Wp, C), w (R, S, 1, K) with K = M * C -> out (B, H, W, K),
// H = (Hp - R) / stride + 1; output channel k reads input channel k / M.
// Epilogue act(acc * scale + bias), converted once on the store.
//
// A depthwise conv has no contraction: R*S FMAs per output against one
// input and one filter element each, so it is bound by bytes at every
// MobileNetV2 shape. The kernel keeps NHWC with channels innermost and
// gives the 32 lanes of a warp 32 neighbouring channels of one output
// pixel, so every tap's loads of x, w and the store coalesce; the eight
// warps of a block take eight neighbouring pixels, whose overlapping taps
// hit in L1. The grid is (pixel groups, channel groups, batch), so even
// the 7x7x960 layer launches 210 blocks on the card's 132 SMs.
//
// Each thread runs the tap loop r-major as a chain of fmaf from 0 and then
// fmaf(acc, scale, bias): the same arithmetic, in the same order, as the
// depthwise stage of fused_inverted_residual.cu, so the fused and the
// per-layer paths give bitwise equal results.
#include "common.cuh"

namespace {

constexpr int LANES = 32;  // channels per block
constexpr int PIXELS = 8;  // output pixels per block

template <typename T>
__global__ void __launch_bounds__(LANES * PIXELS) depthwise_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int Hp, int Wp, int C, int R, int S, int K, int H,
    int W, int stride, int act) {
  const int k = blockIdx.y * LANES + threadIdx.x;
  const int p = blockIdx.x * PIXELS + threadIdx.y;
  const int b = blockIdx.z;
  if (k >= K || p >= H * W) return;
  const int oh = p / W;
  const int ow = p % W;
  const int c = k / (K / C);
  const T* xb = x + (size_t)b * Hp * Wp * C + c;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    const T* xr = xb + ((size_t)(oh * stride + r) * Wp + ow * stride) * C;
    for (int s = 0; s < S; ++s)
      acc = fmaf(ilpm::to_f32(xr[(size_t)s * C]),
                 ilpm::to_f32(w[(r * S + s) * K + k]), acc);
  }
  const float y = ilpm::apply_act(fmaf(acc, scale[k], bias[k]), act);
  out[((size_t)b * H * W + p) * K + k] = ilpm::from_f32<T>(y);
}

template <typename T>
cudaError_t launch_depthwise(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int B, int Hp,
                             int Wp, int C, int R, int S, int K, int H, int W,
                             int stride, int act, cudaStream_t stream) {
  if (C < 1 || K % C) return cudaErrorInvalidValue;
  const dim3 block(LANES, PIXELS);
  const dim3 grid((H * W + PIXELS - 1) / PIXELS, (K + LANES - 1) / LANES, B);
  depthwise_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), Hp, Wp, C, R, S, K, H, W, stride, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" int depthwise_conv_launch(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int B, int Hp, int Wp, int C,
                                     int R, int S, int K, int H, int W,
                                     int stride, int act, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_depthwise<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                      S, K, H, W, stride, act,
                                      static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
