// ILP-M dense convolution for sm_90a: the Hopper counterpart of the
// Pallas kernel `ilpm_conv` in src/repro/kernels/ilpm_conv.py.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = (Hp - R) / stride + 1, stride 1 or 2 as strided tap windows, and the
// fused epilogue act(acc * scale + bias). The body is the halo'd-tile
// kernel of conv_tile.cuh.
#include "conv_tile.cuh"

extern "C" int ilpm_conv_launch(int dtype, const void* x, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int Hp, int Wp, int C,
                                int R, int S, int K, int H, int W,
                                int stride, int act, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)ilpm::launch_conv_tile<T, false>(
          x, w, scale, bias, nullptr, out, B, Hp, Wp, C, R, S, K, H, W,
          stride, act, static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
