// Residual-conv block tail for sm_90a: the Hopper counterpart of the
// Pallas kernel `fused_residual_conv` in src/repro/kernels/fused_block.py.
//
// x_padded (B, H+R-1, W+S-1, C), w (R, S, C, K), res (B, H, W, K)
// -> out = act(T(acc * scale + bias) + res), stride 1. The shortcut add
// and the block's outer activation ride in the conv's single output
// write, so the conv output never makes a separate round trip through
// device memory. The body is the halo'd-tile kernel of conv_tile.cuh.
#include "conv_tile.cuh"

extern "C" int fused_residual_conv_launch(int dtype, const void* x,
                                          const void* w, const void* scale,
                                          const void* bias, const void* res,
                                          void* out, int B, int Hp, int Wp,
                                          int C, int R, int S, int K,
                                          int act, void* stream) {
  const int H = Hp - R + 1;
  const int W = Wp - S + 1;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)ilpm::launch_conv_tile<T, true>(
          x, w, scale, bias, res, out, B, Hp, Wp, C, R, S, K, H, W, 1, act,
          static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
