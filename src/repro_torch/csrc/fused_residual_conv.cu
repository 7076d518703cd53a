// Residual-conv block tail for sm_90a: the Hopper counterpart of the
// Pallas kernel `fused_residual_conv` in src/repro/kernels/fused_block.py:234.
//
// x_padded (B, H+R-1, W+S-1, C), w (R, S, C, K), res (B, H, W, K)
// -> out = act(T(acc * scale + bias) + res), stride 1. The shortcut add
// and the block's outer activation ride in the conv's single output
// write, so the conv output never makes a separate round trip through
// device memory. The body is the halo-resident, split conv tile of
// conv_tile.cuh, ilpm_conv's, with the residual epilogue ScaleBiasRes:
// after a split it runs once, in the reduction.
#include "conv_tile.cuh"

// tile, chunk, split, rsplit, ws: as ilpm_conv_launch's.
extern "C" int fused_residual_conv_launch(int dtype, const void* x,
                                          const void* w, const void* scale,
                                          const void* bias, const void* res,
                                          void* out, int B, int Hp, int Wp,
                                          int C, int R, int S, int K,
                                          int act, int tile, int chunk,
                                          int split, int rsplit, void* ws,
                                          void* stream) {
  if (!scale || !bias || !res || act < ilpm::ACT_NONE ||
      act > ilpm::ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  const int H = Hp - R + 1;
  const int W = Wp - S + 1;
  ILPM_DISPATCH_DTYPE(dtype, T,
      const ScaleBiasRes<T> epi{static_cast<const float*>(scale),
                                static_cast<const float*>(bias),
                                static_cast<const T*>(res), act};
      return (int)launch_conv_tile<T>(
          x, w, out, ws, B, Hp, Wp, C, R, S, K, H, W, 1, tile, chunk, split,
          rsplit, epi, static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
