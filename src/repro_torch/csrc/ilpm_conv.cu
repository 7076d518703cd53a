// ILP-M dense convolution for sm_90a: the Hopper counterpart of the
// Pallas kernel `ilpm_conv` in src/repro/kernels/ilpm_conv.py:59.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = (Hp - R) / stride + 1, stride 1 or 2 as strided tap windows, and the
// fused epilogue act(acc * scale + bias) on the fp32 sum, converted once.
// The body is the halo-resident, split conv tile of conv_tile.cuh (what
// bounds it and what the design does about it are noted there); the
// epilogue is gemm_tile.cuh's ScaleBiasAct.
#include "conv_tile.cuh"

// tile: the output tile's side (8); chunk: channels per staged chunk;
// split: channel-chunk splits (a power of two, at most 16, at most the
// number of chunks); rsplit: filter-row splits (1 to R); ws: the fp32
// workspace (split * rsplit, B, H*W, K) where split * rsplit > 1.
extern "C" int ilpm_conv_launch(int dtype, const void* x, const void* w,
                                const void* scale, const void* bias,
                                void* out, int B, int Hp, int Wp, int C,
                                int R, int S, int K, int H, int W,
                                int stride, int act, int tile, int chunk,
                                int split, int rsplit, void* ws,
                                void* stream) {
  if (!scale || !bias || act < ilpm::ACT_NONE || act > ilpm::ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  const ScaleBiasAct epi{static_cast<const float*>(scale),
                         static_cast<const float*>(bias), act};
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_conv_tile<T>(
          x, w, out, ws, B, Hp, Wp, C, R, S, K, H, W, stride, tile, chunk,
          split, rsplit, epi, static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
