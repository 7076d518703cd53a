// Pointwise (1x1) convolution for sm_90a: the Hopper counterpart of the
// Pallas kernel `pointwise_conv` in src/repro/kernels/pointwise_conv.py:51.
//
// x (B, H, W, C) unpadded, w (1, 1, C, K) -> out (B, Ho, Wo, K) with
// Ho = ceil(H / stride); output pixel (oh, ow) reads x[oh*stride, ow*stride],
// so a strided 1x1 (the ResNet projection shortcut) subsamples in the load
// and reads only the pixels it uses. Epilogue act(acc * scale + bias) on
// the fp32 sum, converted once.
//
// A 1x1 conv is one (Ho*Wo, C) @ (C, K) product per image whose row q is
// the pixel x[(q / Wo)*s, (q % Wo)*s, :], so it runs on the split-K tile
// of gemm_tile.cuh (gemm's), with that row as its A source, w[0, 0] as b,
// the image as the grid's z and the folded-BN epilogue.
//
// What bounds it on the H100: MobileNetV2's and ResNet-18's 1x1 layers
// are 0.002-0.1 GFLOP over 0.1-5 MB. In IEEE fp32 (CUDA cores) the deep
// 7² and 14² layers (C 160-960) are bound by their operations, the wide
// 112² and 56² ones by their bytes; in bf16 the bytes bound all of them.
// The first kernel walked the whole C serially in each CTA of a 64 x 64
// output tile: 3-8 CTAs at the deep layers. The design:
// - the contraction is split (never by B), the partials summed in split
//   order by the reduction, which applies the epilogue once. fp32 splits
//   at its 32-channel slabs (gemm_tile.cuh `SLAB`, one a split), the
//   order of fused_inverted_residual.cu's expand and project, so the
//   per-layer MobileNetV2 gives the fused block's bits; bf16 and fp16
//   split by `gemm.plan(Ho*Wo, K, C, 1, dtype, dtype)`;
// - fp32 on the CUDA cores, IEEE fmaf, never TF32; a pixel's channels are
//   contiguous, so where C is a multiple of 4 and x is aligned a 16-byte
//   run of channels is one cp.async, else the loads are scalar;
// - bf16 and fp16 on the tensor cores (mma.sync) where C and K are
//   multiples of 8 and x and w are 16-byte aligned (every ResNet-18 and
//   MobileNetV2 layer); any other 16-bit shape on the CUDA cores of the
//   same tile, w converted to fp32 as it is read.
#include "gemm_tile.cuh"

namespace {

// Row q of image z: the pixel ((q / Wo) * stride, (q % Wo) * stride) of x.
template <typename T>
struct PixelRows {
  const T* base;
  int H, W, C, Wo, stride;
  __device__ size_t row(int z, int q) const {
    const int ih = q / Wo * stride, iw = q % Wo * stride;
    return (((size_t)z * H + ih) * W + iw) * C;
  }
  __device__ int col(int k) const { return k; }
};

template <typename T>
cudaError_t launch_pointwise(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int B, int H,
                             int W, int C, int K, int stride, int act,
                             int tile, int split, void* ws,
                             cudaStream_t stream) {
  if (!x || !w || !scale || !bias || B < 1 || H < 1 || W < 1 || C < 1 ||
      K < 1 || stride < 1)
    return cudaErrorInvalidValue;
  const int Ho = (H + stride - 1) / stride, Wo = (W + stride - 1) / stride;
  const PixelRows<T> src{static_cast<const T*>(x), H, W, C, Wo, stride};
  const ScaleBiasAct epi{static_cast<const float*>(scale),
                         static_cast<const float*>(bias), act};
  constexpr int V = 16 / sizeof(T);
  const bool vec_x = C % V == 0 && aligned16(x);
  const bool vec_w = K % V == 0 && aligned16(w);
  const bool tensor = sizeof(T) == 2 && vec_x && vec_w;
  return launch_tile(tensor, src, vec_x, static_cast<const T*>(w), vec_w,
                     static_cast<T*>(out), ws, B, 1, Ho * Wo, K, C, tile,
                     split, epi, stream, /*slabs=*/sizeof(T) == 4);
}

}  // namespace

// tile: the CTA tile's rows and columns (64); split: the number of splits
// of the C contraction (fp32: its 32-channel slabs, ceil(C / 32); else a
// power of two, at most 16, at most the number of chunks of the path);
// ws: the fp32 workspace (split, B, Ho*Wo, K) when split > 1. The tensor
// cores take a 16-bit x where C and K are multiples of 8 and x and w are
// 16-byte aligned.
extern "C" int pointwise_conv_launch(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int B, int H, int W, int C,
                                     int K, int stride, int act, int tile,
                                     int split, void* ws, void* stream) {
  if (act < ilpm::ACT_NONE || act > ilpm::ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_pointwise<T>(x, w, scale, bias, out, B, H, W, C, K,
                                      stride, act, tile, split, ws,
                                      static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
