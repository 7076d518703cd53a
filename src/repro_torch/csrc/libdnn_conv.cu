// libdnn-style fused im2col convolution for sm_90a: the Hopper counterpart
// of the Pallas kernel `libdnn_conv` in src/repro/kernels/libdnn_conv.py:43.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = Hp - R + 1 (stride 1) and the fused epilogue act(acc * scale + bias),
// converted once on the store.
//
// im2col and the product in one kernel: a (H*W, R*S*C) @ (R*S*C, K)
// product per image whose row q is the patch of pixel (oh, ow) = (q / W,
// q % W), column k the element x_padded[oh + tap / S, ow + tap % S, c]
// with tap = k / C and c = k % C, and w read as (R*S*C, K). It runs on the
// split-K tile of gemm_tile.cuh (gemm's) with that patch as its A source:
// each CTA gathers its own patch tile for each contraction chunk into
// shared memory, so the patch never reaches device memory, but every K
// tile rebuilds it, gathers and index math included: that repeat is the
// paper's critique of libdnn, and it stays.
//
// What bounds it: at the paper's four layers a launch does 0.23 GFLOP
// against 1-10 MB, so fp32 on CUDA cores is bound by the operations and
// bf16 on the tensor cores by the bytes. The first kernel walked the whole
// R*S*C contraction in each CTA of a 64 x 64 output tile: 8-16 CTAs at 7²
// and 14², each 2304-4608 deep. The design:
// - the contraction is split by `gemm.plan(H*W, K, R*S*C, 1, dtype,
//   dtype)` (never by B), the partials summed in split order by the
//   reduction, which applies the epilogue once;
// - a thread computes its rows' pixel addresses once and the (r, s, c) of
//   its column once a chunk, not once a load;
// - where C is a multiple of 16 bytes' worth of elements (4 fp32, 8
//   16-bit) and x is aligned, a 16-byte run of columns starting at a
//   multiple of that count stays inside one tap: one cp.async. Else the
//   loads are scalar and predicated;
// - fp32 on the CUDA cores, IEEE fmaf, never TF32; bf16 and fp16 on the
//   tensor cores (mma.sync) where C and K are multiples of 8 and x and w
//   are 16-byte aligned, any other 16-bit shape on the CUDA cores.
#include "gemm_tile.cuh"

namespace {

// Row q of image z: the patch of pixel (q / W, q % W) of x_padded;
// column k: tap k / C = r * S + s, channel k % C.
template <typename T>
struct PatchRows {
  const T* base;
  int Hp, Wp, C, S, W;
  __device__ size_t row(int z, int q) const {
    return (((size_t)z * Hp + q / W) * Wp + q % W) * C;
  }
  __device__ int col(int k) const {
    const int tap = k / C;
    return (tap / S * Wp + tap % S) * C + (k - tap * C);
  }
};

template <typename T>
cudaError_t launch_libdnn(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int R, int S, int K, int H, int W, int act,
                          int tile, int split, void* ws,
                          cudaStream_t stream) {
  if (!x || !w || !scale || !bias || B < 1 || C < 1 || R < 1 || S < 1 ||
      K < 1 || H < 1 || W < 1 || H != Hp - R + 1 || W != Wp - S + 1)
    return cudaErrorInvalidValue;
  const PatchRows<T> src{static_cast<const T*>(x), Hp, Wp, C, S, W};
  const ScaleBiasAct epi{static_cast<const float*>(scale),
                         static_cast<const float*>(bias), act};
  constexpr int V = 16 / sizeof(T);
  const bool vec_x = C % V == 0 && aligned16(x);
  const bool vec_w = K % V == 0 && aligned16(w);
  const bool tensor = sizeof(T) == 2 && vec_x && vec_w;
  return launch_tile(tensor, src, vec_x, static_cast<const T*>(w), vec_w,
                     static_cast<T*>(out), ws, B, 1, H * W, K, R * S * C,
                     tile, split, epi, stream);
}

}  // namespace

// tile: the CTA tile's rows and columns (64); split: the number of splits
// of the R*S*C contraction (a power of two, at most 16, at most the number
// of chunks of the path); ws: the fp32 workspace (split, B, H*W, K) when
// split > 1. The tensor cores take a 16-bit x where C and K are multiples
// of 8 and x and w are 16-byte aligned.
extern "C" int libdnn_conv_launch(int dtype, const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int Hp, int Wp, int C,
                                  int R, int S, int K, int H, int W, int act,
                                  int tile, int split, void* ws,
                                  void* stream) {
  if (act < ilpm::ACT_NONE || act > ilpm::ACT_RELU6)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_libdnn<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                   S, K, H, W, act, tile, split, ws,
                                   static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
