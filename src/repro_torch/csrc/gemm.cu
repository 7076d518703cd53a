// Tiled matrix product for sm_90a: the Hopper counterpart of the Pallas
// kernel `gemm` in src/repro/kernels/gemm.py:32 (im2col's second phase,
// and Winograd's 16 products).
//
// a (batch, M, Kc) row-major, b (batch_b, Kc, N) -> c (batch, M, N) in the
// dtype of a, accumulated in fp32; batch element z reads b[z % batch_b].
// batch_b = 1 is im2col's filter bank shared by the batch; batch_b = 16 is
// Winograd's U, with a = V as (images * 16, tiles, C), so each image's 16
// products are 16 grid slices of one launch, as the TPU kernel's one
// pallas_call vmapped over them. b is in the dtype of a, or fp32 (the
// forced Winograd path's U, and a cached U stored wider than the compute
// dtype).
//
// What bounds it on the H100: ResNet-18's im2col products do 0.23 GFLOP
// against 1-9 MB, so in fp32 (IEEE, CUDA cores, 67 TFLOP/s: 3.4 us) the
// operations bound them, and in bf16 (tensor cores) the bytes do (0.7-2.7
// us at 3.35 TB/s); Winograd's 16 products of a layer do 0.10 GFLOP
// against 4-7 MB. What held the first kernel back was the grid: a CTA per
// 64 x 64 tile of c walking the whole contraction gives 8-26 CTAs for 132
// SMs at the deep layers, where Kc is 1152-4608.
//
// The design is the split-K tile of gemm_tile.cuh, which pointwise_conv.cu
// and libdnn_conv.cu share, with a plain row-major A and no epilogue:
// - split-K by the Python wrapper's `gemm.plan`, from (M, N, Kc, batch_b,
//   dtypes) alone, never from the batch, so that one image's grid has at
//   least 128 CTAs (512 of the CUDA-core path's 2-warp CTAs where the
//   contraction allows it); the splits' fp32 partial tiles are summed in
//   split order by a second kernel of the same launch and cast once;
// - fp32 path (b fp32; a fp32, or 16-bit under an fp32 b): CUDA cores,
//   IEEE fmaf, never TF32; 16-byte cp.async copies where Kc (for a) and N
//   (for b) allow them and the pointers are aligned, predicated scalar
//   loads otherwise;
// - bf16 / fp16 path (b in the dtype of a): tensor cores through
//   mma.sync.m16n8k16 with fp32 accumulators. Needs Kc and N multiples of
//   8 and 16-byte aligned pointers (the wrapper raises otherwise).
#include "gemm_tile.cuh"

namespace {

// b_fp32: b is fp32 (the CUDA cores, whatever the dtype of a); else b is
// in the dtype of a, on the tensor cores where that is 16-bit.
template <typename T>
cudaError_t launch_gemm(bool b_fp32, const void* a, const void* b, void* c,
                        void* ws, int batch, int batch_b, int M, int N,
                        int Kc, int tile, int split, cudaStream_t stream) {
  if (!a) return cudaErrorInvalidValue;
  const RowMajorA<T> src{static_cast<const T*>(a), M, Kc};
  const bool vec_a = Kc % (16 / sizeof(T)) == 0 && aligned16(a);
  T* tc = static_cast<T*>(c);
  if (b_fp32 || sizeof(T) == 4) {
    const bool vec_b = N % 4 == 0 && aligned16(b);
    return launch_tile(false, src, vec_a, static_cast<const float*>(b),
                       vec_b, tc, ws, batch, batch_b, M, N, Kc, tile, split,
                       Identity{}, stream);
  }
  return launch_tile(true, src, vec_a, static_cast<const T*>(b), true, tc,
                     ws, batch, batch_b, M, N, Kc, tile, split, Identity{},
                     stream);
}

}  // namespace

// b_fp32: b is fp32 whatever the dtype of a; else b is in the dtype of a.
// tile: the CTA tile's rows and columns (64); split: the number of
// contraction splits (a power of two, at most 16, at most the number of
// chunks); ws: the fp32 workspace (split, batch, M, N) when split > 1.
extern "C" int gemm_launch(int dtype, int b_fp32, const void* a,
                           const void* b, void* c, int batch, int batch_b,
                           int M, int N, int Kc, int tile, int split,
                           void* ws, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_fp32 != 0 && b_fp32 != 1) return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_gemm<T>(b_fp32 == 1, a, b, c, ws, batch, batch_b,
                                 M, N, Kc, tile, split, st))
  return (int)cudaErrorInvalidValue;
}
