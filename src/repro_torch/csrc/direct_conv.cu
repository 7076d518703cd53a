// Direct convolution for sm_90a: the Hopper counterpart of the Pallas
// kernel `direct_conv` in src/repro/kernels/direct_conv.py.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = (Hp - R) / stride + 1, stride 1 or 2, and the fused epilogue
// act(acc * scale + bias), converted once on the store.
//
// Direct keeps its own structure, the paper's pixel-major mapping with the
// filter bank as the operand held on chip. A CTA owns a band of output
// pixels, BH rows by the whole width (a row wider than 64 pixels is cut
// into equal segments), at most 64 pixels, and a 64-wide slab of output
// channels: grid (bands, K slabs, batch). The TPU kernel keeps the whole
// (R, S, C, K) bank resident in VMEM; a 3x3x512x512 fp32 bank is 9.4 MB and
// does not fit a block's 227 KB, so the CTA stages the bank's slab chunk
// by chunk of 32 rows of its flattened R*S*C contraction (row
// (r*S + s)*C + c, so a C of 3 is no special case) and reuses each staged
// chunk over every pixel of its band. The image is not staged: each
// thread reads its pixels' taps straight from device memory through L1,
// at the offset of the row's (r, s, c), from a table built with the chunk.
// That is the difference from ilpm_conv.cu, which stages a halo'd image
// tile and streams the filter past it.
//
// What bounds it: at ResNet-18's layers a launch does 0.12-0.23 GFLOP
// against 1-10 MB, so fp32 on CUDA cores is bound by the operations. Each
// thread keeps 4 pixels x 4 channels in fp32 registers, one IEEE fmaf
// chain per output (never TF32); the band's pixels come from L1 with one
// load per 4 FMAs.
#include "common.cuh"

namespace {

constexpr int BAND = 64;  // output pixels a CTA owns, at most
constexpr int TILE_K = 64;
constexpr int CHUNK = 32;  // contraction rows staged at a time
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) direct_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int Hp, int Wp, int C, int R, int S, int K, int H,
    int W, int stride, int TW, int BH, int act) {
  __shared__ float ws[CHUNK][TILE_K];
  __shared__ int offs[CHUNK];  // each row's (r, s, c) offset in the image
  const int segs = (W + TW - 1) / TW;
  const int oh0 = (blockIdx.x / segs) * BH;
  const int ow0 = (blockIdx.x % segs) * TW;
  const int k0 = blockIdx.y * TILE_K;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels k0 + tx + 16*j
  const int ty = tid / 16;  // band pixels ty + 16*i
  const T* xb = x + (size_t)b * Hp * Wp * C;

  int pbase[4];  // each pixel's top-left tap; 0 for a pixel off the band
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = ty + 16 * i;
    const int oh = oh0 + q / TW;
    const int ow = ow0 + q % TW;
    valid[i] = q < BH * TW && oh < H && ow < W;
    pbase[i] = valid[i] ? (oh * stride * Wp + ow * stride) * C : 0;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int rows = R * S * C;
  for (int j0 = 0; j0 < rows; j0 += CHUNK) {
    const int jn = min(CHUNK, rows - j0);
    for (int e = tid; e < CHUNK * TILE_K; e += THREADS) {
      const int k = e % TILE_K;
      const int j = e / TILE_K;
      float v = 0.f;
      if (j < jn && k0 + k < K) v = ilpm::to_f32(w[(size_t)(j0 + j) * K + k0 + k]);
      ws[j][k] = v;
    }
    if (tid < jn) {
      const int row = j0 + tid;
      const int tap = row / C;
      offs[tid] = ((tap / S) * Wp + tap % S) * C + row % C;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      const int off = offs[j];
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = ilpm::to_f32(xb[pbase[i] + off]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) wv[jj] = ws[j][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(xv[i], wv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!valid[i]) continue;
    const int q = ty + 16 * i;
    const int oh = oh0 + q / TW;
    const int ow = ow0 + q % TW;
    const size_t base = (((size_t)b * H + oh) * W + ow) * K;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int k = k0 + tx + 16 * jj;
      if (k >= K) continue;
      const float y = fmaf(acc[i][jj], scale[k], bias[k]);
      out[base + k] = ilpm::from_f32<T>(ilpm::apply_act(y, act));
    }
  }
}

template <typename T>
cudaError_t launch_direct(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int R, int S, int K, int H, int W,
                          int stride, int act, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || stride < 1 ||
      (H - 1) * stride + R > Hp || (W - 1) * stride + S > Wp)
    return cudaErrorInvalidValue;
  // the band: whole rows of W pixels, or equal segments of a wider row
  const int segs = (W + BAND - 1) / BAND;
  const int TW = (W + segs - 1) / segs;
  const int BH = BAND / TW;
  const dim3 grid(((H + BH - 1) / BH) * segs, (K + TILE_K - 1) / TILE_K, B);
  direct_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), Hp, Wp, C, R, S, K, H, W, stride, TW, BH, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" int direct_conv_launch(int dtype, const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int Hp, int Wp, int C,
                                  int R, int S, int K, int H, int W,
                                  int stride, int act, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_direct<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                   S, K, H, W, stride, act,
                                   static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
