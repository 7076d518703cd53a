// MobileNetV2 inverted residual in one launch for sm_90a: the Hopper
// counterpart of the Pallas kernel `fused_inverted_residual` in
// src/repro/kernels/fused_block.py.
//
// x (B, H, W, Cin) unpadded; w1 (Cin, mid) with s1/b1 (absent, a null
// pointer, for t == 1 blocks, where mid == Cin); wdw (R, S, mid) with
// sdw/bdw; w2 (mid, Cout) with s2/b2 -> out (B, OH, OW, Cout), OH =
// ceil(H / stride):
//   e = T(act(x . w1 * s1 + b1))            expand, at the input resolution
//   e = SAME pad of e, low first            exact zeros, after the act
//   d = T(act(dw(e) * sdw + bdw))           depthwise, stride 1 or 2
//   y = T(out_act(d . w2 * s2 + b2))        project
//   y = T(y + x)                            when residual (stride 1, Cin == Cout)
// Each stage casts to T where the per-layer kernels' writes cast.
//
// The TPU kernel holds the whole image and a whole expanded slab in VMEM
// and carries the projection sum in scratch from one grid step to the
// next. Neither carries over: s1b0's expanded 112x112x96 tensor is 4.8 MB
// in fp32, and Hopper blocks run in no order. Here one block owns a
// tile x tile patch of output pixels, every output channel and one image,
// and a loop over mid slabs of TM channels takes the place of the
// sequential grid axis:
//   1. stage the patch's input halo ((tile-1)*stride + R rows by
//      (tile-1)*stride + S columns, all Cin channels) in shared memory once;
//   2. per slab: expand the halo's pixels for the slab's TM channels
//      (positions outside the image are set to 0 after the activation:
//      the SAME padding of the expanded tensor), run the depthwise taps on
//      it, and add the slab's share of the projection to a shared fp32
//      accumulator (tile*tile x Cout);
//   3. after the last slab: the projection epilogue, the identity add from
//      the staged input, one store.
// Neighbouring blocks recompute their shared halo's expansion: that is the
// price of keeping the expanded tensor out of device memory. No atomics:
// each output is summed in a fixed order inside one block, so a batch of
// images gives bitwise the results of one image at a time.
//
// What bounds it on the H100: at MobileNetV2's shapes a block does 1-60
// MFLOP and moves under 3 MB, so in fp32 on CUDA cores the operations
// bound it. The expand and project stages are small matrix products; the
// lanes of a warp take neighbouring columns (filter loads coalesce, input
// loads broadcast) and each thread carries 4 rows. The wrapper
// (kernels/fused_block.py) picks the tile, 8, 4, 2 or 1, that minimises
// the estimated time per block, so the 7x7 blocks still spread over
// 49 blocks instead of 1.
//
// Shared memory, in fp32: halo (IH*IW*Cin) + w1 slab (Cin*TM) + expanded
// slab (IH*IW*TM) + depthwise slab (tile^2*TM) + w2 slab (TM*Cout) +
// accumulator (tile^2*Cout). The worst blocks: s5b0 (14x14, 96->576->160,
// stride 2) needs 86,528 bytes at tile 4 and 229,888 at tile 8; s6b0
// (7x7, 160->960->320) 111,616 at tile 4 and 228,352 at tile 8, just
// inside the 232,448 a block may use. The launch refuses a tile that
// does not fit.
//
// Arithmetic order: every sum is a chain of fmaf from 0 in index order
// (the projection's chain runs on across slabs through the shared
// accumulator), and every epilogue is fmaf(acc, scale, bias): the same as
// pointwise_conv.cu and depthwise_conv.cu, so the fused block is bitwise
// equal to the per-layer chain on the card.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 32;        // mid slab width; kernels/fused_block.py mirrors it
constexpr int GEMM_ROWS = 4;  // rows each thread carries in a block product
constexpr int MAX_SMEM = 232448;

// For every i < M, j < N: store(i, j, acc) with acc the fmaf chain
// acc = init(i, j); for k < K: acc = fmaf(A[i*lda + k], B[k*ldb + j], acc).
// Lanes take neighbouring columns, so B's loads coalesce and A's broadcast.
template <typename Init, typename Store>
__device__ __forceinline__ void block_gemm(int M, int N, int K,
                                           const float* A, int lda,
                                           const float* B, int ldb, Init init,
                                           Store store) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int col_groups = (N + 31) / 32;
  const int groups = ((M + GEMM_ROWS - 1) / GEMM_ROWS) * col_groups;
  for (int g = warp; g < groups; g += THREADS / 32) {
    const int i0 = (g / col_groups) * GEMM_ROWS;
    const int j = (g % col_groups) * 32 + lane;
    const int jc = j < N ? j : N - 1;  // idle lanes read a valid column
    const float* a[GEMM_ROWS];
    float acc[GEMM_ROWS];
#pragma unroll
    for (int r = 0; r < GEMM_ROWS; ++r) {
      const int i = min(i0 + r, M - 1);  // rows past M are computed, not stored
      a[r] = A + i * lda;
      acc[r] = init(i, jc);
    }
    for (int k = 0; k < K; ++k) {
      const float bv = B[k * ldb + jc];
#pragma unroll
      for (int r = 0; r < GEMM_ROWS; ++r) acc[r] = fmaf(a[r][k], bv, acc[r]);
    }
    if (j < N) {
#pragma unroll
      for (int r = 0; r < GEMM_ROWS; ++r)
        if (i0 + r < M) store(i0 + r, j, acc[r]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ilpm::to_f32(ilpm::from_f32<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) inverted_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const T* __restrict__ wdw, const float* __restrict__ sdw,
    const float* __restrict__ bdw, const T* __restrict__ w2,
    const float* __restrict__ s2, const float* __restrict__ b2,
    T* __restrict__ out, int H, int W, int Cin, int mid, int Cout, int R,
    int S, int stride, int OH, int OW, int pad_top, int pad_left, int tile,
    int act, int out_act, int residual) {
  extern __shared__ float smem[];
  const bool expanded = w1 != nullptr;
  const int IH = (tile - 1) * stride + R;
  const int IW = (tile - 1) * stride + S;
  const int NPI = IH * IW;    // halo positions
  const int NPO = tile * tile;  // output pixels
  float* xs = smem;                                 // [NPI][Cin]
  float* w1s = xs + NPI * Cin;                      // [Cin][TM]
  float* es = w1s + (expanded ? Cin * TM : 0);      // [NPI][TM]
  float* ds = es + NPI * TM;                        // [NPO][TM]
  float* w2s = ds + NPO * TM;                       // [TM][Cout]
  float* accs = w2s + TM * Cout;                    // [NPO][Cout]

  const int tiles_w = (OW + tile - 1) / tile;
  const int oh0 = (blockIdx.x / tiles_w) * tile;
  const int ow0 = (blockIdx.x % tiles_w) * tile;
  const int b = blockIdx.y;
  const int ih0 = oh0 * stride - pad_top;  // the halo's top-left in x
  const int iw0 = ow0 * stride - pad_left;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)b * H * W * Cin;

  auto inside = [&](int p) {
    const int gh = ih0 + p / IW;
    const int gw = iw0 + p % IW;
    return gh >= 0 && gh < H && gw >= 0 && gw < W;
  };

  for (int e = tid; e < NPI * Cin; e += THREADS) {
    const int p = e / Cin;
    float v = 0.f;
    if (inside(p)) {
      const int gh = ih0 + p / IW;
      const int gw = iw0 + p % IW;
      v = ilpm::to_f32(xb[((size_t)gh * W + gw) * Cin + e % Cin]);
    }
    xs[e] = v;
  }

  for (int m0 = 0; m0 < mid; m0 += TM) {
    const int tm = min(TM, mid - m0);
    if (expanded) {
      for (int e = tid; e < Cin * TM; e += THREADS) {
        const int m = e % TM;
        w1s[e] = m < tm ? ilpm::to_f32(w1[(size_t)(e / TM) * mid + m0 + m])
                        : 0.f;
      }
    }
    for (int e = tid; e < TM * Cout; e += THREADS) {
      const int m = e / Cout;
      w2s[e] = m < tm ? ilpm::to_f32(w2[(size_t)(m0 + m) * Cout + e % Cout])
                      : 0.f;
    }
    __syncthreads();

    // 1. expand this slab over the halo; outside the image an exact 0
    if (expanded) {
      block_gemm(
          NPI, tm, Cin, xs, Cin, w1s, TM, [](int, int) { return 0.f; },
          [&](int p, int m, float acc) {
            es[p * TM + m] =
                inside(p) ? round_to<T>(ilpm::apply_act(
                                fmaf(acc, s1[m0 + m], b1[m0 + m]), act))
                          : 0.f;
          });
    } else {  // t == 1: the slab is the input itself
      for (int e = tid; e < NPI * TM; e += THREADS) {
        const int m = e % TM;
        es[e] = m < tm ? xs[(e / TM) * Cin + m0 + m] : 0.f;
      }
    }
    __syncthreads();

    // 2. depthwise taps over the expanded slab
    for (int e = tid; e < NPO * TM; e += THREADS) {
      const int m = e % TM;
      if (m >= tm) continue;
      const int q = e / TM;
      const float* eq =
          es + ((q / tile) * stride * IW + (q % tile) * stride) * TM + m;
      float acc = 0.f;
      for (int r = 0; r < R; ++r)
        for (int s = 0; s < S; ++s)
          acc = fmaf(eq[(r * IW + s) * TM],
                     ilpm::to_f32(wdw[(r * S + s) * mid + m0 + m]), acc);
      ds[e] = round_to<T>(
          ilpm::apply_act(fmaf(acc, sdw[m0 + m], bdw[m0 + m]), act));
    }
    __syncthreads();

    // 3. this slab's share of the projection, chained onto the earlier ones
    block_gemm(
        NPO, Cout, tm, ds, TM, w2s, Cout,
        [&](int q, int n) { return m0 == 0 ? 0.f : accs[q * Cout + n]; },
        [&](int q, int n, float acc) { accs[q * Cout + n] = acc; });
    __syncthreads();
  }

  for (int e = tid; e < NPO * Cout; e += THREADS) {
    const int q = e / Cout;
    const int n = e % Cout;
    const int oh = oh0 + q / tile;
    const int ow = ow0 + q % tile;
    if (oh >= OH || ow >= OW) continue;
    float y = ilpm::apply_act(fmaf(accs[e], s2[n], b2[n]), out_act);
    if (residual) {  // stride 1: output (oh, ow) reads the staged x(oh, ow)
      const int p = (q / tile + pad_top) * IW + q % tile + pad_left;
      y = round_to<T>(y) + xs[p * Cin + n];
    }
    out[(((size_t)b * OH + oh) * OW + ow) * Cout + n] = ilpm::from_f32<T>(y);
  }
}

template <typename T>
cudaError_t launch_inverted_residual(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* wdw, const void* sdw, const void* bdw, const void* w2,
    const void* s2, const void* b2, void* out, int B, int H, int W, int Cin,
    int mid, int Cout, int R, int S, int stride, int tile, int act,
    int out_act, int residual, cudaStream_t stream) {
  const bool expanded = w1 != nullptr;
  if (tile < 1 || stride < 1 || (!expanded && mid != Cin) ||
      (residual && (stride != 1 || Cin != Cout)))
    return cudaErrorInvalidValue;
  const int OH = (H + stride - 1) / stride;
  const int OW = (W + stride - 1) / stride;
  const int ph = max((OH - 1) * stride + R - H, 0);
  const int pw = max((OW - 1) * stride + S - W, 0);
  const size_t IH = (size_t)(tile - 1) * stride + R;
  const size_t IW = (size_t)(tile - 1) * stride + S;
  const size_t NPI = IH * IW;
  const size_t NPO = (size_t)tile * tile;
  const size_t smem =
      sizeof(float) * (NPI * Cin + (expanded ? (size_t)Cin * TM : 0) +
                       NPI * TM + NPO * TM + (size_t)TM * Cout + NPO * Cout);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = inverted_residual_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((OH + tile - 1) / tile) * ((OW + tile - 1) / tile), B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(wdw), static_cast<const float*>(sdw),
      static_cast<const float*>(bdw), static_cast<const T*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<T*>(out), H, W, Cin, mid, Cout, R, S, stride, OH, OW,
      ph / 2, pw / 2, tile, act, out_act, residual);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_inverted_residual_launch(
    int dtype, const void* x, const void* w1, const void* s1, const void* b1,
    const void* wdw, const void* sdw, const void* bdw, const void* w2,
    const void* s2, const void* b2, void* out, int B, int H, int W, int Cin,
    int mid, int Cout, int R, int S, int stride, int tile, int act,
    int out_act, int residual, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_inverted_residual<T>(
          x, w1, s1, b1, wdw, sdw, bdw, w2, s2, b2, out, B, H, W, Cin, mid,
          Cout, R, S, stride, tile, act, out_act, residual,
          static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
