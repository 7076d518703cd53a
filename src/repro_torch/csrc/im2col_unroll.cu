// im2col unroll for sm_90a: the Hopper counterpart of the Pallas kernel
// `im2col_unroll` in src/repro/kernels/im2col_conv.py (im2col's first
// phase).
//
// x_padded (B, Hp, Wp, C) -> out (B, H*W, R*S*C) with H = Hp - R + 1,
// W = Wp - S + 1 (stride 1): row p = oh*W + ow, column (r*S + s)*C + c
// holds x_padded[b, oh + r, ow + s, c], the order of w.reshape(R*S*C, K).
//
// A pure copy, bound by bytes: the matrix is R*S times the image, and it is
// written to device memory for the gemm kernel to read back. That round
// trip is the algorithm's cost in the paper (Table 3), so it stays; the
// fused form is libdnn_conv.cu. Each thread moves one unit of a channel
// run, the widest of 16, 8, 4 or 2 bytes that divides the run's bytes and
// both pointers, so neighbouring lanes read neighbouring channels of one
// tap and write neighbouring columns of one row: both sides coalesce. The
// copy moves bits and converts nothing, so it equals its plain version
// bitwise.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// One unit of U per thread, in a grid-stride loop over the output; C is
// the channel run in units.
template <typename U>
__global__ void __launch_bounds__(THREADS) unroll_kernel(
    const U* __restrict__ x, U* __restrict__ out, int Hp, int Wp, int C,
    int R, int S, int H, int W, long long total) {
  const int cols = R * S * C;
  const int pixels = H * W;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * THREADS) {
    const int col = (int)(i % cols);
    const long long row = i / cols;  // b * H * W + p
    const int p = (int)(row % pixels);
    const long long b = row / pixels;
    const int c = col % C;
    const int tap = col / C;
    const int ih = p / W + tap / S;
    const int iw = p % W + tap % S;
    out[i] = x[((b * Hp + ih) * Wp + iw) * C + c];
  }
}

template <typename U>
cudaError_t launch_unroll(const void* x, void* out, int B, int Hp, int Wp,
                          int C, int R, int S, int H, int W,
                          cudaStream_t stream) {
  const long long total = (long long)B * H * W * R * S * C;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  unroll_kernel<U><<<grid, THREADS, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), Hp, Wp, C, R, S, H, W,
      total);
  return cudaGetLastError();
}

bool fits(const void* x, const void* out, int run_bytes, int unit) {
  return run_bytes % unit == 0 && (uintptr_t)x % unit == 0 &&
         (uintptr_t)out % unit == 0;
}

}  // namespace

extern "C" int im2col_unroll_launch(int dtype, const void* x, void* out,
                                    int B, int Hp, int Wp, int C, int R,
                                    int S, int H, int W, void* stream) {
  int esize = 0;
  ILPM_DISPATCH_DTYPE(dtype, T, esize = (int)sizeof(T))
  if (B < 1 || H < 1 || W < 1 || H != Hp - R + 1 || W != Wp - S + 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int run = C * esize;  // bytes of one tap's channels
  if (fits(x, out, run, 16))
    return (int)launch_unroll<uint4>(x, out, B, Hp, Wp, run / 16, R, S, H,
                                     W, st);
  if (fits(x, out, run, 8))
    return (int)launch_unroll<uint2>(x, out, B, Hp, Wp, run / 8, R, S, H,
                                     W, st);
  if (fits(x, out, run, 4))
    return (int)launch_unroll<uint32_t>(x, out, B, Hp, Wp, run / 4, R, S,
                                        H, W, st);
  return (int)launch_unroll<uint16_t>(x, out, B, Hp, Wp, run / 2, R, S, H,
                                      W, st);
}
