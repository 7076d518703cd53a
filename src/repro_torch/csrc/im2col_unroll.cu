// im2col unroll for sm_90a: the Hopper counterpart of the Pallas kernel
// `im2col_unroll` in src/repro/kernels/im2col_conv.py:31 (im2col's first
// phase).
//
// x_padded (B, Hp, Wp, C) -> out (B, H*W, R*S*C) with H = Hp - R + 1,
// W = Wp - S + 1 (stride 1): row p = oh*W + ow, column (r*S + s)*C + c
// holds x_padded[b, oh + r, ow + s, c], the order of w.reshape(R*S*C, K).
//
// What bounds it on the H100: a pure copy whose output is R*S times its
// input, so the bytes written bound it (2.4 µs at 56²x64 fp32). That round
// trip through device memory is the algorithm's cost in the paper (Table
// 3), so it stays; the fused form is libdnn_conv.cu. The first kernel gave
// a thread one 16-byte unit of the whole output in a grid-stride loop, did
// four 64-bit and six 32-bit divisions by run-time values per unit, and
// fetched each input element R*S times through L1/L2: 2.6x its bound at
// 56²x64. Now:
// - a CTA owns (image, output row oh, a run of `pixels` output pixels, a
//   group of `channels` channels) from kernels/im2col_conv.py `plan` (shape
//   and dtype only); every coordinate comes from blockIdx and threadIdx,
//   one division a CTA (run and group of blockIdx.x), 32-bit offsets
//   inside it;
// - it stages its halo, R rows x (pixels + S - 1) columns x its channels,
//   in shared memory with cp.async, once: each input byte leaves L2 once a
//   CTA instead of R*S times;
// - it writes its patch rows from shared memory in units of 16 bytes
//   where the channel run allows (8, 4 or 2 else, `unit_bytes`),
//   neighbouring lanes on neighbouring units of one tap, so a warp's
//   stores are contiguous; the 3x3 filter (every site forced im2col
//   launches) has its taps' row and column known at compile time, other
//   filters take R and S at run time.
// One cp.async.bulk store of a CTA's rows (Hopper's bulk copy) measured
// slower than the threads' stores at every class (PERF.md §6).
// The copy moves bits and converts nothing: it equals its plain version
// bitwise.
#include "gemm_tile.cuh"

namespace {

// A unit is the widest of 16, 8, 4 and 2 bytes that divides a pixel's
// channel run and the addresses of both tensors, so a ragged channel count
// takes a narrower unit through the same template and the kernel carries
// no scalar path beside its vector one. cp.async has no 2-byte form, so
// that unit (a 16-bit tensor with an odd channel count) goes through a
// register.

// 8 bytes global -> shared.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One unit U global -> shared. The 2-byte unit is a plain load and store.
template <typename U>
__device__ __forceinline__ void stage_unit(U* dst, const U* src) {
  if constexpr (sizeof(U) == 16)
    cp_async16(dst, src, true);
  else if constexpr (sizeof(U) == 8)
    cp_async8(dst, src);
  else if constexpr (sizeof(U) == 4)
    cp_async4(dst, src, true);
  else
    *dst = *src;
}

// The widest unit, in bytes, that divides `run` bytes and both addresses.
inline int unit_bytes(int run, const void* a, const void* b) {
  for (int unit = 16; unit > 2; unit /= 2)
    if (run % unit == 0 && reinterpret_cast<uintptr_t>(a) % unit == 0 &&
        reinterpret_cast<uintptr_t>(b) % unit == 0)
      return unit;
  return 2;
}

// f(U{}) with U the unsigned type of `unit` bytes.
template <typename F>
cudaError_t with_unit(int unit, F&& f) {
  switch (unit) {
    case 16: return f(uint4{});
    case 8: return f(uint2{});
    case 4: return f(uint32_t{});
    default: return f(uint16_t{});
  }
}

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit, sm_90
constexpr int DEFAULT_SMEM = 48 * 1024;

// One launch's geometry, in units of U where it counts channels.
struct UnrollGeom {
  int Hp, Wp, C, R, S, H, W;  // C: units of a pixel's channels
  int pixels, cg, groups;     // a CTA's pixels and channel units; groups
  int hw;                     // halo columns: pixels + S - 1
};

// KR, KS: the filter at compile time (3x3), or 0 to read g.R, g.S.
template <typename U, int KR, int KS>
__global__ void __launch_bounds__(THREADS) unroll_kernel(
    UnrollGeom g, const U* __restrict__ x, U* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char unroll_smem[];
  U* xs = reinterpret_cast<U*>(unroll_smem);  // [r][column][cg]
  const int R = KR ? KR : g.R, S = KS ? KS : g.S, RS = R * S;
  const int run = blockIdx.x / g.groups;
  const int c0 = (blockIdx.x - run * g.groups) * g.cg;
  const int ow0 = run * g.pixels, oh = blockIdx.y;
  const int cn = min(g.cg, g.C - c0);         // this CTA's channel units
  const int np = min(g.pixels, g.W - ow0);    // and pixels
  const int hw = np + S - 1;                  // halo columns it reads
  // rows oh .. oh + R - 1 and columns ow0 .. ow0 + hw - 1 all lie in the
  // padded image: no predicate
  const U* xb = x + (((size_t)blockIdx.z * g.Hp + oh) * g.Wp + ow0) * g.C +
                c0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    for (int col = threadIdx.y; col < hw; col += blockDim.y)
      for (int c = threadIdx.x; c < cn; c += blockDim.x)
        stage_unit(xs + (r * g.hw + col) * g.cg + c,
                   xb + (r * g.Wp + col) * g.C + c);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  U* ob = out + (((size_t)blockIdx.z * g.H + oh) * g.W + ow0) * RS * g.C +
          c0;
  // patch row p, tap (r, s): halo row r, column p + s
#pragma unroll 4
  for (int j = threadIdx.y; j < np * RS; j += blockDim.y) {
    const int p = j / RS, tap = j - p * RS, r = tap / S, s = tap - r * S;
    const U* src = xs + (r * g.hw + p + s) * g.cg;
    U* dst = ob + j * g.C;
    for (int c = threadIdx.x; c < cn; c += blockDim.x) dst[c] = src[c];
  }
}

template <typename U>
cudaError_t launch_unroll(const void* x, void* out, UnrollGeom g, int B,
                          cudaStream_t stream) {
  const int RS = g.R * g.S;
  const size_t smem = (size_t)g.R * g.hw * g.cg * sizeof(U);
  const int runs = (g.W + g.pixels - 1) / g.pixels;
  if (smem > (size_t)MAX_SMEM || (long long)runs * g.groups > 0x7fffffff ||
      g.H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const int bx = std::min(g.cg, THREADS);
  const int by = std::max(1, std::min(THREADS / bx, g.pixels * RS));
  const dim3 grid(runs * g.groups, g.H, B), block(bx, by);
  const U* tx = static_cast<const U*>(x);
  U* to = static_cast<U*>(out);
  auto run = [&](auto kern) {
    if (smem > (size_t)DEFAULT_SMEM) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<grid, block, smem, stream>>>(g, tx, to);
    return cudaGetLastError();
  };
  return g.R == 3 && g.S == 3 ? run(unroll_kernel<U, 3, 3>)
                              : run(unroll_kernel<U, 0, 0>);
}

}  // namespace

// pixels, channels: a CTA's run of output pixels and its channels (all of
// C, or a multiple of 16 bytes' worth), from kernels/im2col_conv.py
// `plan`. The launch is refused where the halo does not fit shared
// memory.
extern "C" int im2col_unroll_launch(int dtype, const void* x, void* out,
                                    int B, int Hp, int Wp, int C, int R,
                                    int S, int H, int W, int pixels,
                                    int channels, void* stream) {
  int esize = 0;
  ILPM_DISPATCH_DTYPE(dtype, T, esize = (int)sizeof(T))
  if (!x || !out || B < 1 || C < 1 || R < 1 || S < 1 || H < 1 || W < 1 ||
      H != Hp - R + 1 || W != Wp - S + 1 || pixels < 1 || channels < 1 ||
      (channels < C && channels * esize % 16))
    return (int)cudaErrorInvalidValue;
  const int unit = unit_bytes(C * esize, x, out);
  channels = std::min(channels, C);
  UnrollGeom g;
  g.Hp = Hp; g.Wp = Wp; g.C = C * esize / unit; g.R = R; g.S = S;
  g.H = H; g.W = W; g.pixels = std::min(pixels, W);
  g.cg = channels * esize / unit;
  g.groups = (g.C + g.cg - 1) / g.cg;
  g.hw = g.pixels + S - 1;
  return (int)with_unit(unit, [&](auto u) {
    return launch_unroll<decltype(u)>(x, out, g, B,
                                      static_cast<cudaStream_t>(stream));
  });
}
