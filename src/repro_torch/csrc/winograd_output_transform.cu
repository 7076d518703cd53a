// Winograd F(2x2,3x3) output transform for sm_90a: the Hopper counterpart
// of the Pallas kernel `winograd_output_transform` in
// src/repro/kernels/winograd_conv.py:97, with its fused (scale, bias, act)
// epilogue.
//
// M (B, 4, 4, nt, K) -> y (B, H, W, K), nt = (H/2)(W/2): tile t = i*(W/2)+j
// of image b, channel k, reads its 16 values M[b, :, :, t, k] as fp32,
// computes Aᵀ m A (rows then columns, left to right, as the plain version
// does), applies act(fmaf(y, scale[k], bias[k])) in fp32 (one rounding, as
// the Pallas kernel's epilogue compiles) and writes the 2x2 block at
// (2i, 2j) with one cast each, in the dtype of M. So it equals its plain
// version bitwise in every dtype.
//
// What bounds it: add/sub and one multiply-add an output, so bytes bound
// it: M is 4x the output (4.0 MB at 56²x64 fp32, 1.2 µs). The TPU kernel
// holds one image's whole M block in VMEM; here nothing is re-read (each M
// value is read once), so no shared memory is used. The first kernel gave
// a thread one scalar (image, tile, channel) of a grid-stride loop, with
// four 64-bit divisions before its first load, 2-byte loads in 16 bits,
// and 49-98 CTAs at ResNet-18's two deep classes on 132 SMs. Now:
// - a CTA owns a block of `tiles` tiles x a group of `channels` channels
//   of one image, from kernels/winograd_conv.py `plan` (shape and dtype
//   only); blockIdx gives the tile block, the group and the image,
//   threadIdx.y the tile and threadIdx.x the channel unit: no division
//   before the loads, 32-bit offsets inside an image;
// - a thread moves a unit of `unit` bytes of channels (16, 8, 4 or 2, the
//   widest the plan picks that divides K's bytes, narrowed where an
//   address is not a multiple of it) through one template per unit, so a
//   ragged K takes a narrower unit and never a scalar branch;
// - lanes take neighbouring channel units of a tile, so each of the 16
//   loads (one an (a, e) plane of M) and the 4 stores coalesce along K.
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// One launch's geometry, in units of U where it counts channels.
struct OutGeom {
  int H, W, tw, nt;  // output size, tiles a row, tiles an image
  int K;             // channel units of a pixel
  int tiles, cg;     // a CTA's tiles and channel units
  int act;
};

template <typename T, typename U>
__host__ __device__ constexpr int lanes() {
  return (int)(sizeof(U) / sizeof(T));
}

// The elements of a unit as fp32, and back with one rounding each.
template <typename T, typename U>
__device__ __forceinline__ void unpack(U u, float* f) {
  T v[lanes<T, U>()];
  memcpy(v, &u, sizeof(U));
#pragma unroll
  for (int n = 0; n < lanes<T, U>(); ++n) f[n] = ilpm::to_f32(v[n]);
}

template <typename T, typename U>
__device__ __forceinline__ U pack(const float* f) {
  T v[lanes<T, U>()];
#pragma unroll
  for (int n = 0; n < lanes<T, U>(); ++n) v[n] = ilpm::from_f32<T>(f[n]);
  U u;
  memcpy(&u, v, sizeof(U));
  return u;
}

template <typename T, typename U>
__global__ void __launch_bounds__(MAX_THREADS) output_transform_kernel(
    OutGeom g, const U* __restrict__ m, const float* __restrict__ scale,
    const float* __restrict__ bias, U* __restrict__ y) {
  constexpr int N = lanes<T, U>();
  const int t = blockIdx.x * g.tiles + threadIdx.y;
  if (t >= g.nt) return;
  const int plane = g.nt * g.K;  // units of one (a, e) plane of an image
  const U* mb = m + (size_t)blockIdx.z * 16 * plane + t * g.K;
  const int i = t / g.tw, j = t - i * g.tw;
  U* yb = y + (size_t)blockIdx.z * g.H * g.W * g.K +
          (2 * i * g.W + 2 * j) * g.K;
  const int c1 = (blockIdx.y + 1) * g.cg;
  // one pass where blockDim.x is the group (every plan); more where the
  // launch narrowed the unit below the plan's
  for (int c = blockIdx.y * g.cg + threadIdx.x; c < c1; c += blockDim.x) {
    U raw[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) raw[q] = __ldg(mb + q * plane + c);
    float sc[N], bi[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      sc[n] = __ldg(scale + c * N + n);
      bi[n] = __ldg(bias + c * N + n);
    }
    float mv[4][4][N];
#pragma unroll
    for (int q = 0; q < 16; ++q) unpack<T, U>(raw[q], mv[q / 4][q % 4]);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float o[2][N];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        // rows: r[e] = sum_x Aᵀ[a][x] m[x][e], then the columns
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = a == 0 ? mv[0][e][n] + mv[1][e][n] + mv[2][e][n]
                        : mv[1][e][n] - mv[2][e][n] - mv[3][e][n];
        o[0][n] = ilpm::apply_act(
            fmaf(r[0] + r[1] + r[2], sc[n], bi[n]), g.act);
        o[1][n] = ilpm::apply_act(
            fmaf(r[1] - r[2] - r[3], sc[n], bi[n]), g.act);
      }
      yb[a * g.W * g.K + c] = pack<T, U>(o[0]);
      yb[(a * g.W + 1) * g.K + c] = pack<T, U>(o[1]);
    }
  }
}

inline bool aligned(const void* p, int unit) {
  return reinterpret_cast<uintptr_t>(p) % unit == 0;
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

template <typename T>
cudaError_t launch(const void* m, const float* scale, const float* bias,
                   void* y, int B, int H, int W, int K, int act, int tiles,
                   int channels, int unit, cudaStream_t stream) {
  const int esize = (int)sizeof(T);
  // the plan's unit, or the widest narrower one both addresses allow
  int u = unit;
  while (u > esize && !(aligned(m, u) && aligned(y, u))) u /= 2;
  if (!aligned(m, u) || !aligned(y, u)) return cudaErrorInvalidValue;
  OutGeom g;
  g.H = H; g.W = W; g.tw = W / 2; g.nt = (H / 2) * g.tw;
  g.K = K * esize / u;
  g.tiles = tiles;
  g.cg = channels * esize / u;
  g.act = act;
  // the plan's threads: its tiles x its channel units
  const int bx = std::min(channels * esize / unit, MAX_THREADS);
  if (bx * tiles > MAX_THREADS || 16LL * g.nt * g.K > 0x7fffffffLL ||
      (long long)H * W * g.K > 0x7fffffffLL || K / channels > 65535 ||
      B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((g.nt + tiles - 1) / tiles, K / channels, B),
      block(bx, tiles);
  return with_unit(u, [&](auto unit_type) {
    using U = decltype(unit_type);
    if constexpr (sizeof(U) < sizeof(T)) {
      return cudaErrorInvalidValue;
    } else {
      output_transform_kernel<T, U><<<grid, block, 0, stream>>>(
          g, static_cast<const U*>(m), scale, bias, static_cast<U*>(y));
      return cudaGetLastError();
    }
  });
}

}  // namespace

// tiles, channels, unit: a CTA's tiles and channels (all of K or a group
// dividing it) and the bytes of channels a thread moves, from
// kernels/winograd_conv.py `plan`.
extern "C" int winograd_output_transform_launch(
    int dtype, const void* m, const void* scale, const void* bias, void* y,
    int B, int H, int W, int K, int act, int tiles, int channels, int unit,
    void* stream) {
  int esize = 0;
  ILPM_DISPATCH_DTYPE(dtype, T, esize = (int)sizeof(T))
  if (!m || !scale || !bias || !y || B < 1 || K < 1 || H < 2 || W < 2 ||
      H % 2 || W % 2 || tiles < 1 || channels < 1 || K % channels ||
      unit < esize || unit > 16 || (unit & (unit - 1)) ||
      channels * esize % unit)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch<T>(m, static_cast<const float*>(scale),
                            static_cast<const float*>(bias), y, B, H, W, K,
                            act, tiles, channels, unit,
                            static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
