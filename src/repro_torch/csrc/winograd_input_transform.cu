// Winograd F(2x2,3x3) input transform for sm_90a: the Hopper counterpart of
// the Pallas kernel `winograd_input_transform` in
// src/repro/kernels/winograd_conv.py:55.
//
// x_padded (B, H+2, W+2, C) -> V (B, 4, 4, nt, C), nt = (H/2)(W/2) tiles
// row-major over (tile row, tile column): V[b, a, e, t, c] is (Bᵀ d B)[a][e]
// of the 4x4 window d at (2i, 2j) of image b, channel c, for t = i*(W/2)+j.
//
// What bounds it: add/sub only (no multiply), and each window is read once
// per tile (16 reads for 4 outputs, the windows overlap by half), so bytes
// bound it: V is 4x the image. The TPU kernel stages a whole padded image
// in VMEM; a 58x58x64 fp32 image is 0.86 MB against 227 KB of shared
// memory, and nothing here is reused across tiles beyond what L1 and L2
// hold, so no shared memory is used at all: on the H100 a tile block's
// halo staged with cp.async and 16-byte channel vectors measured slower
// than this (PERF.md §6), since L1 already serves the windows' overlap.
// One thread owns one (image, tile, channel): neighbouring lanes take
// neighbouring channels, so its 16 loads and 16 stores coalesce along C in
// NHWC. It combines rows then columns in the plain version's order, each
// add or subtract in the input dtype with one round-to-nearest, as the
// Pallas kernel computes it (16-bit values through the hardware's bf16 or
// fp16 add, which needs no conversion), so the two agree bitwise, and
// stores each V value as it is.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// One add or subtract in T, rounded to nearest once.
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __hadd(a, b);
}
__device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __hsub(a, b);
}
__device__ __forceinline__ __half add(__half a, __half b) {
  return __hadd(a, b);
}
__device__ __forceinline__ __half sub(__half a, __half b) {
  return __hsub(a, b);
}

template <typename T>
__device__ __forceinline__ void bt_combine(T d0, T d1, T d2, T d3, T* o) {
  o[0] = sub(d0, d2);
  o[1] = add(d1, d2);
  o[2] = sub(d2, d1);
  o[3] = sub(d1, d3);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) input_transform_kernel(
    const T* __restrict__ x, T* __restrict__ v, int Hp, int Wp, int C,
    int tw, int nt, long long total) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * THREADS) {
    const int c = (int)(i % C);
    const long long bt = i / C;  // b * nt + t
    const int t = (int)(bt % nt);
    const long long b = bt / nt;
    const int h0 = 2 * (t / tw);
    const int w0 = 2 * (t % tw);
    const T* xb = x + ((b * Hp + h0) * Wp + w0) * C + c;
    T d[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) d[r][s] = xb[((long long)r * Wp + s) * C];
    // rows: rw[a][s] = sum_r Bᵀ[a][r] d[r][s]
    T rw[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      T o[4];
      bt_combine(d[0][s], d[1][s], d[2][s], d[3][s], o);
#pragma unroll
      for (int a = 0; a < 4; ++a) rw[a][s] = o[a];
    }
    // columns, then one store per value: V[b, a, e, t, c]
    T* vb = v + (b * 16 * nt + t) * C + c;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      T o[4];
      bt_combine(rw[a][0], rw[a][1], rw[a][2], rw[a][3], o);
#pragma unroll
      for (int e = 0; e < 4; ++e) vb[(long long)(a * 4 + e) * nt * C] = o[e];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* v, int B, int Hp, int Wp, int C,
                   cudaStream_t stream) {
  const int th = (Hp - 2) / 2, tw = (Wp - 2) / 2;
  const int nt = th * tw;
  const long long total = (long long)B * nt * C;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 64 ? blocks : 132 * 64);
  input_transform_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(v), Hp, Wp, C, tw, nt,
      total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int winograd_input_transform_launch(int dtype, const void* x,
                                               void* v, int B, int Hp,
                                               int Wp, int C, void* stream) {
  if (B < 1 || C < 1 || Hp < 4 || Wp < 4 || Hp % 2 || Wp % 2)
    return (int)cudaErrorInvalidValue;
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch<T>(x, v, B, Hp, Wp, C,
                            static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
