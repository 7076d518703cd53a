// Depthwise causal 1-D conv for sm_90a: the Hopper counterpart of the
// Pallas kernel `causal_conv1d` in src/repro/kernels/causal_conv1d.py, the
// conv stem of every Mamba-2 layer.
//
// x (B, L, C) with its channels contiguous, rows `row_stride` elements
// apart and batches `batch_stride` apart, w (K, C), an optional bias (C,)
//   -> out (B, L, C) contiguous,
// out[b, t, c] = sum over j < K of x[b, t - K + 1 + j, c] * w[j, c], plus
// bias[c], with x = 0 before t = 0. The strides let the kernel read the xBC
// slice of Mamba's in-projection in place (row stride 4384 against C = 2304
// at mamba2-370m's width) instead of a copy.
//
// Bound by bytes: K multiplies and adds per output against one input read
// and one output write, about 0.5 operations per byte at K = 4 in bf16.
// The TPU kernel stages a sequence tile and the previous tile in VMEM to
// get its K - 1 halo; here nothing is staged. A thread owns V = 2 (or 1)
// neighbouring channels and walks TL time steps: the K weights and the
// bias sit in registers, and the K - 1 halo steps and the tile's TL steps
// are loaded into a register window before any arithmetic, so every input
// is read once (plus the halo, an L2 hit on the neighbouring tile's rows)
// and the TL + K - 1 loads are in flight together. Lanes run along C, so
// every load and store of a warp coalesces. The grid is (channel groups,
// L tiles, batch): at B = 1, L = 300, C = 2304 that is 171 blocks for the
// card's 132 SMs.
//
// Each output is computed as the plain version computes it: a chain of
// separately rounded fp32 multiplies and adds in tap order from 0, then
// the bias, then one cast on the store, so the two agree bitwise.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // channel groups per block
constexpr int TL = 16;        // time steps per thread
constexpr int MAX_K = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V, int K>
__global__ void __launch_bounds__(THREADS) causal_conv1d_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int L, int C,
    long long batch_stride, long long row_stride) {
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (c0 >= C) return;
  const int t0 = blockIdx.y * TL;
  const T* xb = x + blockIdx.z * batch_stride + c0;
  T* ob = out + (long long)blockIdx.z * L * C + c0;

  float wr[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const Pack<T, V> p =
        *reinterpret_cast<const Pack<T, V>*>(w + (long long)j * C + c0);
#pragma unroll
    for (int v = 0; v < V; ++v) wr[j][v] = ilpm::to_f32(p.v[v]);
  }
  float br[V];
#pragma unroll
  for (int v = 0; v < V; ++v) br[v] = 0.f;
  if (bias != nullptr) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(bias + c0);
#pragma unroll
    for (int v = 0; v < V; ++v) br[v] = ilpm::to_f32(p.v[v]);
  }

  // the window: K - 1 halo steps, then the tile's TL steps
  float xs[K - 1 + TL][V];
#pragma unroll
  for (int i = 0; i < K - 1 + TL; ++i) {
    const int t = t0 - (K - 1) + i;
    if (t >= 0 && t < L) {
      const Pack<T, V> p =
          *reinterpret_cast<const Pack<T, V>*>(xb + t * row_stride);
#pragma unroll
      for (int v = 0; v < V; ++v) xs[i][v] = ilpm::to_f32(p.v[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) xs[i][v] = 0.f;
    }
  }

#pragma unroll
  for (int i = 0; i < TL; ++i) {
    const int t = t0 + i;
    if (t < L) {
      Pack<T, V> o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc = __fadd_rn(acc, __fmul_rn(xs[i + j][v], wr[j][v]));
        if (bias != nullptr) acc = __fadd_rn(acc, br[v]);
        o.v[v] = ilpm::from_f32<T>(acc);
      }
      *reinterpret_cast<Pack<T, V>*>(ob + (long long)t * C) = o;
    }
  }
}

template <typename T, int V, int K>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int B, int L, int C, long long batch_stride,
                   long long row_stride, cudaStream_t stream) {
  const dim3 grid((C / V + THREADS - 1) / THREADS, (L + TL - 1) / TL, B);
  causal_conv1d_kernel<T, V, K><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), L, C, batch_stride,
      row_stride);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_taps(int K, const void* x, const void* w,
                        const void* bias, void* out, int B, int L, int C,
                        long long batch_stride, long long row_stride,
                        cudaStream_t stream) {
#define ILPM_CC1D_TAPS(N)                                                   \
  case N:                                                                   \
    return launch<T, V, N>(x, w, bias, out, B, L, C, batch_stride,         \
                           row_stride, stream);
  switch (K) {
    ILPM_CC1D_TAPS(1) ILPM_CC1D_TAPS(2) ILPM_CC1D_TAPS(3) ILPM_CC1D_TAPS(4)
    ILPM_CC1D_TAPS(5) ILPM_CC1D_TAPS(6) ILPM_CC1D_TAPS(7) ILPM_CC1D_TAPS(8)
  }
#undef ILPM_CC1D_TAPS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_vec(int vec, int K, const void* x, const void* w,
                       const void* bias, void* out, int B, int L, int C,
                       long long batch_stride, long long row_stride,
                       cudaStream_t stream) {
  if (B < 1 || L < 1 || C < 1 || K < 1 || K > MAX_K || B > 65535 ||
      (L + TL - 1) / TL > 65535)
    return cudaErrorInvalidValue;
  if (vec == 2 && C % 2 == 0)
    return launch_taps<T, 2>(K, x, w, bias, out, B, L, C, batch_stride,
                             row_stride, stream);
  if (vec == 1)
    return launch_taps<T, 1>(K, x, w, bias, out, B, L, C, batch_stride,
                             row_stride, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// vec = 2 needs C even, every pointer aligned to two elements and both
// strides even; the wrapper checks that and passes 1 otherwise. `bias`
// may be null.
extern "C" int causal_conv1d_launch(int dtype, const void* x, const void* w,
                                    const void* bias, void* out, int B, int L,
                                    int C, int K, long long batch_stride,
                                    long long row_stride, int vec,
                                    void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_vec<T>(vec, K, x, w, bias, out, B, L, C,
                                batch_stride, row_stride,
                                static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
