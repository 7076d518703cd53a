// libdnn-style fused im2col convolution for sm_90a: the Hopper counterpart
// of the Pallas kernel `libdnn_conv` in src/repro/kernels/libdnn_conv.py.
//
// x_padded (B, Hp, Wp, C), w (R, S, C, K) -> out (B, H, W, K) with
// H = Hp - R + 1 (stride 1) and the fused epilogue act(acc * scale + bias),
// converted once on the store.
//
// im2col and the product in one kernel. A CTA owns a flat run of 64 output
// pixels and a 64-wide slab of output channels: grid (pixel tiles, K
// tiles, batch). It walks the R*S*C contraction in chunks of 32 columns;
// for each chunk it builds the patch tile (64 pixels x 32 columns) in
// shared memory, gathering each element from the padded image with the
// (r, s, c)-from-column index math, stages the filter chunk (32 rows x 64
// channels), and contracts. The patch never reaches device memory, but
// every K tile rebuilds it, gathers and index math included: that repeat
// is the paper's critique of libdnn, and it stays.
//
// What bounds it: at the paper's four layers a launch does 0.23 GFLOP
// against 1-10 MB, so fp32 on CUDA cores is bound by the operations. Each
// thread keeps 4 pixels x 4 channels in fp32 registers, one IEEE fmaf
// chain per output in column order (never TF32).
#include "common.cuh"

namespace {

constexpr int TILE_P = 64;
constexpr int TILE_K = 64;
constexpr int CHUNK = 32;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) libdnn_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out, int Hp, int Wp, int C, int R, int S, int K, int H,
    int W, int act) {
  // +1 on the patch rows keeps the two rows a warp reads on different banks.
  __shared__ float ps[TILE_P][CHUNK + 1];
  __shared__ float ws[CHUNK][TILE_K];
  const int P = H * W;
  const int p0 = blockIdx.x * TILE_P;
  const int k0 = blockIdx.y * TILE_K;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels k0 + tx + 16*j
  const int ty = tid / 16;  // pixels p0 + ty + 16*i
  const T* xb = x + (size_t)b * Hp * Wp * C;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int cols = R * S * C;
  for (int j0 = 0; j0 < cols; j0 += CHUNK) {
    const int jn = min(CHUNK, cols - j0);
    for (int e = tid; e < TILE_P * CHUNK; e += THREADS) {
      const int j = e % CHUNK;
      const int p = e / CHUNK;
      const int q = p0 + p;
      float v = 0.f;
      if (j < jn && q < P) {
        const int col = j0 + j;
        const int tap = col / C;
        const int ih = q / W + tap / S;
        const int iw = q % W + tap % S;
        v = ilpm::to_f32(xb[((size_t)ih * Wp + iw) * C + col % C]);
      }
      ps[p][j] = v;
    }
    for (int e = tid; e < CHUNK * TILE_K; e += THREADS) {
      const int k = e % TILE_K;
      const int j = e / TILE_K;
      float v = 0.f;
      if (j < jn && k0 + k < K) v = ilpm::to_f32(w[(size_t)(j0 + j) * K + k0 + k]);
      ws[j][k] = v;
    }
    __syncthreads();
    for (int j = 0; j < jn; ++j) {
      float pv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[ty + 16 * i][j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) wv[jj] = ws[j][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(pv[i], wv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = p0 + ty + 16 * i;
    if (q >= P) continue;
    const size_t base = ((size_t)b * P + q) * K;
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
cudaError_t launch_libdnn(const void* x, const void* w, const void* scale,
                          const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int R, int S, int K, int H, int W, int act,
                          cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H != Hp - R + 1 || W != Wp - S + 1)
    return cudaErrorInvalidValue;
  const dim3 grid((H * W + TILE_P - 1) / TILE_P, (K + TILE_K - 1) / TILE_K,
                  B);
  libdnn_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), Hp, Wp, C, R, S, K, H, W, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" int libdnn_conv_launch(int dtype, const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int B, int Hp, int Wp, int C,
                                  int R, int S, int K, int H, int W, int act,
                                  void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_libdnn<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                   S, K, H, W, act,
                                   static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
