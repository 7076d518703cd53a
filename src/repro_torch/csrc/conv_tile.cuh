// The halo'd-tile convolution shared by ilpm_conv.cu and
// fused_residual_conv.cu.
//
// One CTA owns an 8x8 tile of output pixels, a 64-wide slab of output
// channels and one image. It walks the input channels in chunks of `cc`:
// for each chunk it stages the halo'd input tile ((8-1)*stride+R rows by
// (8-1)*stride+S columns) and the R*S*cc*64 filter slab in shared memory,
// converted to fp32, then every thread runs the whole R*S tap loop over
// the chunk for its 4 pixels x 4 channels. Each staged input element is
// reused by all 64 channels of the slab and each filter element by all 64
// pixels of the tile: the paper's one-filter-slab-per-image-tile ratio,
// with the tile cut to fit shared memory (a whole padded image does not).
//
// Accumulation is fp32 on CUDA-core FMAs (never TF32); the epilogue
// acc*scale + bias and the activation run in fp32 and the store converts
// once. With RES, the folded-BN result is converted to T first, then the
// shortcut `res` is added and the activation applied, as the reference's
// unfused act(conv(x) + identity) does in the compute dtype.
//
// Blocks are independent: the grid is (pixel tiles, K slabs, batch) and no
// block reads what another writes.
#pragma once

#include "common.cuh"

namespace ilpm {

constexpr int TILE_H = 8;
constexpr int TILE_W = 8;
constexpr int TILE_K = 64;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 pixels x 4 channels each
constexpr int FILTER_SMEM_BUDGET = 40 * 1024;  // bytes for the filter slab
constexpr int MAX_SMEM = 232448;  // a block's shared-memory limit on sm_90

template <typename T, bool RES>
__global__ void __launch_bounds__(THREADS) conv_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ out, int Hp, int Wp, int C,
    int R, int S, int K, int H, int W, int stride, int cc, int act) {
  extern __shared__ float smem[];
  const int IH = (TILE_H - 1) * stride + R;
  const int IW = (TILE_W - 1) * stride + S;
  float* xs = smem;                   // [IH][IW][cc]
  float* ws = smem + IH * IW * cc;    // [R*S][cc][TILE_K]

  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int oh0 = (blockIdx.x / tiles_w) * TILE_H;
  const int ow0 = (blockIdx.x % tiles_w) * TILE_W;
  const int k0 = blockIdx.y * TILE_K;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels k0 + tx + 16*j
  const int ty = tid / 16;  // tile pixels ty + 16*i
  const int ih0 = oh0 * stride;
  const int iw0 = ow0 * stride;
  const T* xb = x + (size_t)b * Hp * Wp * C;

  int poff[4];  // each pixel's top-left tap in the staged tile, per channel
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    poff[i] = ((p / TILE_W) * stride * IW + (p % TILE_W) * stride) * cc;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += cc) {
    const int cn = min(cc, C - c0);
    const int n_in = IH * IW * cc;
    for (int e = tid; e < n_in; e += THREADS) {
      const int c = e % cc;
      const int pix = e / cc;
      const int gh = ih0 + pix / IW;
      const int gw = iw0 + pix % IW;
      float v = 0.f;
      if (c < cn && gh < Hp && gw < Wp)
        v = to_f32(xb[((size_t)gh * Wp + gw) * C + c0 + c]);
      xs[e] = v;
    }
    const int n_w = R * S * cc * TILE_K;
    for (int e = tid; e < n_w; e += THREADS) {
      const int k = e % TILE_K;
      const int rc = e / TILE_K;
      const int c = rc % cc;
      const int rs = rc / cc;
      float v = 0.f;
      if (c < cn && k0 + k < K)
        v = to_f32(w[((size_t)rs * C + c0 + c) * K + k0 + k]);
      ws[e] = v;
    }
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      for (int s = 0; s < S; ++s) {
        const float* xt = xs + (r * IW + s) * cc;
        const float* wt = ws + (r * S + s) * cc * TILE_K + tx;
        for (int c = 0; c < cn; ++c) {
          float xv[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xt[poff[i] + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wt[c * TILE_K + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    const int oh = oh0 + p / TILE_W;
    const int ow = ow0 + p % TILE_W;
    if (oh >= H || ow >= W) continue;
    const size_t base = (((size_t)b * H + oh) * W + ow) * K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k >= K) continue;
      float y = fmaf(acc[i][j], scale[k], bias[k]);
      if (RES) y = to_f32(from_f32<T>(y)) + to_f32(res[base + k]);
      out[base + k] = from_f32<T>(apply_act(y, act));
    }
  }
}

// Input channels staged per chunk: as many as keep the filter slab within
// FILTER_SMEM_BUDGET, at most 32, rounded down to a multiple of 8 from 8 up.
inline int channel_chunk(int C, int R, int S) {
  int cc = FILTER_SMEM_BUDGET / (R * S * TILE_K * (int)sizeof(float));
  cc = cc < 1 ? 1 : cc;
  cc = cc > 32 ? 32 : cc;
  if (cc >= 8) cc -= cc % 8;
  return cc < C ? cc : C;
}

template <typename T, bool RES>
cudaError_t launch_conv_tile(const void* x, const void* w, const void* scale,
                             const void* bias, const void* res, void* out,
                             int B, int Hp, int Wp, int C, int R, int S, int K,
                             int H, int W, int stride, int act,
                             cudaStream_t stream) {
  const int cc = channel_chunk(C, R, S);
  const int IH = (TILE_H - 1) * stride + R;
  const int IW = (TILE_W - 1) * stride + S;
  const size_t smem = sizeof(float) * ((size_t)IH * IW * cc + (size_t)R * S * cc * TILE_K);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = conv_tile_kernel<T, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W),
                  (K + TILE_K - 1) / TILE_K, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), Hp, Wp, C, R, S, K,
      H, W, stride, cc, act);
  return cudaGetLastError();
}

}  // namespace ilpm
