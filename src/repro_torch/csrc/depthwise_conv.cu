// Depthwise convolution for sm_90a: the Hopper counterpart of the Pallas
// kernel `depthwise_conv` in src/repro/kernels/depthwise_conv.py:61.
//
// x_padded (B, Hp, Wp, C), w (R, S, 1, K) with K = M * C -> out (B, H, W, K),
// H = (Hp - R) / stride + 1; output channel k reads input channel k / M.
// Epilogue act(acc * scale + bias), converted once on the store.
//
// What bounds it on the H100: R*S FMAs per output against about one input
// and one output element, so the bytes bound it at every MobileNetV2 shape
// (0.2-1.8 µs at 3.35 TB/s). The first kernel gave a thread one output
// element with 4-byte loads, knew R and S only at run time (a chain of
// dependent load-then-fmaf steps), re-read every input through L1 from up
// to 9 threads, divided on every thread and took 1.4-2.6x cuDNN. Now:
// - a CTA owns tile_h x tile_w output pixels x `channels` output channels
//   of one image, from kernels/depthwise_conv.py `plan` (shape and dtype
//   only, never the batch). It stages the tile's input halo once in shared
//   memory with cp.async in 16-byte runs (predicated scalar copies where C
//   is not a multiple of 16 bytes' worth or x is unaligned), so device
//   memory gives each input element once a tile, plus the halo;
// - a thread takes a vector of V channels (4 fp32, 8 bf16/fp16: 16 bytes
//   of shared memory a read, one 16-byte store a pixel) and PX = 2
//   neighbouring output pixels of one row;
// - the 3x3 kernel (every MobileNetV2 site: M = 1, C a multiple of V,
//   every operand 16-byte aligned, the stride a template argument) keeps
//   its channels' nine weights, scale and bias in registers, unrolls the
//   taps and streams each halo row of its pixels through registers once,
//   every input feeding each of the thread's outputs that reads it: the
//   3-wide window slides in registers. The generic kernel takes every
//   other shape (any R, S, M, stride and C), its weights from global
//   memory (L1), each tap's read once for the thread's pixels;
// - no division in the tap loop.
//
// Each output is the chain of the first kernel and of the depthwise stage
// of fused_inverted_residual.cu: acc = 0, fmaf over the taps r-major,
// s-inner, then act(fmaf(acc, scale, bias)) and one cast on the store. A
// thread interleaves the chains of its outputs but never reorders one, so
// the per-layer and the fused MobileNetV2 give bitwise equal fp32 results.
#include "gemm_tile.cuh"

namespace {

constexpr int DW_MAX_THREADS = 256;  // threads a CTA at most
constexpr int DW_MAX_SMEM = 232448;  // a block's shared-memory limit, sm_90
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int PX = 2;  // output pixels a thread, along a row

// One launch's geometry, as the launcher derives it.
struct DwGeom {
  int Hp, Wp, C, K, M, R, S, H, W, stride, act;
  int tile_h, tile_w, cg;  // the output tile and its channels
  int ih, iw;              // the halo's rows and columns
  int tiles_w, groups;     // tiles along a row, channel groups
  bool vec_x, pair_x, vec_out;
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes as V = 16 / sizeof(T) fp32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  } else {
    const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f;
      if constexpr (std::is_same_v<T, __half>)
        f = __half22float2(*reinterpret_cast<const __half2*>(&q[j]));
      else
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&q[j]));
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

// V elements of global memory from p as fp32, zeros from `valid` on.
template <typename T>
__device__ __forceinline__ void load_global(const T* p, int valid,
                                            float* v) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = j < valid ? ilpm::to_f32(p[j]) : 0.f;
}

// The V outputs of one pixel, each converted once: one 16-byte store where
// `vec` (K a multiple of V, out aligned), else the first `valid` ones.
template <typename T>
__device__ __forceinline__ void store_out(T* p, const float* y, int valid,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && valid >= V) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = ilpm::from_f32<T>(y[j]);
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (j < valid) p[j] = ilpm::from_f32<T>(y[j]);
}

// Stage one tile's halo: ih rows x iw columns from (y0, x0) of the padded
// image xb, input channels [c0, c0 + cg), into xs as [row][column][cg];
// zeros past Hp, Wp and C (they feed only outputs that are not stored).
// This one where `vec_x`: 16-byte cp.async runs, the thread's run (its
// channel vector) of halo rows z, z + tile_h, ... and columns y, y + cols,
// ...: no division. Commits nothing.
template <typename T>
__device__ __forceinline__ void stage_halo16(const DwGeom& g, T* xs,
                                             const T* xb, int y0, int x0,
                                             int c0) {
  const int c = threadIdx.x * (16 / sizeof(T));
  const bool cin = c0 + c < g.C;
  for (int hy = threadIdx.z; hy < g.ih; hy += blockDim.z) {
    const int y = y0 + hy;
    for (int hx = threadIdx.y; hx < g.iw; hx += blockDim.y) {
      const int xc = x0 + hx;
      const bool ok = cin && y < g.Hp && xc < g.Wp;
      cp_async16(xs + (hy * g.iw + hx) * g.cg + c,
                 ok ? xb + ((size_t)y * g.Wp + xc) * g.C + c0 + c : xb, ok);
    }
  }
}

// The same halo for any shape: stage_halo16 where `vec_x`; else 4-byte
// cp.async (an fp32 element, or a 16-bit pair where `pair_x`); else
// (16-bit, odd C) loads through registers, four at a time. The 3x3 kernel
// runs only where `vec_x` and calls stage_halo16 itself, so its code keeps
// none of the other copies.
template <typename T>
__device__ __forceinline__ void stage_halo(const DwGeom& g, T* xs,
                                           const T* xb, int y0, int x0,
                                           int c0) {
  const int threads = blockDim.x * blockDim.y * blockDim.z;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y +
                                              blockDim.y * threadIdx.z);
  const int n = g.ih * g.iw;
  if (g.vec_x) {
    stage_halo16(g, xs, xb, y0, x0, c0);
  } else if (sizeof(T) == 4 || g.pair_x) {
    constexpr int E = 4 / sizeof(T);  // elements a 4-byte copy
    const int runs = g.cg / E;
    for (int e = tid; e < n * runs; e += threads) {
      const int p = e / runs, c = (e - p * runs) * E;
      const int hy = p / g.iw, y = y0 + hy, xc = x0 + p - hy * g.iw;
      const bool ok = c0 + c < g.C && y < g.Hp && xc < g.Wp;
      cp_async4(xs + p * g.cg + c,
                ok ? xb + ((size_t)y * g.Wp + xc) * g.C + c0 + c : xb, ok);
    }
  } else {
    const int total = n * g.cg;
    for (int e0 = tid; e0 < total; e0 += 4 * threads) {
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + j * threads;
        const int p = e / g.cg, c = e - p * g.cg;
        const int hy = p / g.iw, y = y0 + hy, xc = x0 + p - hy * g.iw;
        v[j] = e < total && c0 + c < g.C && y < g.Hp && xc < g.Wp
                   ? xb[((size_t)y * g.Wp + xc) * g.C + c0 + c]
                   : ilpm::from_f32<T>(0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j * threads < total) xs[e0 + j * threads] = v[j];
    }
  }
}

// The CTA's tile and channel group, and this thread's place in it: grid
// (channel groups, tiles, images), block (channel vectors, pixel pairs
// along a row, rows), so only the tile's row and column take a division.
struct DwPlace {
  int z, oh0, ow0, k0, row, col, k;
};

__device__ __forceinline__ DwPlace place(const DwGeom& g, int V) {
  DwPlace q;
  const int ty = blockIdx.y / g.tiles_w;
  q.z = blockIdx.z;
  q.oh0 = ty * g.tile_h;
  q.ow0 = (blockIdx.y - ty * g.tiles_w) * g.tile_w;
  q.k0 = blockIdx.x * g.cg;
  q.row = threadIdx.z;
  q.col = threadIdx.y * PX;
  q.k = q.k0 + threadIdx.x * V;
  return q;
}

// 3x3, M = 1, stride ST, PX pixels a thread: the weights in registers,
// the taps unrolled, each halo row's inputs streamed once through
// registers. x, w, scale, bias and out are all read or written in 16-byte
// vectors (C a multiple of V, every operand aligned): every MobileNetV2
// site. Scalar code for other shapes would double this kernel's, which a
// launch this short pays for in instruction fetch; they take the generic
// kernel.
template <typename T, int ST>
__global__ void __launch_bounds__(DW_MAX_THREADS) dw3x3_kernel(
    DwGeom g, const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T), R = 3, S = 3;
  constexpr int NIN = (PX - 1) * ST + S;  // inputs of a row a thread reads
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* xs = reinterpret_cast<T*>(dw_smem);
  const DwPlace q = place(g, V);
  stage_halo16(g, xs, x + (size_t)q.z * g.Hp * g.Wp * g.C, q.oh0 * ST,
               q.ow0 * ST, q.k0);
  cp_async_commit();
  // this thread's weights, scale and bias while the halo lands; K is a
  // multiple of V, so a vector is all in or all out (then it reads
  // channel 0's and stores nothing)
  float wr[R * S][V], sc[V], bi[V];
  const int kr = q.k < g.K ? q.k : 0;
#pragma unroll
  for (int t = 0; t < R * S; ++t)
    unpack<T>(__ldg(reinterpret_cast<const uint4*>(w + t * g.K + kr)),
              wr[t]);
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + kr + v));
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + kr + v));
    sc[v] = a.x; sc[v + 1] = a.y; sc[v + 2] = a.z; sc[v + 3] = a.w;
    bi[v] = b.x; bi[v + 1] = b.y; bi[v + 2] = b.z; bi[v + 3] = b.w;
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[PX][V];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[p][v] = 0.f;
  const T* base =
      xs + (q.row * ST * g.iw + q.col * ST) * g.cg + (q.k - q.k0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T* xr = base + r * g.iw * g.cg;
    // input i of the row feeds output p at tap s = i - p * ST: for each
    // output the taps come in s order, after those of rows < r
#pragma unroll
    for (int i = 0; i < NIN; ++i) {
      float xv[V];
      unpack<T>(*reinterpret_cast<const uint4*>(xr + i * g.cg), xv);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int s = i - p * ST;
        if (s < 0 || s >= S) continue;
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[p][v] = fmaf(xv[v], wr[r * S + s][v], acc[p][v]);
      }
    }
  }
  const int oh = q.oh0 + q.row, ow = q.ow0 + q.col;
  if (oh >= g.H || q.k >= g.K) return;
  T* o = out + (((size_t)q.z * g.H + oh) * g.W + ow) * g.K + q.k;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    if (ow + p >= g.W) break;
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v)
      t[v] = ilpm::from_f32<T>(
          ilpm::apply_act(fmaf(acc[p][v], sc[v], bi[v]), g.act));
    *reinterpret_cast<uint4*>(o + (size_t)p * g.K) = u;
  }
}

// Every shape the 3x3 kernel does not take (any R, S, channel multiplier
// M, stride and C, any alignment), PX pixels a thread: output channel k
// reads input channel k / M of the halo (its input group starts at
// k0 / M), the taps r-major, s-inner, each tap's weights read from global
// memory once for the thread's pixels.
template <typename T>
__global__ void __launch_bounds__(DW_MAX_THREADS) dw_generic_kernel(
    DwGeom g, const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char dw_smem[];
  T* xs = reinterpret_cast<T*>(dw_smem);
  const DwPlace q = place(g, V);
  const int c0 = q.k0 / g.M;
  stage_halo(g, xs, x + (size_t)q.z * g.Hp * g.Wp * g.C, q.oh0 * g.stride,
             q.ow0 * g.stride, c0);
  cp_async_commit();
  const int valid = g.K - q.k;
  int ci[V];  // the halo channel each output channel reads
  float sc[V], bi[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ci[v] = v < valid ? (q.k + v) / g.M - c0 : 0;
    sc[v] = v < valid ? scale[q.k + v] : 0.f;
    bi[v] = v < valid ? bias[q.k + v] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[PX][V];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[p][v] = 0.f;
  const T* xr = xs + (q.row * g.stride * g.iw + q.col * g.stride) * g.cg;
  const T* wt = w + q.k;
#pragma unroll 3
  for (int r = 0; r < g.R; ++r, xr += g.iw * g.cg) {
#pragma unroll 3
    for (int s = 0; s < g.S; ++s, wt += g.K) {
      float wv[V];
      load_global(wt, valid, wv);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const T* xt = xr + (p * g.stride + s) * g.cg;
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[p][v] = fmaf(ilpm::to_f32(xt[ci[v]]), wv[v], acc[p][v]);
      }
    }
  }
  const int oh = q.oh0 + q.row, ow = q.ow0 + q.col;
  if (oh >= g.H || q.k >= g.K) return;
  T* o = out + (((size_t)q.z * g.H + oh) * g.W + ow) * g.K + q.k;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    if (ow + p >= g.W) break;
    float y[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      y[v] = ilpm::apply_act(fmaf(acc[p][v], sc[v], bi[v]), g.act);
    store_out(o + (size_t)p * g.K, y, valid, g.vec_out);
  }
}

template <typename T>
cudaError_t launch_depthwise(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int B, int Hp,
                             int Wp, int C, int R, int S, int K, int H, int W,
                             int stride, int act, int tile_h, int tile_w,
                             int channels, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!x || !w || !scale || !bias || !out || B < 1 || B > 65535 || C < 1 ||
      K < 1 || K % C || R < 1 || S < 1 || H < 1 || W < 1 || stride < 1 ||
      (long long)(H - 1) * stride + R > Hp ||
      (long long)(W - 1) * stride + S > Wp || act < ilpm::ACT_NONE ||
      act > ilpm::ACT_RELU6 || tile_h < 1 || tile_h > 64 ||
      tile_w < PX || tile_w % PX || channels < V || channels % V)
    return cudaErrorInvalidValue;
  DwGeom g;
  g.Hp = Hp; g.Wp = Wp; g.C = C; g.K = K; g.M = K / C; g.R = R; g.S = S;
  g.H = H; g.W = W; g.stride = stride; g.act = act;
  g.tile_h = tile_h; g.tile_w = tile_w; g.cg = channels;
  const int tc = channels / V, cols = tile_w / PX;
  const long long threads = (long long)tc * tile_h * cols;
  g.ih = (tile_h - 1) * stride + R;
  g.iw = (tile_w - 1) * stride + S;
  const size_t smem = (size_t)g.ih * g.iw * channels * sizeof(T);
  g.tiles_w = (W + tile_w - 1) / tile_w;
  g.groups = (K + channels - 1) / channels;
  const long long tiles = (long long)((H + tile_h - 1) / tile_h) * g.tiles_w;
  if (threads > DW_MAX_THREADS || smem > (size_t)DW_MAX_SMEM ||
      tiles > 65535)
    return cudaErrorInvalidValue;
  g.vec_x = C % V == 0 && aligned16(x) &&
            (g.M == 1 || (channels % g.M == 0 && channels / g.M % V == 0));
  g.pair_x = C % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const bool vec_w = K % V == 0 && aligned16(w);
  g.vec_out = K % V == 0 && aligned16(out);
  // the 3x3 kernel: M = 1 and every operand in 16-byte vectors
  const bool vec = g.vec_x && vec_w && g.vec_out && aligned16(scale) &&
                   aligned16(bias) && g.M == 1 && R == 3 && S == 3;
  const dim3 grid(g.groups, (unsigned)tiles, B);
  const dim3 block(tc, cols, tile_h);
  const T* tx = static_cast<const T*>(x);
  const T* tw = static_cast<const T*>(w);
  const float* fs = static_cast<const float*>(scale);
  const float* fb = static_cast<const float*>(bias);
  T* to = static_cast<T*>(out);
  auto run = [&](auto kern) {
    if (smem > (size_t)DEFAULT_SMEM) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<grid, block, smem, stream>>>(g, tx, tw, fs, fb, to);
    return cudaGetLastError();
  };
  if (vec && stride == 1) return run(dw3x3_kernel<T, 1>);
  if (vec && stride == 2) return run(dw3x3_kernel<T, 2>);
  return run(dw_generic_kernel<T>);
}

}  // namespace

// tile_h, tile_w, channels: a CTA's output tile (tile_w a multiple of a
// thread's 2 pixels) and its output channels (a multiple of 16 bytes'
// worth), from kernels/depthwise_conv.py `plan`;
// the launch is refused where the CTA has more than 256 threads or its
// halo does not fit shared memory.
extern "C" int depthwise_conv_launch(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     void* out, int B, int Hp, int Wp, int C,
                                     int R, int S, int K, int H, int W,
                                     int stride, int act, int tile_h,
                                     int tile_w, int channels, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_depthwise<T>(x, w, scale, bias, out, B, Hp, Wp, C, R,
                                      S, K, H, W, stride, act, tile_h, tile_w,
                                      channels,
                                      static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
