// MobileNetV2 inverted residual in one launch for sm_90a: the Hopper
// counterpart of the Pallas kernel `fused_inverted_residual` in
// src/repro/kernels/fused_block.py:133.
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
// Each stage rounds to T where the per-layer kernels' writes round; every
// epilogue is fmaf(acc, scale, bias) in fp32.
//
// The TPU kernel holds the whole image and a whole expanded slab in VMEM
// and carries the projection sum in scratch from one grid step to the
// next; the expanded tensor never reaches HBM, and that stays the point.
// Here a CTA owns a tile x tile patch of output pixels of one image and
// one 32-channel slab of the mid width: grid (tiles x slabs, B).
//   1. It stages its input halo ((tile-1)*stride + R rows by
//      (tile-1)*stride + S columns, all Cin channels) and its slab's w1,
//      wdw and w2 slices, with cp.async, in T.
//   2. It expands the halo's pixels for the slab's channels (positions
//      outside the image set to 0 after the activation: the SAME padding
//      of the expanded tensor), runs the depthwise taps, and projects the
//      slab into fp32 accumulators held in registers.
//      On the CUDA cores (fp32) the expand sums Cin in 32-channel slabs,
//      each a chain from 0, folded left to right, as the project's slabs
//      are: the fp32 pointwise_conv's order, so the per-layer chain of
//      pointwise, depthwise and pointwise gives this kernel's bits.
//   3. With one slab (mid <= 32), the projection epilogue and the identity
//      add run on the store. Else each slab writes its fp32 partial to the
//      workspace (slabs, B, OH*OW, Cout) and gemm_tile.cuh's
//      `splitk_reduce`, launched by the same call, sums the slabs in order
//      and applies the epilogue, the cast and the add once (it reads x at
//      the output's index), so a batch gives bitwise the results of one
//      image at a time.
// Neighbouring tiles recompute their shared halo's expansion: the price of
// keeping the expanded tensor out of device memory. A CTA walking several
// slabs (accumulating them in registers, the next slab's weights loading
// meanwhile) was slower at every MobileNetV2 block (gemm_sweep.py): it
// leaves fewer CTAs, and one slab's three dependent stages are latency,
// not arithmetic.
//
// What bounds it on the H100: MobileNetV2's 17 blocks do 0.56 GFLOP per
// image over a few MB, so IEEE fp32 on the CUDA cores (67 TFLOP/s) is bound
// by the operations (0.0084 ms per image). The first kernel gave each CTA
// a whole output tile and every slab: at 14² and 7² the only way to more
// CTAs was a smaller tile, so 49 CTAs each re-expanded 4-9x the halo; its
// products gave each thread 4 rows x 1 column (5 shared loads for 4 FMAs),
// its projection sum lived in shared memory, and bf16 ran the fp32 code.
// Now every slab is a CTA of its own and the Python wrapper's
// `fused_block.plan` picks the tile (never looking at the batch) so the
// deep blocks reach about 128 CTAs at a recompute of at most 2.3x, and:
// - fp32 (and a 16-bit shape the tensor cores cannot take): IEEE fmaf,
//   never TF32; each thread computes 4 x 4 blocks of the expand and the
//   project, both operands read in 16-byte (8-byte) runs;
// - bf16 and fp16 where Cin, mid and Cout are multiples of 8: the expand
//   (halo pixels x slab x Cin) and the project (tile² x Cout x slab) on
//   mma.sync.m16n8k16 with fp32 accumulators, operands in T from ldmatrix,
//   M and the contraction zero-padded to 16 in shared memory, rows padded
//   to an odd number of 16-byte units so an ldmatrix phase hits 8 bank
//   groups. The depthwise taps stay on the CUDA cores in fp32.
// The launcher refuses a plan that does not fit shared memory or whose
// projection does not fit the accumulators.
#include "gemm_tile.cuh"

namespace {

constexpr int IR_THREADS = 256;
constexpr int IR_WARPS = IR_THREADS / 32;
constexpr int TM = SLAB;  // mid slab width (gemm_tile.cuh; gemm.SLAB)
constexpr int IR_MAX_SMEM = 232448;  // a block's shared-memory limit, sm_90

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ilpm::to_f32(ilpm::from_f32<T>(v));
}

// The projection's tail: out_act(v * s2[n] + b2[n]), then, for a residual
// block, rounded to T and the identity x[i] added (the cast of the sum is
// the store's).
template <typename T>
struct ProjectTail {
  const float* scale;
  const float* bias;
  const T* res;  // null: no identity add
  int act;
  __device__ float operator()(float v, int n, size_t i) const {
    const float y = ilpm::apply_act(fmaf(v, scale[n], bias[n]), act);
    return res ? round_to<T>(y) + ilpm::to_f32(res[i]) : y;
  }
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One launch's geometry and shared-memory layout, as the launcher derives
// them. Offsets are in bytes from the start of dynamic shared memory.
struct IRGeom {
  int H, W, Cin, mid, Cout, R, S, stride, OH, OW, pad_top, pad_left;
  int tile, IW, npi, npo;  // halo columns, halo pixels, output pixels
  int npi_pad, npo_pad;    // rows padded to the products' M granule
  int kin;                 // Cin padded to the expand's K granule
  int cout_pad;            // Cout padded to the project's N granule
  int x_ld, w1_ld, w2_ld, e_ld, d_ld;  // staged row lengths, elements
  int tiles_w, slabs, batch, act;
  bool expanded, vec_x, vec_w1, vec_dw, vec_w2;
  int off_w1, off_dw, off_w2, off_e, off_d;
};

// Copy `rows` rows of `cols` elements into dst (row length ld): row r is
// row(r) (null: zeros), its columns past `valid` zeros. vec: cols and
// valid are multiples of 16 bytes' worth and the rows 16-byte aligned,
// copied as 16-byte cp.async runs; else element by element (4-byte
// cp.async for fp32, loads through registers for 16-bit types). `any`:
// a valid global address for a zero fill. Commits nothing.
template <typename T, typename Row>
__device__ __forceinline__ void copy_rows(T* dst, int ld, int rows,
                                          int cols, int valid, bool vec,
                                          const T* any, Row row) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int runs = cols / V;
    for (int e = threadIdx.x; e < rows * runs; e += IR_THREADS) {
      const int r = e / runs, c = e % runs * V;
      const T* src = row(r);
      const bool ok = src != nullptr && c < valid;
      cp_async16(dst + r * ld + c, ok ? src + c : any, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += IR_THREADS) {
      const int r = e / cols, c = e % cols;
      const T* src = row(r);
      const bool ok = src != nullptr && c < valid;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * ld + c, ok ? src + c : any, ok);
      } else {
        dst[r * ld + c] = ok ? src[c] : ilpm::from_f32<T>(0.f);
      }
    }
  }
}

// TENSOR: the expand and the project on mma.sync (else fmaf on the CUDA
// cores); NACC: projection blocks a thread (4 x 4 outputs, CUDA cores) or
// a warp (16 x 16, tensor cores) holds at most.
template <bool TENSOR, int NACC, typename T>
__global__ void __launch_bounds__(IR_THREADS) inverted_residual_kernel(
    IRGeom g, const T* __restrict__ x, const T* __restrict__ w1,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const T* __restrict__ wdw, const float* __restrict__ sdw,
    const float* __restrict__ bdw, const T* __restrict__ w2,
    ProjectTail<T> tail, T* __restrict__ out, float* __restrict__ ws) {
  using TD = std::conditional_t<TENSOR, T, float>;  // the depthwise slab
  extern __shared__ __align__(16) unsigned char ir_smem[];
  T* xs = reinterpret_cast<T*>(ir_smem);
  float* es = reinterpret_cast<float*>(ir_smem + g.off_e);
  TD* ds = reinterpret_cast<TD*>(ir_smem + g.off_d);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int slab = blockIdx.x % g.slabs, tile_id = blockIdx.x / g.slabs;
  const int oh0 = tile_id / g.tiles_w * g.tile;
  const int ow0 = tile_id % g.tiles_w * g.tile;
  const int z = blockIdx.y;
  const int m0 = slab * TM, tm = min(TM, g.mid - m0);
  const int ih0 = oh0 * g.stride - g.pad_top;  // the halo's top-left in x
  const int iw0 = ow0 * g.stride - g.pad_left;
  const T* xb = x + (size_t)z * g.H * g.W * g.Cin;
  T* w1s = reinterpret_cast<T*>(ir_smem + g.off_w1);
  T* dws = reinterpret_cast<T*>(ir_smem + g.off_dw);
  T* w2s = reinterpret_cast<T*>(ir_smem + g.off_w2);

  auto inside = [&](int p) {
    const int hy = p / g.IW, gh = ih0 + hy, gw = iw0 + p - hy * g.IW;
    return gh >= 0 && gh < g.H && gw >= 0 && gw < g.W;
  };

  // 1. the halo (rows past npi and positions outside the image: zeros)
  // and the slab's weights, one group
  copy_rows(xs, g.x_ld, g.npi_pad, round_up(g.kin, 16 / sizeof(T)), g.Cin,
            g.vec_x, x, [&](int p) -> const T* {
              if (p >= g.npi || !inside(p)) return nullptr;
              const int hy = p / g.IW;
              return xb + ((size_t)(ih0 + hy) * g.W + iw0 + p - hy * g.IW) *
                              g.Cin;
            });
  if (g.expanded)
    copy_rows(w1s, g.w1_ld, g.kin, TM, tm, g.vec_w1, w1,
              [&](int c) -> const T* {
                return c < g.Cin ? w1 + (size_t)c * g.mid + m0 : nullptr;
              });
  copy_rows(dws, TM, g.R * g.S, TM, tm, g.vec_dw, wdw,
            [&](int t) -> const T* { return wdw + (size_t)t * g.mid + m0; });
  copy_rows(w2s, g.w2_ld, TM, g.cout_pad, g.Cout, g.vec_w2, w2,
            [&](int m) -> const T* {
              return m < tm ? w2 + (size_t)(m0 + m) * g.Cout : nullptr;
            });
  cp_async_commit();
  cp_async_commit();  // an empty group: wait_group 1 waits for the first
  // the depthwise slab's pad rows are never written: zeros
  for (int e = g.npo * g.d_ld + tid; e < g.npo_pad * g.d_ld;
       e += IR_THREADS)
    ds[e] = TD(0.f);
  cp_async_wait_one();
  __syncthreads();

  // the projection blocks this thread (CUDA cores) or warp (tensor cores)
  // holds, and their accumulators
  constexpr int ACC = TENSOR ? 8 : 16;
  const int nb = TENSOR ? g.cout_pad / 16 : g.cout_pad / 4;
  const int blocks = TENSOR ? g.npo_pad / 16 * nb : g.npo_pad / 4 * nb;
  const int first = TENSOR ? warp : tid;
  constexpr int STEP = TENSOR ? IR_WARPS : IR_THREADS;
  float acc[NACC][ACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int q = 0; q < ACC; ++q) acc[j][q] = 0.f;

  // the expand's result for halo pixel p, slab channel m
  auto expanded_value = [&](int p, int m, float v) {
    if (m >= tm || !inside(p)) return 0.f;
    return round_to<T>(
        ilpm::apply_act(fmaf(v, s1[m0 + m], b1[m0 + m]), g.act));
  };

  // 2a. expand the halo for this slab; outside the image an exact 0
  if (!g.expanded) {  // t == 1: the slab is the input itself
    for (int e = tid; e < g.npi * TM; e += IR_THREADS) {
      const int p = e / TM, m = e % TM;
      es[p * g.e_ld + m] =
          m < tm ? ilpm::to_f32(xs[p * g.x_ld + m0 + m]) : 0.f;
    }
  } else if constexpr (TENSOR) {
    for (int u = warp; u < g.npi_pad / 16 * 2; u += IR_WARPS) {
      const int mt = u / 2, np = u % 2;
      float a[2][4] = {};
      for (int ks = 0; ks < g.kin; ks += 16) {
        uint32_t af[4], r[4];
        ldmatrix_x4(af, xs + (mt * 16 + lane % 16) * g.x_ld + ks +
                            lane / 16 * 8);
        ldmatrix_x4_trans(r, w1s + (ks + lane % 16) * g.w1_ld + np * 16 +
                                 lane / 16 * 8);
        mma16816<T>(a[0], af, r);
        mma16816<T>(a[1], af, r + 2);
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mt * 16 + lane / 4 + 8 * h;
          const int m = np * 16 + 8 * jn + 2 * (lane % 4);
          if (p >= g.npi) continue;
          *reinterpret_cast<float2*>(es + p * g.e_ld + m) =
              make_float2(expanded_value(p, m, a[jn][2 * h]),
                          expanded_value(p, m + 1, a[jn][2 * h + 1]));
        }
    }
  } else {
    for (int blk = tid; blk < g.npi_pad / 4 * (TM / 4); blk += IR_THREADS) {
      const int rb = blk / (TM / 4), cb = blk % (TM / 4);
      const T* xr = xs + 4 * rb * g.x_ld;
      const T* wr = w1s + 4 * cb;
      // each SLAB channels of Cin one chain from 0, the slabs folded left
      // to right: the fp32 pointwise_conv's order (its splits)
      float a[4][4];
      for (int c0 = 0; c0 < g.kin; c0 += SLAB) {
        float p[4][4] = {};
        for (int c = c0; c < min(g.kin, c0 + SLAB); c += 4) {
          float av[4][4], bv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) load4(xr + i * g.x_ld + c, av[i]);
#pragma unroll
          for (int q = 0; q < 4; ++q) load4(wr + (c + q) * g.w1_ld, bv[q]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                p[i][j] = fmaf(av[i][q], bv[q][j], p[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[i][j] = c0 == 0 ? p[i][j] : a[i][j] + p[i][j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * rb + i;
        if (p >= g.npi) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = expanded_value(p, 4 * cb + j, a[i][j]);
        *reinterpret_cast<float4*>(es + p * g.e_ld + 4 * cb) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();

  // 2b. the depthwise taps over the expanded slab, fmaf in (r, s) order
  for (int e = tid; e < g.npo * TM; e += IR_THREADS) {
    const int q = e / TM, m = e % TM;
    const int qy = q / g.tile, qx = q - qy * g.tile;
    const float* ep = es + (qy * g.stride * g.IW + qx * g.stride) * g.e_ld + m;
    float a = 0.f;
    for (int r = 0; r < g.R; ++r)
      for (int s = 0; s < g.S; ++s)
        a = fmaf(ep[(r * g.IW + s) * g.e_ld],
                 ilpm::to_f32(dws[(r * g.S + s) * TM + m]), a);
    const float v = m < tm ? round_to<T>(ilpm::apply_act(
                                 fmaf(a, sdw[m0 + m], bdw[m0 + m]), g.act))
                           : 0.f;
    if constexpr (TENSOR) {
      ds[q * g.d_ld + m] = ilpm::from_f32<T>(v);
    } else {
      ds[q * g.d_ld + m] = v;
    }
  }
  __syncthreads();

  // 2c. the slab's projection, into the registers
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int blk = first + j * STEP;
    if (blk >= blocks) continue;
    const int rb = blk / nb, cb = blk % nb;
    if constexpr (TENSOR) {
#pragma unroll
      for (int ks = 0; ks < TM; ks += 16) {
        uint32_t af[4], r[4];
        ldmatrix_x4(af, ds + (rb * 16 + lane % 16) * g.d_ld + ks +
                            lane / 16 * 8);
        ldmatrix_x4_trans(r, w2s + (ks + lane % 16) * g.w2_ld + cb * 16 +
                                 lane / 16 * 8);
        mma16816<T>(acc[j], af, r);
        mma16816<T>(acc[j] + 4, af, r + 2);
      }
    } else {
      const float* dr = ds + 4 * rb * g.d_ld;
      const T* wr = w2s + 4 * cb;
#pragma unroll
      for (int k = 0; k < TM; k += 4) {
        float av[4][4], bv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(dr + i * g.d_ld + k, av[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(wr + (k + q) * g.w2_ld, bv[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[j][4 * i + jj] =
                  fmaf(av[i][q], bv[q][jj], acc[j][4 * i + jj]);
      }
    }
  }

  // 3. the store: the tail for one slab, else the fp32 partial
  const size_t total = (size_t)g.batch * g.OH * g.OW * g.Cout;
  auto out_index = [&](int q, size_t* o) {
    const int qy = q / g.tile, oh = oh0 + qy, ow = ow0 + q - qy * g.tile;
    if (q >= g.npo || oh >= g.OH || ow >= g.OW) return false;
    *o = (((size_t)z * g.OH + oh) * g.OW + ow) * g.Cout;
    return true;
  };
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int blk = first + j * STEP;
    if (blk >= blocks) continue;
    const int rb = blk / nb, cb = blk % nb;
    if constexpr (TENSOR) {
      // accumulator q of n tile jn: row lane/4 (+8 for q >= 2), columns
      // 2 (lane % 4) + {0, 1}; Cout % 8 == 0: both columns or neither
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        size_t o;
        if (!out_index(rb * 16 + lane / 4 + 8 * h, &o)) continue;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int n = cb * 16 + 8 * jn + 2 * (lane % 4);
          if (n >= g.Cout) continue;
          const float v0 = acc[j][4 * jn + 2 * h];
          const float v1 = acc[j][4 * jn + 2 * h + 1];
          if (g.slabs > 1) {
            *reinterpret_cast<float2*>(ws + slab * total + o + n) =
                make_float2(v0, v1);
          } else {
            uint32_t u;
            T* t = reinterpret_cast<T*>(&u);
            t[0] = ilpm::from_f32<T>(tail(v0, n, o + n));
            t[1] = ilpm::from_f32<T>(tail(v1, n + 1, o + n + 1));
            *reinterpret_cast<uint32_t*>(out + o + n) = u;
          }
        }
      }
    } else {
      const int n = 4 * cb, valid = min(4, g.Cout - n);
      if (valid <= 0) continue;
      const bool vec = g.Cout % 4 == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        size_t o;
        if (!out_index(4 * rb + i, &o)) continue;
        if (g.slabs > 1) {
          store4(ws + slab * total + o + n, acc[j] + 4 * i, valid, vec);
        } else {
          float v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            v[jj] = jj < valid ? tail(acc[j][4 * i + jj], n + jj, o + n + jj)
                               : 0.f;
          store4(out + o + n, v, valid, vec);
        }
      }
    }
  }
}

template <bool TENSOR, int NACC, typename T>
cudaError_t launch_ir_kernel(const IRGeom& g, size_t smem, dim3 grid,
                             cudaStream_t stream, const T* x, const T* w1,
                             const float* s1, const float* b1, const T* wdw,
                             const float* sdw, const float* bdw, const T* w2,
                             const ProjectTail<T>& tail, T* out,
                             float* ws) {
  auto kern = inverted_residual_kernel<TENSOR, NACC, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, IR_THREADS, smem, stream>>>(g, x, w1, s1, b1, wdw, sdw, bdw,
                                           w2, tail, out, ws);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_inverted_residual(
    const void* x, const void* w1, const void* s1, const void* b1,
    const void* wdw, const void* sdw, const void* bdw, const void* w2,
    const void* s2, const void* b2, void* out, int B, int H, int W, int Cin,
    int mid, int Cout, int R, int S, int stride, int act, int out_act,
    int residual, int tile, void* ws, cudaStream_t stream) {
  const bool expanded = w1 != nullptr;
  if (!x || !wdw || !sdw || !bdw || !w2 || !s2 || !b2 || !out || B < 1 ||
      B > 65535 || H < 1 || W < 1 || Cin < 1 || mid < 1 || Cout < 1 ||
      R < 1 || S < 1 || tile < 1 || stride < 1 ||
      (expanded && (!s1 || !b1)) || (!expanded && mid != Cin) ||
      (residual && (stride != 1 || Cin != Cout)) || act < ilpm::ACT_NONE ||
      act > ilpm::ACT_RELU6 || out_act < ilpm::ACT_NONE ||
      out_act > ilpm::ACT_RELU6)
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(T);
  IRGeom g;
  g.H = H; g.W = W; g.Cin = Cin; g.mid = mid; g.Cout = Cout; g.R = R;
  g.S = S; g.stride = stride; g.batch = B; g.act = act;
  g.expanded = expanded;
  g.OH = (H + stride - 1) / stride;
  g.OW = (W + stride - 1) / stride;
  g.pad_top = max((g.OH - 1) * stride + R - H, 0) / 2;
  g.pad_left = max((g.OW - 1) * stride + S - W, 0) / 2;
  g.tile = tile;
  g.IW = (tile - 1) * stride + S;
  g.npi = ((tile - 1) * stride + R) * g.IW;
  g.npo = tile * tile;
  g.slabs = (mid + TM - 1) / TM;
  g.tiles_w = (g.OW + tile - 1) / tile;
  const long long tiles = (long long)((g.OH + tile - 1) / tile) * g.tiles_w;
  if (g.slabs > 1 && (!ws || !aligned16(ws))) return cudaErrorInvalidValue;
  const bool tensor = sizeof(T) == 2 && Cin % 8 == 0 && mid % 8 == 0 &&
                      Cout % 8 == 0;
  if (tensor && !(aligned16(x) && (!expanded || aligned16(w1)) &&
                  aligned16(wdw) && aligned16(w2)))
    return cudaErrorInvalidValue;
  const int mg = tensor ? 16 : 4;  // the products' M, K and N granules
  g.npi_pad = round_up(g.npi, mg);
  g.npo_pad = round_up(g.npo, mg);
  g.kin = round_up(Cin, mg);
  g.cout_pad = round_up(Cout, mg);
  g.x_ld = round_up(g.kin, V) + V;
  g.w1_ld = TM + V;
  g.w2_ld = round_up(g.cout_pad, V) + V;
  g.e_ld = TM + 4;
  g.d_ld = tensor ? TM + 8 : TM + 4;
  g.vec_x = Cin % V == 0 && aligned16(x);
  g.vec_w1 = expanded && mid % V == 0 && aligned16(w1);
  g.vec_dw = mid % V == 0 && aligned16(wdw);
  g.vec_w2 = Cout % V == 0 && aligned16(w2);
  // layout: halo | w1 | wdw | w2 slices | expanded slab | depthwise slab
  const size_t e = sizeof(T);
  size_t off = round_up((int)(g.npi_pad * g.x_ld * e), 16);
  g.off_w1 = (int)off;
  if (expanded) off += round_up((int)(g.kin * g.w1_ld * e), 16);
  g.off_dw = (int)off;
  off += round_up((int)(R * S * TM * e), 16);
  g.off_w2 = (int)off;
  off += round_up((int)(TM * g.w2_ld * e), 16);
  g.off_e = (int)off;
  off += round_up(g.npi * g.e_ld * 4, 16);
  g.off_d = (int)off;
  off += (size_t)g.npo_pad * g.d_ld * (tensor ? e : 4);
  // projection blocks a thread or warp holds
  const int blocks = tensor ? g.npo_pad / 16 * (g.cout_pad / 16)
                            : g.npo_pad / 4 * (g.cout_pad / 4);
  const int per = tensor ? (blocks + IR_WARPS - 1) / IR_WARPS
                         : (blocks + IR_THREADS - 1) / IR_THREADS;
  if (off > (size_t)IR_MAX_SMEM || per > 8 || tiles * g.slabs > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * g.slabs), B);
  const ProjectTail<T> tail{static_cast<const float*>(s2),
                            static_cast<const float*>(b2),
                            residual ? static_cast<const T*>(x) : nullptr,
                            out_act};
  const T* tx = static_cast<const T*>(x);
  const T* tw1 = static_cast<const T*>(w1);
  const float* fs1 = static_cast<const float*>(s1);
  const float* fb1 = static_cast<const float*>(b1);
  const T* twdw = static_cast<const T*>(wdw);
  const float* fsdw = static_cast<const float*>(sdw);
  const float* fbdw = static_cast<const float*>(bdw);
  const T* tw2 = static_cast<const T*>(w2);
  T* tout = static_cast<T*>(out);
  float* fws = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
#define ILPM_IR_LAUNCH(TENSOR, NACC)                                       \
  err = launch_ir_kernel<TENSOR, NACC, T>(g, off, grid, stream, tx, tw1,  \
                                          fs1, fb1, twdw, fsdw, fbdw, tw2, \
                                          tail, tout, fws)
  if (tensor) {
    if constexpr (sizeof(T) == 2) {
      if (per <= 2) ILPM_IR_LAUNCH(true, 2); else ILPM_IR_LAUNCH(true, 8);
    }
  } else if (per <= 2) {
    ILPM_IR_LAUNCH(false, 2);
  } else {
    ILPM_IR_LAUNCH(false, 8);
  }
#undef ILPM_IR_LAUNCH
  if (err != cudaSuccess || g.slabs == 1) return err;
  return launch_splitk_reduce(fws, tout, (size_t)B * g.OH * g.OW * Cout,
                              Cout, g.slabs, tail, stream);
}

}  // namespace

// tile: the output tile's side; ws: the fp32 workspace (slabs, B, OH*OW,
// Cout) where the mid width has more than one 32-channel slab. bf16 and
// fp16 run on the tensor cores where Cin, mid and Cout are multiples of 8
// (x, w1, wdw and w2 16-byte aligned).
extern "C" int fused_inverted_residual_launch(
    int dtype, const void* x, const void* w1, const void* s1, const void* b1,
    const void* wdw, const void* sdw, const void* bdw, const void* w2,
    const void* s2, const void* b2, void* out, int B, int H, int W, int Cin,
    int mid, int Cout, int R, int S, int stride, int act, int out_act,
    int residual, int tile, void* ws, void* stream) {
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)launch_inverted_residual<T>(
          x, w1, s1, b1, wdw, sdw, bdw, w2, s2, b2, out, B, H, W, Cin, mid,
          Cout, R, S, stride, act, out_act, residual, tile, ws,
          static_cast<cudaStream_t>(stream)))
  return (int)cudaErrorInvalidValue;
}
