// Depthwise causal 1-D conv for sm_90a, forward and backward: the Hopper
// counterpart of the Pallas kernel `causal_conv1d` in
// src/repro/kernels/causal_conv1d.py, the conv stem of every Mamba-2 layer,
// and of its gradient, which the reference leaves to JAX's autodiff (it
// has no backward kernel).
//
// x (B, L, C) with its channels contiguous, rows `rs` elements apart and
// batches `bs` apart, w (K, C), an optional bias (C,)
//   -> out (B, L, C) contiguous,
// out[b, t, c] = sum over j < K of x[b, t - K + 1 + j, c] * w[j, c], plus
// bias[c], with x = 0 before t = 0. The strides let the kernels read the
// xBC slice of Mamba's in-projection in place (row stride 4384 against
// C = 2304 at mamba2-370m's width) instead of a copy.
//
// Bound by bytes: K multiplies and adds per output against one input read
// and one output write, about 0.5 operations per byte at K = 4 in bf16.
// The TPU kernel stages a sequence tile and the previous tile in VMEM to
// get its K - 1 halo; here nothing is staged across threads. A thread owns
// V neighbouring channels (4 where the operands are aligned for it: one
// 16-byte load in fp32, 8 bytes in bf16 or fp16; narrower for views that
// are not) and walks `steps` time steps: the K weights sit in registers,
// the K - 1 halo steps are loaded once at the start of the walk and then
// carried in a register window from one step to the next, and the walk's
// rows stream through a ring of rows a thread in shared memory, filled by
// cp.async up to a ring ahead of the row being computed, so that many
// loads are in flight without holding registers. Lanes run along C, so a
// warp's loads and stores coalesce. A flat grid of (channel group, walk,
// batch), channels fastest, with `threads` a block; the wrapper's plan
// picks V, `steps` and `threads`. Measured (gemm_sweep.py conv1d): a
// thread's rows are a serial chain of fp32 operations (the multiplies and
// adds are not fused, to stay bitwise the plain version), so the grid
// wants many threads: 4 channels a thread beat 8 in bf16 by 3-12% at
// Mamba-2's width (equal at Jamba's), and 16-step walks beat 64-step ones
// by 4-17%, though a walk re-reads its K - 1 halo rows (from L2); a first
// version that prefetched the rows into registers took 221 of them in
// bf16 and reached half the bound.
//
// The backward, one pass for dx, dw and db. With dy (B, L, C) (rows
// strided, channels contiguous) a thread walks a (channels, steps) tile
// as the forward does, its x and dy rows through two rings, reading x
// from K - 1 steps before the tile and dy up to K - 1 steps past it (zero
// past L), and
//   dx[t] = sum over j < K of w[j] * dy[t + K - 1 - j]   (one cast),
//   dw[j] += dy[t] * x[t - K + 1 + j],  db += dy[t]       (fp32, t order),
// then stores its K + 1 partial sums to a workspace (B, tiles, K + 1, C)
// in fp32. A second kernel sums the partials over (b, tile) in index order
// for each (j, c) and casts once. No atomics: two runs are bitwise equal.
// Its walks are long (64 steps where the grid stays wide): each walk adds
// K + 1 partial rows to write and sum.
//
// Every value is the plain version's (ref.causal_conv1d and
// ref.causal_conv1d_bwd): chains of separately rounded fp32 multiplies and
// adds in the same order (__fmul_rn / __fadd_rn keep nvcc from contracting
// them into FMAs), then one cast on the store, so the two agree bitwise.
#include <type_traits>

#include "common.cuh"
#include "gemm_tile.cuh"  // the cp.async primitives

namespace {

constexpr int MAX_K = 8;
constexpr int MAX_THREADS = 128;
constexpr int FWD_STAGES = 32;  // rows in flight a thread, forward
constexpr int BWD_STAGES = 16;  // rows in flight a thread a stream, backward
constexpr int REDUCE_THREADS = 128;
static_assert((FWD_STAGES & (FWD_STAGES - 1)) == 0 &&
              (BWD_STAGES & (BWD_STAGES - 1)) == 0, "rings of 2^n rows");

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Row t of a column of V channels, zero outside [0, L).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> row(const T* p, long long stride, int t,
                                          int L) {
  if (t >= 0 && t < L)
    return *reinterpret_cast<const Pack<T, V>*>(p + t * stride);
  Pack<T, V> z;
#pragma unroll
  for (int v = 0; v < V; ++v) z.v[v] = ilpm::from_f32<T>(0.f);
  return z;
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Pack<T, V>& p, float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = ilpm::to_f32(p.v[v]);
}

// Row t of a column into a ring slot in shared memory, zeros outside
// [0, L): one cp.async of 4, 8 or 16 bytes, in flight until its group is
// waited for. A 2-byte row (one bf16 or fp16 channel) has no cp.async;
// it is loaded and stored here.
template <typename T, int V>
__device__ __forceinline__ void fetch(Pack<T, V>* slot, const T* p,
                                      long long stride, int t, int L) {
  constexpr int BYTES = sizeof(Pack<T, V>);
  if constexpr (BYTES < 4) {
    *slot = row<T, V>(p, stride, t, L);
  } else {
    const bool in = t >= 0 && t < L;
    const T* src = in ? p + t * stride : p;
    if constexpr (BYTES == 16)
      cp_async16(slot, src, in);
    else if constexpr (BYTES == 8)
      cp_async8(slot, src, in);
    else
      cp_async4(slot, src, in);
  }
}

// The thread's tile: channels c0 .. c0 + V - 1 of batch b, steps t0 ..
// t0 + steps - 1 (walk `seg` of its column). False past the grid's end.
struct Tile {
  int b, c0, t0, seg;
};

// 32-bit index arithmetic (the launcher keeps the grid's threads under
// 2^31): a 64-bit division would sit in front of every thread's first load.
template <int V>
__device__ __forceinline__ bool tile_of(int B, int L, int C, int steps,
                                        Tile& tile) {
  const unsigned ch = C / V;
  const unsigned nseg = (L + steps - 1) / steps;
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ch * nseg * B) return false;
  const unsigned r = idx / ch;
  tile.c0 = (int)(idx - r * ch) * V;
  tile.seg = (int)(r % nseg);
  tile.b = (int)(r / nseg);
  tile.t0 = tile.seg * steps;
  return true;
}

template <typename T, int V, int K>
__device__ __forceinline__ void load_taps(const T* w, int C, int c0,
                                          float (&wr)[K][V]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
    widen<T, V>(*reinterpret_cast<const Pack<T, V>*>(w + (long long)j * C + c0),
                wr[j]);
}

// Every thread keeps a ring of S rows in shared memory, slot s of thread i
// at ring[s * blockDim.x + i] (a warp's slots side by side, so the
// accesses are conflict-free), which it alone writes and reads: no
// barrier. `fetch(k)` sends row k of the walk (of each of the thread's
// streams) to slot k % S. A walk of n < S rows is fetched at once and
// waited for once. A longer one keeps S - 1 rows in flight: the slot
// refilled at step k was read at step k - 1, and every step commits one
// group (empty past the walk), so waiting until S - 2 groups are in
// flight lands row k.
template <int S, typename F>
__device__ __forceinline__ void ring_start(int n, F&& fetch) {
  if (n < S) {
    for (int k = 0; k < n; ++k) fetch(k);
    cp_async_commit();
    cp_async_wait<0>();
  } else {
#pragma unroll
    for (int k = 0; k < S - 1; ++k) {
      fetch(k);
      cp_async_commit();
    }
  }
}

// Before row k is read.
template <int S>
__device__ __forceinline__ void ring_wait(int n) {
  if (n >= S) cp_async_wait<S - 2>();
}

// After row k is read.
template <int S, typename F>
__device__ __forceinline__ void ring_next(int k, int n, F&& fetch) {
  if (n >= S) {
    if (k + S - 1 < n) fetch(k + S - 1);
    cp_async_commit();
  }
}

template <typename T, int V, int K>
__global__ void __launch_bounds__(MAX_THREADS) causal_conv1d_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ out, int B, int L, int C,
    long long bs, long long rs, int steps) {
  constexpr int S = FWD_STAGES;
  constexpr int H = K > 1 ? K - 1 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile tile;
  if (!tile_of<V>(B, L, C, steps, tile)) return;
  const int t0 = tile.t0, n = min(steps, L - t0);
  const int nt = blockDim.x;
  Pack<T, V>* ring = reinterpret_cast<Pack<T, V>*>(smem) + threadIdx.x;
  const T* xb = x + tile.b * bs + tile.c0;
  T* ob = out + ((long long)tile.b * L + t0) * C + tile.c0;

  // the taps, the bias and the halo first: their loads fly beside the
  // ring's
  float wr[K][V];
  load_taps<T, V, K>(w, C, tile.c0, wr);
  float br[V];
#pragma unroll
  for (int v = 0; v < V; ++v) br[v] = 0.f;
  if (bias != nullptr)
    widen<T, V>(*reinterpret_cast<const Pack<T, V>*>(bias + tile.c0), br);
  // x[t - K + 1 .. t - 1] for the step t about to be computed
  float win[H][V];
#pragma unroll
  for (int h = 0; h < K - 1; ++h)
    widen<T, V>(row<T, V>(xb, rs, t0 - (K - 1) + h, L), win[h]);
  const auto fetch_row = [&](int k) {
    fetch<T, V>(ring + (k & (S - 1)) * nt, xb, rs, t0 + k, L);
  };
  ring_start<S>(n, fetch_row);

#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    ring_wait<S>(n);
    float xv[V];
    widen<T, V>(ring[(k & (S - 1)) * nt], xv);
    ring_next<S>(k, n, fetch_row);
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < K - 1; ++j)
        acc = __fadd_rn(acc, __fmul_rn(win[j][v], wr[j][v]));
      acc = __fadd_rn(acc, __fmul_rn(xv[v], wr[K - 1][v]));
      if (bias != nullptr) acc = __fadd_rn(acc, br[v]);
      o.v[v] = ilpm::from_f32<T>(acc);
    }
    *reinterpret_cast<Pack<T, V>*>(ob + (long long)k * C) = o;
    if constexpr (K > 1) {
#pragma unroll
      for (int h = 0; h < K - 2; ++h)
#pragma unroll
        for (int v = 0; v < V; ++v) win[h][v] = win[h + 1][v];
#pragma unroll
      for (int v = 0; v < V; ++v) win[K - 2][v] = xv[v];
    }
  }
}

// Two rings, x's and dy's, each S rows ahead; the dy stream runs K - 1
// rows ahead of the x stream.
template <typename T, int V, int K>
__global__ void __launch_bounds__(MAX_THREADS) causal_conv1d_bwd_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const T* __restrict__ w, T* __restrict__ dx, float* __restrict__ part,
    int B, int L, int C, long long dy_bs, long long dy_rs, long long x_bs,
    long long x_rs, int steps) {
  constexpr int S = BWD_STAGES;
  constexpr int H = K > 1 ? K - 1 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  Tile tile;
  if (!tile_of<V>(B, L, C, steps, tile)) return;
  const int t0 = tile.t0, n = min(steps, L - t0);
  const int nt = blockDim.x;
  Pack<T, V>* xring = reinterpret_cast<Pack<T, V>*>(smem) + threadIdx.x;
  Pack<T, V>* gring = xring + min(steps, S) * nt;  // the launcher's slots
  const T* xb = x + tile.b * x_bs + tile.c0;
  const T* gb = dy + tile.b * dy_bs + tile.c0;
  T* ob = dx + ((long long)tile.b * L + t0) * C + tile.c0;

  float wr[K][V];
  load_taps<T, V, K>(w, C, tile.c0, wr);
  // at step t: xw holds x[t - K + 1 .. t - 1], gw holds dy[t .. t + K - 2];
  // the rings bring x[t] and dy[t + K - 1]
  float xw[H][V], gw[H][V];
#pragma unroll
  for (int h = 0; h < K - 1; ++h) {
    widen<T, V>(row<T, V>(xb, x_rs, t0 - (K - 1) + h, L), xw[h]);
    widen<T, V>(row<T, V>(gb, dy_rs, t0 + h, L), gw[h]);
  }
  const auto fetch_row = [&](int k) {
    const int slot = (k & (S - 1)) * nt;
    fetch<T, V>(xring + slot, xb, x_rs, t0 + k, L);
    fetch<T, V>(gring + slot, gb, dy_rs, t0 + K - 1 + k, L);
  };
  ring_start<S>(n, fetch_row);
  float dw[K][V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) dw[j][v] = 0.f;
  }

#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    ring_wait<S>(n);
    float xv[V], gv[V];
    widen<T, V>(xring[(k & (S - 1)) * nt], xv);
    widen<T, V>(gring[(k & (S - 1)) * nt], gv);
    ring_next<S>(k, n, fetch_row);
    Pack<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // dx[t]: dy[t + K - 1] against w[0], then the window down to dy[t]
      float acc = __fadd_rn(0.f, __fmul_rn(gv[v], wr[0][v]));
#pragma unroll
      for (int j = 1; j < K; ++j)
        acc = __fadd_rn(acc, __fmul_rn(gw[K - 1 - j][v], wr[j][v]));
      o.v[v] = ilpm::from_f32<T>(acc);
      // dw, db: dy[t] against x[t - K + 1 .. t]
      const float g = K > 1 ? gw[0][v] : gv[v];
#pragma unroll
      for (int j = 0; j < K - 1; ++j)
        dw[j][v] = __fadd_rn(dw[j][v], __fmul_rn(g, xw[j][v]));
      dw[K - 1][v] = __fadd_rn(dw[K - 1][v], __fmul_rn(g, xv[v]));
      db[v] = __fadd_rn(db[v], g);
    }
    *reinterpret_cast<Pack<T, V>*>(ob + (long long)k * C) = o;
    if constexpr (K > 1) {
#pragma unroll
      for (int h = 0; h < K - 2; ++h)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xw[h][v] = xw[h + 1][v];
          gw[h][v] = gw[h + 1][v];
        }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xw[K - 2][v] = xv[v];
        gw[K - 2][v] = gv[v];
      }
    }
  }

  // the tile's partial sums: rows 0 .. K - 1 are dw, row K is db
  const int nseg = (L + steps - 1) / steps;
  float* pp = part + ((long long)tile.b * nseg + tile.seg) * (K + 1) * C
              + tile.c0;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    Pack<float, V> s;
#pragma unroll
    for (int v = 0; v < V; ++v) s.v[v] = j < K ? dw[j][v] : db[v];
    *reinterpret_cast<Pack<float, V>*>(pp + (long long)j * C) = s;
  }
}

// dw[j, c] (j < K) and db[c] (j = K): the n partials summed in index order
// from 0, then one cast. At Mamba-2's train class (64 partials, in L2) it
// takes 3 of the backward's 29 device µs; loading 32 partials into an
// array before adding them, in 64-thread blocks, took 12.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) causal_conv1d_bwd_reduce(
    const float* __restrict__ part, T* __restrict__ dw, T* __restrict__ db,
    int n, int K, int C) {
  const int idx = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= (K + 1) * C) return;
  const int j = idx / C, c = idx - j * C;
  if (j == K && db == nullptr) return;
  const long long stride = (long long)(K + 1) * C;
  const float* p = part + idx;
  float acc = 0.f;
#pragma unroll 16
  for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, p[i * stride]);
  (j < K ? dw + idx : db + c)[0] = ilpm::from_f32<T>(acc);
}

struct Geometry {
  int B, L, C, K, steps, threads;
};

// The grid's threads: one a (channel group, walk, batch).
long long walkers(const Geometry& g, int vec) {
  return (long long)(g.C / vec) * ((g.L + g.steps - 1) / g.steps) * g.B;
}

template <int V>
unsigned blocks(const Geometry& g) {
  return (unsigned)((walkers(g, V) + g.threads - 1) / g.threads);
}

// Ring slots a thread: a walk shorter than the ring uses its first
// `steps` slots only.
int slots(const Geometry& g, int stages) { return min(g.steps, stages); }

// The rings' shared memory, above the 48 KB a launch gets by default at
// 16-byte rows and 128 threads: allowed on every launch, as the attribute
// is the function's (a host call, no stream work).
template <typename Kernel>
cudaError_t ring_bytes(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename T, int V, int K>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* out,
                const Geometry& g, long long bs, long long rs,
                cudaStream_t stream) {
  const auto kernel = causal_conv1d_fwd_kernel<T, V, K>;
  const int smem =
      slots(g, FWD_STAGES) * g.threads * (int)sizeof(Pack<T, V>);
  const cudaError_t err = ring_bytes(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks<V>(g), g.threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), g.B, g.L, g.C, bs,
      rs, g.steps);
  return cudaGetLastError();
}

template <typename T, int V, int K>
cudaError_t bwd(const void* dy, const void* x, const void* w, void* dx,
                void* dw, void* db, void* part, const Geometry& g,
                long long dy_bs, long long dy_rs, long long x_bs,
                long long x_rs, cudaStream_t stream) {
  const auto kernel = causal_conv1d_bwd_kernel<T, V, K>;
  const int smem =
      2 * slots(g, BWD_STAGES) * g.threads * (int)sizeof(Pack<T, V>);
  cudaError_t err = ring_bytes(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks<V>(g), g.threads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(dx),
      static_cast<float*>(part), g.B, g.L, g.C, dy_bs, dy_rs, x_bs, x_rs,
      g.steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = g.B * ((g.L + g.steps - 1) / g.steps);
  const int outs = (g.K + 1) * g.C;
  causal_conv1d_bwd_reduce<T>
      <<<(outs + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0,
         stream>>>(static_cast<const float*>(part), static_cast<T*>(dw),
                   static_cast<T*>(db), n, g.K, g.C);
  return cudaGetLastError();
}

template <int V, typename F>
cudaError_t with_taps(int K, F&& f) {
#define ILPM_CC1D_TAPS(N)                                               \
  case N:                                                               \
    return f(std::integral_constant<int, V>{},                          \
             std::integral_constant<int, N>{});
  switch (K) {
    ILPM_CC1D_TAPS(1) ILPM_CC1D_TAPS(2) ILPM_CC1D_TAPS(3) ILPM_CC1D_TAPS(4)
    ILPM_CC1D_TAPS(5) ILPM_CC1D_TAPS(6) ILPM_CC1D_TAPS(7) ILPM_CC1D_TAPS(8)
  }
#undef ILPM_CC1D_TAPS
  return cudaErrorInvalidValue;
}

// f(V, K) as compile-time constants, for a vector width `vec` of 1, 2 or 4
// that divides C and taps K; cudaErrorInvalidValue for anything else.
template <typename F>
cudaError_t dispatch(int vec, const Geometry& g, F&& f) {
  if (g.B < 1 || g.L < 1 || g.C < 1 || g.K < 1 || g.K > MAX_K ||
      g.steps < 1 || g.threads < 32 || g.threads > MAX_THREADS ||
      g.threads % 32 != 0 || vec < 1 || g.C % vec != 0 ||
      walkers(g, vec) + g.threads >= (1ll << 31))
    return cudaErrorInvalidValue;
  switch (vec) {
    case 1: return with_taps<1>(g.K, f);
    case 2: return with_taps<2>(g.K, f);
    case 4: return with_taps<4>(g.K, f);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// vec channels a thread need C % vec == 0 and every pointer and every
// row and batch stride aligned to vec elements; the wrapper's plan checks
// that. `threads` must be a multiple of 32 up to 128. `bias` may be null.
extern "C" int causal_conv1d_launch(int dtype, const void* x, const void* w,
                                    const void* bias, void* out, int B, int L,
                                    int C, int K, long long batch_stride,
                                    long long row_stride, int vec, int steps,
                                    int threads, void* stream) {
  const Geometry g{B, L, C, K, steps, threads};
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)dispatch(vec, g, [&](auto v, auto k) {
        return fwd<T, decltype(v)::value, decltype(k)::value>(
            x, w, bias, out, g, batch_stride, row_stride,
            static_cast<cudaStream_t>(stream));
      }))
  return (int)cudaErrorInvalidValue;
}

// dx (B, L, C) contiguous, dw (K, C), db (C,) or null, and the fp32
// workspace `part` of (B, ceil(L / steps), K + 1, C), all written here; dy
// and x may have strided rows. Two kernels on `stream`: the pass, then
// the ordered sum of its partials.
extern "C" int causal_conv1d_bwd_launch(
    int dtype, const void* dy, const void* x, const void* w, void* dx,
    void* dw, void* db, void* part, int B, int L, int C, int K,
    long long dy_batch_stride, long long dy_row_stride,
    long long x_batch_stride, long long x_row_stride, int vec, int steps,
    int threads, void* stream) {
  const Geometry g{B, L, C, K, steps, threads};
  ILPM_DISPATCH_DTYPE(dtype, T,
      return (int)dispatch(vec, g, [&](auto v, auto k) {
        return bwd<T, decltype(v)::value, decltype(k)::value>(
            dy, x, w, dx, dw, db, part, g, dy_batch_stride, dy_row_stride,
            x_batch_stride, x_row_stride,
            static_cast<cudaStream_t>(stream));
      }))
  return (int)cudaErrorInvalidValue;
}
