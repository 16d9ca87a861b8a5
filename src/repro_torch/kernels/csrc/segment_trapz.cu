// Hopper (sm_90a) kernels of the metering path, bound through a plain C
// interface (ctypes) -- no PyTorch headers.
//
// fused_meter     replaces the Pallas kernel _fused_meter_kernel
//                 (src/repro/kernels/segment_trapz.py, entry fused_meter).
// segment_trapz   replaces the Pallas kernel _segment_trapz_kernel
//                 (src/repro/kernels/segment_trapz.py, entry segment_trapz).
// ordered_segment_sum is NOT a port of a TPU kernel: it replaces the
//                 jax.ops.segment_sum calls of the compiled mega backend,
//                 summing each key's entries in log order so per-(device,
//                 state) joules and seconds are bit-equal to the numpy
//                 backend (atomics would sum in no fixed order).
//
// What bounds them on an H100.  The two trapezoid kernels stream N float64
// segments (fused_meter reads 36 B and writes 32 B per entry,
// segment_trapz moves 32 B) and issue some 90 FP64-pipe instructions per
// entry (counted in the SASS): two prefix integrals, each with two IEEE
// divides, a floor and a knot search.  At a fleet day's ~1e6 entries the
// bytes bind the least time (the FP64 term is 26-57 % of it); the kernels
// run at 40-60 % of it, held back by the chains of dependent divides and
// shared-memory lookups each entry is (each divide's slow-path branch
// keeps a thread's chains from interleaving).  The knot tables are staged once
// per block in shared memory; the TPU's branchless [BN, K] compare-and-sum
// lookup becomes a per-entry search that gives exactly the index
// bisect_right - 1 gives (rows are sorted; padding repeats the last knot):
// in fused_meter a bisect loop (as ported in slice 1), in segment_trapz a
// branchless search with a fixed trip count (ceil(log2 K) predicated
// steps, a template parameter).  Built with --fmad=false so every lane
// rounds step by step exactly as the plain PyTorch version does.
//
// fused_meter: one thread per entry in a grid-stride loop.
//
// segment_trapz: persistent blocks (two an SM), each walking tiles of
// kTile entries.  One producer thread fills a ring of kStages tiles in
// shared memory with 1-D bulk async copies (cp.async.bulk, no tensor map)
// of a, b and w, guarded by full/empty mbarriers, so several tiles stay
// in flight while sixteen consumer warps compute one.  Each consumer
// thread takes one 16-byte pair of entries (four prefix chains) and stores
// a 16-byte pair.  The last partial tile (bulk copies need 16-byte sizes)
// is read with plain loads.
//
// ordered_segment_sum: a stable counting sort for keys in [0, num), then
// an in-order walk.  (1) per-tile key histograms (shared-memory integer
// atomics: counts do not depend on order); (2) one exclusive scan in
// (key, tile) order, giving each tile its start within each key's run;
// (3) a stable in-tile scatter: one warp a tile takes its entries 32 at
// a time in index order (the next chunks' loads in flight), ranks each
// among the earlier entries of its key with __match_any_sync and a
// popcount of the lower lanes, and writes the VALUES of the entry's C
// channels side by side in key-major order -- one scattered 16-byte store
// an entry at C = 2, the step that costs most (writes no tile can
// coalesce: a tile holds ~1 entry of each key); (4) the walk: one warp a
// key stages its run in shared memory (coalesced loads, the next chunk in
// flight) and lane c adds channel c's values left to right from 0.0,
// eight loads ahead of eight adds.  The order of the adds is the log
// order: no tree, no pairwise sum, no float atomics.  The walk can take
// no less than the longest run times the latency of a dependent FP64 add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

// segment_trapz
constexpr int kTile = 1024;                    // entries a tile
constexpr int kStages = 3;                     // tiles in the ring
constexpr int kConsumers = 512;                // 16 warps x 2 entries
constexpr int kTrapzThreads = kConsumers + 32; // + the producer warp
constexpr int kPairs = kTile / 2 / kConsumers; // 16-byte pairs a thread

// ordered_segment_sum
constexpr int kSortTile = 2048;                // a tile is a multiple
constexpr int kScanWarps = 16;
constexpr int kAhead = 8;                      // 32-entry chunks ahead
constexpr int kMaxChannels = 4;
constexpr int kWalkWarps = 4;                  // keys a walk block
constexpr int kWalkChunk = 384;                // values a warp stages:
                                               // a multiple of 1..4
constexpr int kMaxNum = 49152;                 // 192 KB of counters

// ---- knot lookup and the prefix integral -----------------------------------

// bisect_right(kt, p) - 1 clipped to [0, K - 2], with STEPS =
// ceil(log2 K) predicated steps: the answer stays in [base, base + len).
template <int STEPS>
__device__ __forceinline__ int knot_index(double p, const double* kt,
                                          int K) {
  int base = 0, len = K;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int half = len >> 1;
    base = kt[base + half] <= p ? base + half : base;
    len -= half;
  }
  const int j = kt[base] <= p ? base : base - 1;
  return j < 0 ? 0 : (j > K - 2 ? K - 2 : j);
}

// F(t) = integral of the periodic piecewise-linear curve over [0, t]:
// whole periods times the one-period integral plus the in-period
// trapezoid prefix.  kt/kv/cum: one sorted row of K >= 2 knots.
template <int STEPS>
__device__ __forceinline__ double prefix_search(double t, const double* kt,
                                                const double* kv,
                                                const double* cum,
                                                double per, int K) {
  const double k = floor(t / per);
  const double p = t - k * per;
  const int j = knot_index<STEPS>(p, kt, K);
  const double kt_j = kt[j];
  const double kv_j = kv[j];
  const double span = kt[j + 1] - kt_j;
  const double d = p - kt_j;
  const double v_p = kv_j + (kv[j + 1] - kv_j) * d / (span > 0.0 ? span : 1.0);
  return k * cum[K - 1] + cum[j] + d * (kv_j + v_p) * 0.5;
}

// fused_meter's lookup, as ported in slice 1: bisect_right(kt, p) - 1
// clipped to [0, K - 2] by a loop of data-dependent trip count
__device__ __forceinline__ double prefix_at(double t, const double* kt,
                                                 const double* kv,
                                                 const double* cum,
                                                 double per, int K) {
  const double k = floor(t / per);
  const double p = t - k * per;
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kt[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int j = lo - 1;
  j = j < 0 ? 0 : (j > K - 2 ? K - 2 : j);
  const double kt_j = kt[j];
  const double kv_j = kv[j];
  const double span = kt[j + 1] - kt_j;
  const double d = p - kt_j;
  const double v_p = kv_j + (kv[j + 1] - kv_j) * d / (span > 0.0 ? span : 1.0);
  return k * cum[K - 1] + cum[j] + d * (kv_j + v_p) * 0.5;
}

__device__ __forceinline__ void stage(double* dst, const double* src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// stage by the first `threads` threads of the block (segment_trapz's
// consumers, while its producer warp issues the ring's first copies)
__device__ __forceinline__ void stage_n(double* dst, const double* src,
                                        int count, int threads) {
  for (int i = threadIdx.x; i < count; i += threads) dst[i] = src[i];
}

// ---- shared memory, barriers, bulk copies ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A wait lasts microseconds; one that lasts seconds is a fault, and it
// traps (a CUDA error the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (int i = 0;; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1 << 26)) __trap();
  }
}

// bytes (a multiple of 16) from 16-byte aligned global to shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- fused_meter -----------------------------------------------------------

__global__ void fused_meter_kernel(
    const double* __restrict__ a, const double* __restrict__ b,
    const double* __restrict__ dt, const double* __restrict__ w,
    const int32_t* __restrict__ g, const double* __restrict__ kt,
    const double* __restrict__ kv, const double* __restrict__ cum,
    const double* __restrict__ per, double* __restrict__ e,
    double* __restrict__ s, double* __restrict__ c,
    double* __restrict__ fa, long long n, int G, int K) {
  extern __shared__ double smem[];
  double* s_kt = smem;
  double* s_kv = s_kt + G * K;
  double* s_cum = s_kv + G * K;
  double* s_per = s_cum + G * K;
  stage(s_kt, kt, G * K);
  stage(s_kv, kv, G * K);
  stage(s_cum, cum, G * K);
  stage(s_per, per, G);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double wi = w[i];
    const double dti = dt[i];
    e[i] = wi * dti;
    s[i] = dti;
    const int gi = g[i];
    if (gi < 0 || gi >= G) {  // no table row: flag, never read past it
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      c[i] = nan;
      fa[i] = nan;
      continue;
    }
    const double* rkt = s_kt + gi * K;
    const double* rkv = s_kv + gi * K;
    const double* rcum = s_cum + gi * K;
    const double pg = s_per[gi];
    const double fai = prefix_at(a[i], rkt, rkv, rcum, pg, K);
    const double fbi = prefix_at(b[i], rkt, rkv, rcum, pg, K);
    c[i] = wi * (fbi - fai);
    fa[i] = fai;
  }
}

// ---- segment_trapz ---------------------------------------------------------

template <int STEPS>
__global__ void __launch_bounds__(kTrapzThreads, 2) segment_trapz_kernel(
    const double* __restrict__ a, const double* __restrict__ b,
    const double* __restrict__ w, const double* __restrict__ kt,
    const double* __restrict__ kv, const double* __restrict__ cum,
    double period, double* __restrict__ out, long long n, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);  // [stage][a,b,w][tile]
  double* s_kt = ring + kStages * 3 * kTile;
  double* s_kv = s_kt + K;
  double* s_cum = s_kv + K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_cum + K);
  const uint32_t full0 = smem_u32(bars);             // full[s]: +8 s
  const uint32_t empty0 = smem_u32(bars + kStages);  // empty[s]: +8 s
  const long long tiles = (n + kTile - 1) / kTile;
  const long long full_tiles = n / kTile;            // the ring's tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- the producer: one thread keeps the ring full ----
    if (lane == 0) {
      long long j = 0;
      for (long long t = blockIdx.x; t < full_tiles; t += gridDim.x, ++j) {
        const int st = (int)(j % kStages);
        mbar_wait(empty0 + 8 * st, (uint32_t)(((j / kStages) & 1) ^ 1));
        const uint32_t bar = full0 + 8 * st;
        const uint32_t dst = smem_u32(ring + st * 3 * kTile);
        mbar_expect_tx(bar, 3 * kTile * sizeof(double));
        bulk_load(dst, a + t * kTile, kTile * sizeof(double), bar);
        bulk_load(dst + kTile * sizeof(double), b + t * kTile,
                  kTile * sizeof(double), bar);
        bulk_load(dst + 2 * kTile * sizeof(double), w + t * kTile,
                  kTile * sizeof(double), bar);
      }
    }
    return;
  }

  // ---- the consumers ----
  stage_n(s_kt, kt, K, kConsumers);
  stage_n(s_kv, kv, K, kConsumers);
  stage_n(s_cum, cum, K, kConsumers);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  long long j = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    const long long base = t * kTile;
    double va[2 * kPairs], vb[2 * kPairs], vw[2 * kPairs];
    const bool ringed = t < full_tiles;
    if (ringed) {
      const int st = (int)(j % kStages);
      mbar_wait(full0 + 8 * st, (uint32_t)((j / kStages) & 1));
      const double2* ra = reinterpret_cast<const double2*>(ring +
                                                           st * 3 * kTile);
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = threadIdx.x + q * kConsumers;
        const double2 x = ra[p], y = ra[kTile / 2 + p], z = ra[kTile + p];
        va[2 * q] = x.x, va[2 * q + 1] = x.y;
        vb[2 * q] = y.x, vb[2 * q + 1] = y.y;
        vw[2 * q] = z.x, vw[2 * q + 1] = z.y;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);   // the slot is free
    } else {
      // the last partial tile: plain loads, the ragged edge masked
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long i = base + 2 * (threadIdx.x + q * kConsumers) + h;
          va[2 * q + h] = i < n ? a[i] : 0.0;
          vb[2 * q + h] = i < n ? b[i] : 0.0;
          vw[2 * q + h] = i < n ? w[i] : 0.0;
        }
      }
    }
    double o[2 * kPairs];
#pragma unroll
    for (int u = 0; u < 2 * kPairs; ++u) {
      const double fa =
          prefix_search<STEPS>(va[u], s_kt, s_kv, s_cum, period, K);
      const double fb =
          prefix_search<STEPS>(vb[u], s_kt, s_kv, s_cum, period, K);
      o[u] = vw[u] * (fb - fa);
    }
    if (ringed) {
      double2* dst = reinterpret_cast<double2*>(out + base);
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        dst[threadIdx.x + q * kConsumers] = make_double2(o[2 * q],
                                                         o[2 * q + 1]);
    } else {
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long i = base + 2 * (threadIdx.x + q * kConsumers) + h;
          if (i < n) out[i] = o[2 * q + h];
        }
      }
    }
  }
}

// ---- ordered_segment_sum ---------------------------------------------------

// (1) counts[t * num + k]: entries of key k in tile t
__global__ void __launch_bounds__(kThreads) sort_hist_kernel(
    const long long* __restrict__ keys, int* __restrict__ counts,
    long long n, int num, int tile) {
  extern __shared__ int cnt[];
  for (int k = threadIdx.x; k < num; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  for (long long i0 = lo; i0 < hi; i0 += 8 * blockDim.x) {
    long long k[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {             // the loads first, then adds
      const long long i = i0 + u * blockDim.x + threadIdx.x;
      k[u] = i < hi ? keys[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k[u] >= 0 && k[u] < num) atomicAdd(&cnt[k[u]], 1);
  }
  __syncthreads();
  int* row = counts + (long long)blockIdx.x * num;
  for (int k = threadIdx.x; k < num; k += blockDim.x) row[k] = cnt[k];
}

// (2) counts[t * num + k] <- entries of key k in tiles < t; totals[k].
// A block takes 32 keys (one a lane) and cuts the tiles among its warps.
__global__ void __launch_bounds__(32 * kScanWarps) sort_scan_kernel(
    int* __restrict__ counts, int* __restrict__ totals, int tiles, int num) {
  __shared__ int wsum[kScanWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const bool live = k < num;
  const int per = (tiles + kScanWarps - 1) / kScanWarps;
  const int t0 = warp * per;
  const int t1 = t0 + per < tiles ? t0 + per : tiles;
  int s = 0;
  if (live) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) s += counts[(long long)t * num + k];
  }
  wsum[warp][lane] = s;
  __syncthreads();
  int run = 0;
  for (int v = 0; v < warp; ++v) run += wsum[v][lane];
  if (!live) return;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    int* c = counts + (long long)t * num + k;
    const int x = *c;
    *c = run;
    run += x;
  }
  if (warp == kScanWarps - 1) totals[k] = run;
}

// (3) one warp a tile: the keys' starts (an exclusive scan of totals;
// tile 0 writes them for the walk) plus the tile's offsets give each
// key's next position; then the tile's entries in index order, 32 at a
// time, each written to its key's position + its rank among the lanes
// of the same key (__match_any_sync, a popcount of the lower lanes).
// The next kAhead chunks load while these are placed.
template <int C>
__global__ void __launch_bounds__(32) sort_scatter_kernel(
    const double* __restrict__ vals, const long long* __restrict__ keys,
    const int* __restrict__ offs, const int* __restrict__ totals,
    int* __restrict__ starts, double* __restrict__ sorted, long long n,
    int num, int tile) {
  extern __shared__ int pos[];
  const int lane = threadIdx.x;
  const long long t = blockIdx.x;
  const int* row = offs + t * num;
  int carry = 0;
  for (int k0 = 0; k0 < num; k0 += 32) {
    const int k = k0 + lane;
    const int v = k < num ? totals[k] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    const int start = carry + x - v;
    if (k < num) {
      pos[k] = start + row[k];
      if (t == 0) starts[k] = start;
    }
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (t == 0 && lane == 0) starts[num] = carry;
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const long long lo = t * tile;
  const long long hi = lo + tile < n ? lo + tile : n;
  long long nk[kAhead];
  double nv[kAhead][C];
  auto load = [&](long long i0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const long long i = i0 + u * 32 + lane;
      const bool in = i < hi;
      nk[u] = in ? keys[i] : -1;
#pragma unroll
      for (int c = 0; c < C; ++c) nv[u][c] = in ? vals[c * n + i] : 0.0;
    }
  };
  load(lo);
  for (long long i0 = lo; i0 < hi; i0 += 32 * kAhead) {
    long long kk[kAhead];
    double vv[kAhead][C];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      kk[u] = nk[u];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[u][c] = nv[u][c];
    }
    if (i0 + 32 * kAhead < hi) load(i0 + 32 * kAhead);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool ok = kk[u] >= 0 && kk[u] < num;
      const int key = ok ? (int)kk[u] : -1 - lane;   // matches itself only
      const unsigned m = __match_any_sync(0xffffffffu, key);
      const int dest = ok ? pos[key] + __popc(m & lower) : 0;
      __syncwarp();
      if (ok) {
        // an entry's C values side by side: one scattered store an entry
        double* d = sorted + (long long)dest * C;
        if constexpr (C % 2 == 0) {
#pragma unroll
          for (int c = 0; c < C; c += 2)
            *reinterpret_cast<double2*>(d + c) =
                make_double2(vv[u][c], vv[u][c + 1]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) d[c] = vv[u][c];
        }
        if ((m >> lane) == 1u) pos[key] += __popc(m);   // the group's last
      }
      __syncwarp();
    }
  }
}

// (4) one warp a key: the warp stages its run's values (C a entry, side
// by side) in shared memory kWalkChunk at a time (coalesced loads, the
// next chunk in flight while this one is summed), and lane c adds
// channel c's values left to right from 0.0.
template <int C>
__global__ void __launch_bounds__(32 * kWalkWarps) sort_walk_kernel(
    const double* __restrict__ sorted, const int* __restrict__ starts,
    double* __restrict__ out, int num) {
  constexpr int U = kWalkChunk / 32;
  __shared__ double buf[kWalkWarps][kWalkChunk];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int key = blockIdx.x * kWalkWarps + wp;
  if (key >= num) return;                         // the whole warp
  const long long s = (long long)starts[key] * C;
  const long long e = (long long)starts[key + 1] * C;
  double* b = buf[wp];
  double x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = s + lane + 32 * u;
    x[u] = i < e ? __ldg(sorted + i) : 0.0;
  }
  double acc = 0.0;
  // a chunk starts on an entry: kWalkChunk is a multiple of every C
  for (long long base = s; base < e; base += kWalkChunk) {
#pragma unroll
    for (int u = 0; u < U; ++u) b[lane + 32 * u] = x[u];
    __syncwarp();
    if (base + kWalkChunk < e) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = base + kWalkChunk + lane + 32 * u;
        x[u] = i < e ? __ldg(sorted + i) : 0.0;
      }
    }
    if (lane < C) {
      const int m = (int)(e - base < kWalkChunk ? e - base : kWalkChunk);
      int i = lane;
      for (; i + 7 * C < m; i += 8 * C) {         // 8 loads, then 8 adds
        double y[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) y[q] = b[i + q * C];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc += y[q];
      }
      for (; i < m; i += C) acc += b[i];
    }
    __syncwarp();
  }
  if (lane < C) out[(long long)lane * num + key] = acc;
}

// The latency of one dependent FP64 add: one thread, `steps` adds.
__global__ void dadd_chain_kernel(double x, long long steps,
                                  double* __restrict__ out) {
  double acc = 0.0;
  for (long long i = 0; i < steps; ++i) acc += x;
  *out = acc;
}

// ---- launch helpers --------------------------------------------------------

int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

int steps_for(int K) {  // ceil(log2 K)
  int s = 0;
  while ((1 << s) < K) ++s;
  return s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int STEPS>
int launch_segment_trapz(const double* a, const double* b, const double* w,
                         const double* kt, const double* kv,
                         const double* cum, double period, double* out,
                         long long n, int K, int blocks,
                         cudaStream_t stream) {
  const size_t smem = (size_t)(kStages * 3 * kTile + 3 * K) * sizeof(double) +
                      2 * kStages * sizeof(uint64_t);
  cudaError_t err = allow_smem(segment_trapz_kernel<STEPS>, smem);
  if (err != cudaSuccess) return (int)err;
  segment_trapz_kernel<STEPS><<<blocks, kTrapzThreads, smem, stream>>>(
      a, b, w, kt, kv, cum, period, out, n, K);
  return (int)cudaGetLastError();
}

template <int C>
int launch_scatter(const double* vals, const long long* keys,
                   const int* offs, const int* totals, int* starts,
                   double* sorted, long long n, int num, int tile, int tiles,
                   cudaStream_t stream) {
  const size_t smem = (size_t)num * sizeof(int);
  cudaError_t err = allow_smem(sort_scatter_kernel<C>, smem);
  if (err != cudaSuccess) return (int)err;
  sort_scatter_kernel<C><<<tiles, 32, smem, stream>>>(
      vals, keys, offs, totals, starts, sorted, n, num, tile);
  return (int)cudaGetLastError();
}

}  // namespace

#define STEPS_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11)

extern "C" int fused_meter_f64(const double* a, const double* b,
                               const double* dt, const double* w,
                               const int32_t* g, const double* kt,
                               const double* kv, const double* cum,
                               const double* per, double* e, double* s,
                               double* c, double* fa, long long n, int G,
                               int K, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(3 * G * K + G) * sizeof(double);
  fused_meter_kernel<<<blocks_for(n), kThreads, smem,
                       (cudaStream_t)stream>>>(a, b, dt, w, g, kt, kv, cum,
                                               per, e, s, c, fa, n, G, K);
  return (int)cudaGetLastError();
}

// tile: the caller's plan's tile (must be kTile); blocks: its grid
extern "C" int segment_trapz_f64(const double* a, const double* b,
                                 const double* w, const double* kt,
                                 const double* kv, const double* cum,
                                 double period, double* out, long long n,
                                 int K, int blocks, int tile, void* stream) {
  if (n <= 0) return 0;
  if (tile != kTile || blocks < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)w | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (steps_for(K)) {
#define X(S)                                                              \
  case S:                                                                 \
    return launch_segment_trapz<S>(a, b, w, kt, kv, cum, period, out, n, \
                                   K, blocks, st);
    STEPS_CASES(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// scratch from the caller: counts [tiles * num], totals [num],
// starts [num + 1] (int32), sorted [n * C] (float64); tile: the plan's
extern "C" int ordered_segment_sum_f64(
    const double* vals, const long long* keys, int* counts, int* totals,
    int* starts, double* sorted, double* out, long long n, int C, int num,
    int tile, void* stream) {
  if (n <= 0 || num <= 0 || C <= 0) return 0;
  if (C > kMaxChannels || num > kMaxNum || n > 0x7fffffffLL ||
      tile <= 0 || tile % kSortTile != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)((n + tile - 1) / tile);
  const size_t smem = (size_t)num * sizeof(int);
  cudaError_t err = allow_smem(sort_hist_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sort_hist_kernel<<<tiles, kThreads, smem, st>>>(keys, counts, n, num,
                                                  tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sort_scan_kernel<<<(num + 31) / 32, 32 * kScanWarps, 0, st>>>(
      counts, totals, tiles, num);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc;
  switch (C) {
#define X(CH)                                                              \
  case CH:                                                                 \
    rc = launch_scatter<CH>(vals, keys, counts, totals, starts, sorted, n, \
                            num, tile, tiles, st);                         \
    break;
    X(1) X(2) X(3) X(4)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const int walk_blocks = (num + kWalkWarps - 1) / kWalkWarps;
  switch (C) {
#define X(CH)                                                         \
  case CH:                                                            \
    sort_walk_kernel<CH><<<walk_blocks, 32 * kWalkWarps, 0, st>>>(    \
        sorted, starts, out, num);                                    \
    break;
    X(1) X(2) X(3) X(4)
#undef X
  }
  return (int)cudaGetLastError();
}

extern "C" int dadd_chain_f64(double x, long long steps, double* out,
                              void* stream) {
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, steps, out);
  return (int)cudaGetLastError();
}
