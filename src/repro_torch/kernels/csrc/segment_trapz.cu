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
// What bounds them on an H100: the two trapezoid kernels stream N float64
// segments (fused_meter reads 36 B and writes 32 B per entry, segment_trapz
// moves 32 B) and do ~30 FP64 operations plus two binary searches over
// <= a few dozen knots per entry -- far below the card's FP64 rate, so
// they are bound by memory bandwidth and, at a fleet day's ~1e6 entries,
// by launch latency.  The design follows from that: one thread per entry
// in a grid-stride loop (coalesced 8-byte loads, ragged edge masked, no
// padding), the small knot tables staged once per block in shared memory
// so the data-dependent knot lookups never touch device memory, and no
// scratch memory at all.  The TPU's branchless [BN, K] compare-and-sum
// lookup becomes a per-thread bisect_right in shared memory, which gives
// the same index (rows are sorted; padding repeats the last knot).
// Built with --fmad=false so every lane rounds step by step exactly as
// the plain PyTorch version does.
//
// ordered_segment_sum gives each (channel, key) one thread that walks
// its run of a stable key sort in order: a dependent chain of gathered
// loads, bound by latency, over a run of ~1e3 entries per key.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

// F(t) = integral of the periodic piecewise-linear curve over [0, t]:
// whole periods times the one-period integral plus the in-period
// trapezoid prefix.  kt/kv/cum: one sorted row of K >= 2 knots.
__device__ __forceinline__ double prefix_at(double t, const double* kt,
                                            const double* kv,
                                            const double* cum, double per,
                                            int K) {
  const double k = floor(t / per);
  const double p = t - k * per;
  // bisect_right(kt, p) - 1, clipped to [0, K - 2]
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

__global__ void segment_trapz_kernel(
    const double* __restrict__ a, const double* __restrict__ b,
    const double* __restrict__ w, const double* __restrict__ kt,
    const double* __restrict__ kv, const double* __restrict__ cum,
    double period, double* __restrict__ out, long long n, int K) {
  extern __shared__ double smem[];
  double* s_kt = smem;
  double* s_kv = s_kt + K;
  double* s_cum = s_kv + K;
  stage(s_kt, kt, K);
  stage(s_kv, kv, K);
  stage(s_cum, cum, K);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const double fa = prefix_at(a[i], s_kt, s_kv, s_cum, period, K);
    const double fb = prefix_at(b[i], s_kt, s_kv, s_cum, period, K);
    out[i] = w[i] * (fb - fa);
  }
}

__global__ void ordered_segment_sum_kernel(
    const double* __restrict__ vals, const long long* __restrict__ order,
    const long long* __restrict__ offsets, double* __restrict__ out,
    long long n, int C, int num) {
  const long long total = (long long)C * num;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int ch = (int)(t / num);
    const int key = (int)(t % num);
    const double* v = vals + (long long)ch * n;
    double acc = 0.0;
    for (long long i = offsets[key]; i < offsets[key + 1]; ++i) {
      acc += v[order[i]];
    }
    out[t] = acc;
  }
}

int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

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

extern "C" int segment_trapz_f64(const double* a, const double* b,
                                 const double* w, const double* kt,
                                 const double* kv, const double* cum,
                                 double period, double* out, long long n,
                                 int K, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)(3 * K) * sizeof(double);
  segment_trapz_kernel<<<blocks_for(n), kThreads, smem,
                         (cudaStream_t)stream>>>(a, b, w, kt, kv, cum,
                                                 period, out, n, K);
  return (int)cudaGetLastError();
}

extern "C" int ordered_segment_sum_f64(const double* vals,
                                       const long long* order,
                                       const long long* offsets,
                                       double* out, long long n, int C,
                                       int num, void* stream) {
  const long long total = (long long)C * num;
  if (total <= 0) return 0;
  ordered_segment_sum_kernel<<<blocks_for(total), kThreads, 0,
                               (cudaStream_t)stream>>>(vals, order, offsets,
                                                       out, n, C, num);
  return (int)cudaGetLastError();
}
