// RG-LRU diagonal linear recurrence for Hopper (sm_90a):
//
//     h_t = a_t * h_{t-1} + b_t        (elementwise over the LRU width)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan, kernel body _rglru_kernel): the state h is float32, carried
// from h0 in time and independent across (batch, width); each h_t is
// written in the dtype of a (float32 or bfloat16).  Unlike the Pallas
// kernel it takes any S >= 1 and any W: the serving path runs 3-token
// prefills and 1-token decode steps.
//
// What bounds it on this card: the bytes (a and b read once, h written
// once; 2 operations an element), so it is memory-bound, and the card
// reaches its memory rate only with many 16-byte-wide warps' loads in
// flight on every SM.  The recurrence is serial in time, so the wrapper
// picks one of two kernels by S alone:
//   * serial (rglru_kernel, S < 2 * kChunk): one thread a (b, w) channel,
//     128 channels a block, walking S with 8 steps of loads ahead.  At the
//     launcher's [1, 3, 4096] and [4, 1, 4096] calls it is launch-bound,
//     and one launch is all it costs;
//   * chunked (rglru_chunked_kernel): S is cut into chunks of kChunk steps,
//     and a block takes one (chunk, b, 128 channels) tile, so a long
//     prompt at B = 1 fills the card ([1, 2048, 4096]: 2,048 blocks
//     against the serial kernel's 32).  One pass with a look-back: the
//     block loads its chunk's a and b into registers once, publishes the
//     chunk's aggregate (A = prod a_t, B = the scan from 0) to scratch,
//     then takes its carry h_in from h0 and its predecessors: from the
//     inclusive state (the last h) of chunk c - kWindow - 1 when c >
//     kWindow, else from h0, folding the aggregates of the chunks between
//     in order (h = A_j h + B_j).  The carry's formula never depends on
//     timing, so two calls give equal bits.  It publishes its last h
//     (A h_in + B), then rescans its chunk from h_in with the serial
//     kernel's per-step fmaf (only the carry's rounding differs from the
//     serial order) and writes h_t.  Blocks take tiles from an atomic
//     ticket in chunk order, so every block a block waits for has started
//     (forward progress); the flags carry a per-call epoch, so the scratch
//     needs no memset between calls (the last ticket resets the ticket
//     counter).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr int kChunk = 32;    // time steps a chunk
constexpr int kWindow = 16;   // aggregates folded into a carry, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* a;
  const void* b;
  const float* h0;   // [B, W] contiguous float32
  void* out;
  int B, S, W;
  long long sa[2], sb[2], so[2];   // [B, S] element strides; W stride 1
  // chunked route: scratch (see layout()), and this call's epoch
  unsigned* ticket;
  unsigned* flags;   // [B, C, nwb, 2]: aggregate ready, last h ready
  float* agg;        // [B, C, 2, W]: A then B of each chunk
  float* last;       // [B, C, W]: h at each chunk's last step
  unsigned epoch;
  int C, nwb;        // chunks; 128-channel blocks of W
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel(const Params p) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= p.W) return;
  const int bi = blockIdx.y;
  const T* a = static_cast<const T*>(p.a) + bi * p.sa[0] + w;
  const T* b = static_cast<const T*>(p.b) + bi * p.sb[0] + w;
  T* o = static_cast<T*>(p.out) + bi * p.so[0] + w;
  float h = p.h0[(long long)bi * p.W + w];
  for (int t0 = 0; t0 < p.S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < p.S) {
        av[u] = to_f32(a[(t0 + u) * p.sa[1]]);
        bv[u] = to_f32(b[(t0 + u) * p.sb[1]]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < p.S) {
        h = fmaf(av[u], h, bv[u]);
        o[(t0 + u) * p.so[1]] = from_f32<T>(h);
      }
    }
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* ptr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* ptr, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(ptr), "r"(v)
               : "memory");
}

// Wait until a predecessor raises its flag to this call's epoch.  A
// predecessor has always started (the ticket), so a wait is microseconds;
// one that lasts seconds is a fault, and it traps (a CUDA error the
// wrapper raises) instead of hanging the card.
__device__ __forceinline__ void wait_flag(const unsigned* ptr,
                                          unsigned epoch) {
  for (int i = 0; ld_acquire(ptr) != epoch; ++i) {
    if (i > (1 << 22)) __trap();
    __nanosleep(64);
  }
}

// Publish this block's values (already stored by every thread): the
// barrier orders every thread's stores before thread 0's release of the
// flag (cumulative at gpu scope), so only thread 0 waits on the fence.
__device__ __forceinline__ void publish(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, epoch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_chunked_kernel(const Params p) {
  __shared__ unsigned tile_s;
  const int total = p.C * p.B * p.nwb;
  if (threadIdx.x == 0) {
    const unsigned tk = atomicAdd(p.ticket, 1u);
    if (tk == (unsigned)total - 1) atomicExch(p.ticket, 0u);   // next call
    tile_s = tk;
  }
  __syncthreads();
  const int tile = (int)tile_s;
  const int c = tile / (p.B * p.nwb);   // chunks in order of the ticket
  const int bi = (tile / p.nwb) % p.B;
  const int wb = tile % p.nwb;
  const int w = wb * kThreads + threadIdx.x;
  const bool on = w < p.W;
  const int t0 = c * kChunk, n = min(kChunk, p.S - t0);

  // this chunk's a and b, once (identity steps past S or W)
  const T* a = static_cast<const T*>(p.a) + bi * p.sa[0] + w;
  const T* b = static_cast<const T*>(p.b) + bi * p.sb[0] + w;
  float av[kChunk], bv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool ok = on && u < n;
    av[u] = ok ? to_f32(a[(long long)(t0 + u) * p.sa[1]]) : 1.f;
    bv[u] = ok ? to_f32(b[(long long)(t0 + u) * p.sb[1]]) : 0.f;
  }
  float A = 1.f, Bc = 0.f;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    A *= av[u];
    Bc = fmaf(av[u], Bc, bv[u]);
  }
  const long long row = (long long)bi * p.C + c;   // (b, chunk)
  unsigned* flag = p.flags + (row * p.nwb + wb) * 2;
  if (on) {
    p.agg[(2 * row) * p.W + w] = A;
    p.agg[(2 * row + 1) * p.W + w] = Bc;
  }
  publish(flag, p.epoch);

  // the carry: from h0 or chunk lo - 1's last h, then aggregates lo..c-1
  const int lo = max(0, c - kWindow);
  const long long row0 = (long long)bi * p.C;
  // (each waiting thread acquires one flag; the barrier passes what they
  // saw on to every thread)
  if ((int)threadIdx.x < c - lo)
    wait_flag(p.flags + ((row0 + lo + threadIdx.x) * p.nwb + wb) * 2,
              p.epoch);
  if (lo > 0 && threadIdx.x == kThreads - 1)
    wait_flag(p.flags + ((row0 + lo - 1) * p.nwb + wb) * 2 + 1, p.epoch);
  __syncthreads();
  float h = 0.f;
  if (on) {
    h = lo > 0 ? __ldcg(p.last + (row0 + lo - 1) * p.W + w)
               : p.h0[(long long)bi * p.W + w];
#pragma unroll
    for (int q = 0; q < kWindow; ++q) {
      const long long j = row0 + lo + q;
      if (lo + q < c)
        h = fmaf(__ldcg(p.agg + (2 * j) * p.W + w), h,
                 __ldcg(p.agg + (2 * j + 1) * p.W + w));
    }
  }

  // the chunk's last h from its carry and aggregate, published before the
  // rescan (so the release waits on this one store, not on the outputs),
  // where a later chunk starts from it
  if (c + kWindow + 1 < p.C) {
    if (on) p.last[row * p.W + w] = fmaf(A, h, Bc);
    publish(flag + 1, p.epoch);
  }

  // the rescan from the carry, step by step as the serial kernel
  T* o = static_cast<T*>(p.out) + bi * p.so[0] + w;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (on && u < n) {
      h = fmaf(av[u], h, bv[u]);
      o[(long long)(t0 + u) * p.so[1]] = from_f32<T>(h);
    }
  }
}

// The scratch of the chunked route, in 32-bit words: the ticket (padded
// to 32 words), the flags, then the aggregates and last states (float),
// each part 128-byte aligned.  scratch_words() in kernels/rglru_scan.py
// sizes it; a smaller scratch is refused.
inline long long align32(long long words) { return (words + 31) / 32 * 32; }

struct Layout {
  long long flags, agg, last, total;   // word offsets, and the total
};

Layout layout(int B, int C, int nwb, int W) {
  const long long bc = (long long)B * C;
  Layout l;
  l.flags = 32;
  l.agg = l.flags + align32(2 * bc * nwb);
  l.last = l.agg + align32(2 * bc * W);
  l.total = l.last + align32(bc * W);
  return l;
}

std::atomic<unsigned> g_epoch{0};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it); h0: [B, W]
// float32, contiguous.  chunked: 0 for the serial kernel, 1 for the
// chunked one, which needs `scratch`: scratch_words 32-bit words, at least
// layout()'s total, zero when first used, and used by one stream at a
// time; the serial kernel ignores it (may be null).
// strides: 6 element strides, the [B, S] strides of a, of b and of out;
// every W stride is 1.  The caller checks shapes (B, S, W >= 1).
// Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue if scratch is too small).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b,
                              const float* h0, void* out, int B, int S,
                              int W, int chunked, void* scratch,
                              long long scratch_words,
                              const long long* strides, void* stream) {
  Params p;
  p.a = a;
  p.b = b;
  p.h0 = h0;
  p.out = out;
  p.B = B;
  p.S = S;
  p.W = W;
  for (int i = 0; i < 2; ++i) {
    p.sa[i] = strides[i];
    p.sb[i] = strides[2 + i];
    p.so[i] = strides[4 + i];
  }
  p.nwb = (W + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!chunked) {
    const dim3 grid(p.nwb, B);
    if (dtype == 0) {
      rglru_kernel<float><<<grid, kThreads, 0, s>>>(p);
    } else {
      rglru_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
  }
  p.C = (S + kChunk - 1) / kChunk;
  const Layout l = layout(B, p.C, p.nwb, W);
  if (!scratch || l.total > scratch_words) return (int)cudaErrorInvalidValue;
  unsigned* base = static_cast<unsigned*>(scratch);
  p.ticket = base;
  p.flags = base + l.flags;
  p.agg = reinterpret_cast<float*>(base + l.agg);
  p.last = reinterpret_cast<float*>(base + l.last);
  // a fresh epoch a call (0 is what fresh scratch holds)
  unsigned e = ++g_epoch;
  if (e == 0) e = ++g_epoch;
  p.epoch = e;
  const int blocks = p.C * B * p.nwb;
  if (dtype == 0) {
    rglru_chunked_kernel<float><<<blocks, kThreads, 0, s>>>(p);
  } else {
    rglru_chunked_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
