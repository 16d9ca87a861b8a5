// RG-LRU diagonal linear recurrence for Hopper (sm_90a):
//
//     h_t = a_t * h_{t-1} + b_t        (elementwise over the LRU width)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan, kernel body _rglru_kernel): the state h is float32, carried
// from h0 serially in time and independent across (batch, width); each
// h_t is written in the dtype of a (float32 or bfloat16).  Unlike the
// Pallas kernel it takes any S >= 1 and any W: the serving path runs
// 3-token prefills and 1-token decode steps.
//
// Grid (ceil(W / 128), B); one thread a (b, w) channel, 128 channels a
// block along the contiguous W axis, so every time step's loads of a_t,
// b_t and store of h_t are coalesced.  Each thread walks S in steps of
// UNROLL: it loads the next UNROLL values of a and b into registers first
// (independent loads in flight while the dependent chain of FMAs runs),
// then folds them into h in order.  What bounds it on this card: the bytes
// (a and b read once, h written once; 2 operations an element), so it is
// memory-bound, and at B = 1, W = 4096 the grid is 32 blocks, which keeps
// most SMs idle and few loads in flight.  A chunked two-pass scan over S
// (per-chunk products and sums, then a carry pass) would fill the card;
// that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

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
  int S, W;
  long long sa[2], sb[2], so[2];   // [B, S] element strides; W stride 1
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, b and out share it); h0: [B, W]
// float32, contiguous.  strides: 6 element strides, the [B, S] strides of
// a, of b and of out; every W stride is 1.  The caller checks shapes
// (B, S, W >= 1).  Returns the CUDA error of the launch (0 on success).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b,
                              const float* h0, void* out, int B, int S,
                              int W, const long long* strides,
                              void* stream) {
  Params p;
  p.a = a;
  p.b = b;
  p.h0 = h0;
  p.out = out;
  p.S = S;
  p.W = W;
  for (int i = 0; i < 2; ++i) {
    p.sa[i] = strides[i];
    p.sb[i] = strides[2 + i];
    p.so[i] = strides[4 + i];
  }
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rglru_kernel<float><<<grid, kThreads, 0, s>>>(p);
  } else {
    rglru_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
