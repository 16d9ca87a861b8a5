// Shared device code of the attention kernels (flash_attention.cu,
// decode_attention.cu): a chunk of 32 keys and values is staged in shared
// memory, then one warp folds it into an online softmax for up to ROWS
// query rows that read the same kv head.
//
// Layout of the work:
//   * staging: the threads that share a chunk load it with 4-element
//     vector loads (coalesced along the head dim) and store the keys
//     transposed (ks[d][j], row pitch KPITCH) and the values as they are
//     (vs[j][d]), both in the input dtype;
//   * scores: lane j owns key (key0 + j) of the chunk and reads ks[d][j]
//     (free of bank conflicts); the query rows (pre-scaled, float32) are
//     read as broadcast float4s;
//   * softcap: with one, each score (of a pre-scaled query: the true
//     scaled score) becomes c tanh(score / c) before the mask
//     (softcap.cuh);
//   * softmax: per row, a warp max and a warp sum over the 32 scores;
//   * P.V: lane i owns head dims d = i, i + 32, ... (DPL of them) and reads
//     vs[j][d] and the row's probabilities from shared memory.
// Everything accumulates in float32 with plain FMAs (no tensor cores, so
// float32 inputs never round through TF32).  Masked keys get probability
// exactly 0, so a row that never sees a valid key ends with l = 0 and an
// output of 0 (the denominator is clamped at 1e-20, as in the reference
// kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "softcap.cuh"

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 8;       // query rows per warp
constexpr int CHUNK = 32;     // keys per chunk: one per lane
constexpr int KPITCH = 33;    // elements per staged key column (+1: no conflicts)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements, loaded and stored as one vector
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x[4];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// bytes of one staged chunk (transposed keys, then values)
template <typename T>
__host__ __device__ inline size_t chunk_bytes(int D) {
  return align16((size_t)D * KPITCH * sizeof(T)) +
         align16((size_t)CHUNK * D * sizeof(T));
}

// bytes of one warp's query rows and probabilities
__host__ __device__ inline size_t rows_bytes(int D) {
  return align16((size_t)ROWS * D * sizeof(float)) +
         (size_t)ROWS * CHUNK * sizeof(float);
}

// Online-softmax state of one warp's rows; lane i holds dims i + 32 * c.
template <int DPL>
struct RowState {
  float m[ROWS];
  float l[ROWS];
  float acc[ROWS][DPL];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
    }
  }
};

// Stage keys and values [key0, key0 + nk), nk <= CHUNK, into ks (transposed,
// zero past nk) and vs; the nthreads threads from tid share the loads.
// kb/vb point at key 0 of this (batch, kv head); sk/sv are key strides in
// elements; D % 4 == 0 and rows start 4-element aligned (the wrappers check).
template <typename T>
__device__ void stage_chunk(const T* __restrict__ kb, long long sk,
                            const T* __restrict__ vb, long long sv, int key0,
                            int nk, int D, T* ks, T* vs, int tid,
                            int nthreads) {
  const int dv = D / 4;
#pragma unroll 8
  for (int e = tid; e < CHUNK * dv; e += nthreads) {
    const int j = e / dv, d = (e - j * dv) * 4;
    Vec4<T> kv;
    if (j < nk) {
      kv = *reinterpret_cast<const Vec4<T>*>(kb + (key0 + j) * sk + d);
      *reinterpret_cast<Vec4<T>*>(vs + j * D + d) =
          *reinterpret_cast<const Vec4<T>*>(vb + (key0 + j) * sv + d);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) kv.x[i] = from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ks[(d + i) * KPITCH + j] = kv.x[i];
  }
}

// Fold the staged keys [key0, key0 + nk) into the state of one warp's rows.
// ok(r, key) says whether row r sees key; cap (natural units, the scale
// already in the pre-scaled queries) is applied to every score first.
template <typename T, int DPL, typename Mask>
__device__ void fold_chunk(RowState<DPL>& st, const T* ks, const T* vs,
                           int key0, int nk, int D, const float* qs,
                           float* ps, const Mask& ok, SoftCap cap,
                           int lane) {
  float s[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    const float k0 = to_f32(ks[(d + 0) * KPITCH + lane]);
    const float k1 = to_f32(ks[(d + 1) * KPITCH + lane]);
    const float k2 = to_f32(ks[(d + 2) * KPITCH + lane]);
    const float k3 = to_f32(ks[(d + 3) * KPITCH + lane]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(qs + r * D + d);
      s[r] = fmaf(q.x, k0, s[r]);
      s[r] = fmaf(q.y, k1, s[r]);
      s[r] = fmaf(q.z, k2, s[r]);
      s[r] = fmaf(q.w, k3, s[r]);
    }
  }

  if (cap.on) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = cap(s[r]);
  }
  const int key = key0 + lane;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const bool valid = lane < nk && ok(r, key);
    const float sr = valid ? s[r] : NEG_INF;
    const float m_new = fmaxf(st.m[r], warp_max(sr));
    const float p = valid ? expf(sr - m_new) : 0.f;
    const float alpha = expf(st.m[r] - m_new);
    st.l[r] = st.l[r] * alpha + warp_sum(p);
    st.m[r] = m_new;
#pragma unroll
    for (int c = 0; c < DPL; ++c) st.acc[r][c] *= alpha;
    ps[r * CHUNK + lane] = p;
  }
  __syncwarp();

  for (int j = 0; j < nk; ++j) {
    float v[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      v[c] = d < D ? to_f32(vs[j * D + d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = ps[r * CHUNK + j];
#pragma unroll
      for (int c = 0; c < DPL; ++c) st.acc[r][c] = fmaf(p, v[c], st.acc[r][c]);
    }
  }
  __syncwarp();
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn
