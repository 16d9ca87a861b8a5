// One-token GQA attention against a KV cache (decode), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, kernel body _decode_kernel): the G query heads of one
// kv head attend over cache rows [0, length[b]) with an online softmax in
// float32; rows at or past length[b] are masked and the walk stops at the
// last chunk that holds a valid row (the early stop).  K and V are taken by
// strides, so the model's [B, T, Hkv, D] cache is read through a permuted
// view with no copy.
//
// Grid (Hkv * ceil(G / 8), B); one block of up to 8 warps a (batch, kv
// head, group of up to 8 query heads).  The warps take the block's chunks
// of 32 cache rows in turn, each staging its chunk in its own shared memory
// (attention_common.cuh), then merge their softmax states through shared
// memory.  What bounds it on this card: the bytes of K and V read up to
// length (4 operations per element and query head of the group), so it is
// memory-bound; with one block per (batch, kv head) a small batch keeps
// few SMs busy.  Splitting the cache over more blocks (split-KV with a
// combine pass) is later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;
  int H, Hkv, T, D;
  float scale;
  long long sq[3], sk[4], sv[4], so[3];   // [B, H, D]; [B, Hkv, T, D]
};

struct DecodeMask {
  int rows, len;
  __device__ bool operator()(int r, int key) const {
    return r < rows && key < len;
  }
};

// shared memory of one warp: its staged chunk, query rows and probabilities
template <typename T>
__host__ __device__ inline size_t warp_bytes(int D) {
  return chunk_bytes<T>(D) + rows_bytes(D);
}

template <typename T, int DPL>
__global__ void decode_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int G = p.H / p.Hkv;
  const int groups = (G + ROWS - 1) / ROWS;
  const int kvh = blockIdx.x / groups;
  const int h0 = kvh * G + (blockIdx.x % groups) * ROWS;   // first q head
  const int rows = min(ROWS, (kvh + 1) * G - h0);
  const int b = blockIdx.y;
  const int D = p.D;
  char* mine = smem + warp * warp_bytes<T>(D);
  T* ks = reinterpret_cast<T*>(mine);
  T* vs = reinterpret_cast<T*>(mine + align16((size_t)D * KPITCH * sizeof(T)));
  float* qs = reinterpret_cast<float*>(mine + chunk_bytes<T>(D));
  float* ps = qs + align16((size_t)ROWS * D * sizeof(float)) / sizeof(float);

  const T* q = static_cast<const T*>(p.q) + b * p.sq[0];
  for (int r = 0; r < ROWS; ++r)
    for (int d = lane; d < D; d += 32)
      qs[r * D + d] =
          r < rows ? to_f32(q[(h0 + r) * p.sq[1] + d]) * p.scale : 0.f;
  __syncwarp();

  const int len = max(0, min(p.length[b], p.T));
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const DecodeMask ok{rows, len};
  RowState<DPL> st;
  st.init();
  for (int key0 = warp * CHUNK; key0 < len; key0 += warps * CHUNK) {
    const int nk = min(CHUNK, len - key0);
    stage_chunk<T>(kb, p.sk[2], vb, p.sv[2], key0, nk, D, ks, vs, lane, 32);
    __syncwarp();
    fold_chunk<T, DPL>(st, ks, vs, key0, nk, D, qs, ps, ok, lane);
  }

  // merge the warps' states: cm/cl [warps][ROWS], cacc [warps][ROWS][D]
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);
  float* cl = cm + warps * ROWS;
  float* cacc = cl + warps * ROWS;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      cm[warp * ROWS + r] = st.m[r];
      cl[warp * ROWS + r] = st.l[r];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) cacc[(warp * ROWS + r) * D + d] = st.acc[r][c];
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(p.o) + b * p.so[0];
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float m = NEG_INF;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, cm[w * ROWS + r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float f = expf(cm[w * ROWS + r] - m);
      l += cl[w * ROWS + r] * f;
      a += cacc[(w * ROWS + r) * D + d] * f;
    }
    o[(h0 + r) * p.so[1] + d] = from_f32<T>(a / fmaxf(l, 1e-20f));
  }
}

template <typename T, int DPL>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // 8 warps while their shared memory fits a block (227 KB), else fewer
  int warps = 8;
  while (warps > 1 && warps * warp_bytes<T>(p.D) > 227 * 1024) warps /= 2;
  const size_t smem = warps * warp_bytes<T>(p.D);
  cudaError_t err = allow_smem(decode_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  const int G = p.H / p.Hkv;
  const dim3 grid(p.Hkv * ((G + ROWS - 1) / ROWS), B);
  decode_kernel<T, DPL><<<grid, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  const int dpl = (p.D + 31) / 32;
  if (dpl <= 1) return launch<T, 1>(p, B, stream);
  if (dpl <= 2) return launch<T, 2>(p, B, stream);
  if (dpl <= 4) return launch<T, 4>(p, B, stream);
  return launch<T, 8>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); length:
// [B] int32 on the device.  strides: 14 element strides, [B, H, D] of q,
// [B, Hkv, T, D] of k and of v, then [B, H, D] of out; every last-dim
// stride is 1.  The caller checks shapes (D % 4 == 0, D <= 256,
// H % Hkv == 0).  Returns the CUDA error of the launch (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const int* length,
                                    void* out, int B, int H, int Hkv, int T,
                                    int D, float scale,
                                    const long long* strides, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.length = length;
  p.o = out;
  p.H = H;
  p.Hkv = Hkv;
  p.T = T;
  p.D = D;
  p.scale = scale;
  for (int i = 0; i < 3; ++i) p.sq[i] = strides[i];
  for (int i = 0; i < 4; ++i) {
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[7 + i];
  }
  for (int i = 0; i < 3; ++i) p.so[i] = strides[11 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, B, s)
                                     : dispatch<__nv_bfloat16>(p, B, s);
  return (int)err;
}
