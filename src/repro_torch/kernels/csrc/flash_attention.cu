// Causal (optionally sliding-window) GQA attention for prefill, forward
// only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, kernel body _flash_kernel): the same online softmax
// with float32 running max, denominator and accumulator; q head h reads kv
// head h / (H / Hkv) with no repeat; K chunks that no row of a warp can see
// (above the causal diagonal, or before the window) are skipped.  Query
// row i sits at position q_offset + i (the masks and the skipping work on
// positions); with a softcap c > 0 each scaled score becomes
// c tanh(score / c) before the mask (softcap.cuh).  Unlike the Pallas
// kernel it takes any S and T (ragged tails are masked) and tensors by
// strides, so the model hands it permuted views of its [B, S, H, D]
// activations and [B, T, Hkv, D] cache with no copy.
//
// Grid (ceil(S / 32), H, B); 4 warps a block, each warp owns 8 consecutive
// query positions of one head.  The block stages each chunk of 32 keys and
// values it can see in shared memory once, and every warp whose rows see
// the chunk folds it in (attention_common.cuh).  What bounds it on this
// card: at the serving shapes it is compute-bound in theory (~4 S T D H / 2
// operations, causal, against ~(2 S H + 2 T Hkv) D bytes); this first
// version runs its products on the FP32 pipes with plain FMAs, not on the
// tensor cores, so it sits far from the bf16 tensor-core bound.  wgmma/TMA
// tiles are later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int WARPS = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, T, D, causal, window, q_offset;
  float scale;
  SoftCap cap;                            // in natural units
  long long sq[4], sk[4], sv[4], so[4];   // strides of [B, H|Hkv, S|T, D]
};

// row r of a warp whose first row is q0; positions from q_offset
struct FlashMask {
  int q0, S, causal, window, q_offset;
  __device__ bool operator()(int r, int key) const {
    const int pos = q_offset + q0 + r;
    return q0 + r < S && (!causal || key <= pos) &&
           (window <= 0 || pos - key < window);
  }
};

template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int D = p.D;
  char* smem = reinterpret_cast<char*>(smem4);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + align16((size_t)D * KPITCH * sizeof(T)));
  float* qs = reinterpret_cast<float*>(smem + chunk_bytes<T>(D) +
                                       warp * rows_bytes(D));
  float* ps = qs + align16((size_t)ROWS * D * sizeof(float)) / sizeof(float);

  const int qb = blockIdx.x * WARPS * ROWS;   // the block's first row
  const int q0 = qb + warp * ROWS;            // this warp's first row
  const T* q = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[1];
  for (int r = 0; r < ROWS; ++r) {
    const int pos = q0 + r;
    for (int d = lane; d < D; d += 32)
      qs[r * D + d] =
          pos < p.S ? to_f32(q[pos * p.sq[2] + d]) * p.scale : 0.f;
  }
  __syncwarp();

  // keys the block's rows can see, and those this warp's rows can see
  // (rows at positions q_offset + row)
  const int kvh = h / (p.H / p.Hkv);
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const int off = p.q_offset;
  const int bend =
      p.causal ? min(p.T, off + min(qb + WARPS * ROWS, p.S)) : p.T;
  const int bbeg = p.window > 0 ? max(0, off + qb - p.window + 1) : 0;
  const int wend = q0 >= p.S ? 0
                   : p.causal ? min(p.T, off + min(q0 + ROWS, p.S)) : p.T;
  const int wbeg = p.window > 0 ? max(0, off + q0 - p.window + 1) : 0;
  const FlashMask ok{q0, p.S, p.causal, p.window, off};
  RowState<DPL> st;
  st.init();
  for (int key0 = bbeg / CHUNK * CHUNK; key0 < bend; key0 += CHUNK) {
    __syncthreads();                          // the last chunk is consumed
    stage_chunk<T>(kb, p.sk[2], vb, p.sv[2], key0, min(CHUNK, bend - key0),
                   D, ks, vs, threadIdx.x, blockDim.x);
    __syncthreads();
    if (key0 < wend && key0 + CHUNK > wbeg)
      fold_chunk<T, DPL>(st, ks, vs, key0, min(CHUNK, wend - key0), D, qs,
                         ps, ok, p.cap, lane);
  }

  T* o = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int pos = q0 + r;
    const float l = fmaxf(st.l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (pos < p.S && d < D)
        o[pos * p.so[2] + d] = from_f32<T>(st.acc[r][c] / l);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = chunk_bytes<T>(p.D) + WARPS * rows_bytes(p.D);
  cudaError_t err = allow_smem(flash_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + WARPS * ROWS - 1) / (WARPS * ROWS), p.H, B);
  flash_kernel<T, DPL><<<grid, WARPS * 32, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  strides:
// 16 element strides, [B, H, S, D] of q, [B, Hkv, T, D] of k and v, then
// [B, H, S, D] of out; every last-dim stride is 1.  window <= 0: none;
// q_offset >= 0: the position of query row 0; softcap <= 0: none.  The
// caller checks shapes (D % 4 == 0, D <= 256, H % Hkv == 0).  Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int Hkv, int S, int T, int D, int causal,
                                   int window, int q_offset, float scale,
                                   float softcap, const long long* strides,
                                   void* stream) {
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  p.cap = SoftCap::make(softcap, 1.f, 1.f);    // q arrives pre-scaled
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.so[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch<float>(p, B, s)
                                     : dispatch<__nv_bfloat16>(p, B, s);
  return (int)err;
}
