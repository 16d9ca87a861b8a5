// Causal (optionally sliding-window) GQA attention for prefill, float32,
// on the tensor cores at float32 accuracy, for Hopper (sm_90a): the
// "f32tc" route of kernels/flash_attention.py.  Besides the output it
// writes each row's log-sum-exp, which the backward kernel
// (flash_attention_f32_bwd.cu) reads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:78
// (flash_attention, kernel body _flash_kernel) for float32 inputs with
// head dim 32, 64, 128 or 256; bfloat16 takes flash_attention_sm90.cu and
// other head dims flash_attention.cu.  It computes what the Pallas kernel
// computes: an online softmax with a float32 running max, denominator and
// accumulator; q head h reads kv head h / (H / Hkv) with no repeat; query
// row i sits at position q_offset + i and key j at position j, causal
// masks j > q_offset + i, window masks q_offset + i - j >= window; masked
// keys get probability exactly 0; out = acc / max(l, 1e-20).  With a
// softcap c > 0 each scaled score becomes c tanh(score / c) before the
// mask (softcap.cuh).  lse [B, H, S] is the natural log-sum-exp of each
// row's scaled, capped, masked scores (-inf, with an output of 0, for a
// row that sees no key).  It takes any S and T, and q, k, v and out by
// strides (the model's permuted views, no copy).
//
// What bounds it: operations.  A causal prefill does 4 D flops per
// visible (query, key) pair against ~2 (S H + T Hkv) D float32 bytes
// (~470 flops a byte at Qwen2.5-7B's training shape).  The FP32 pipe
// would bound it at 67 TFLOP/s; TF32 tensor cores run at 495, and three
// TF32 products a float32 product ("3xTF32", attention_tf32.cuh) keep
// float32 accuracy at 3 x 4 D flops a pair, a bound 2.5x lower.  The
// design:
//   * a CTA owns BM query rows of one (batch, head), 16 a warp (128 rows,
//     8 warps; 64 rows, 4 warps, at D = 256); Q stays in shared memory as
//     float32 and each warp splits its A fragments per k-step;
//   * K and V come in tiles of BN keys: cp.async copies tile i + 1 into a
//     staging buffer while the warps compute on tile i, which was split
//     once into hi / lo buffers shared by all the CTA's warps (staging +
//     split buffers: two stages);
//   * S = Q K^T and O += P V are mma.sync m16n8k8 TF32 products, three a
//     product, the two small cross terms summed in registers of their
//     own; P never leaves registers, and each tile's P V is summed apart
//     and added to O in float32 (attention_tf32.cuh's gemm_pb_add): the
//     tensor cores truncate as they accumulate, and kept apart the small
//     terms and the sum over thousands of keys escape it;
//   * the online softmax runs on the accumulator fragments, in exp2 units
//     with the scale and log2(e) folded (row max by two quad shuffles;
//     the sum is kept per thread and reduced once at the end);
//   * K tiles wholly above the causal diagonal or wholly before the
//     window are never loaded; a warp skips the tiles none of its rows
//     sees; only tiles that cross an edge are masked (all from the rows'
//     positions, q_offset + row); the heaviest query tiles launch first.

#include "attention_tf32.cuh"
#include "softcap.cuh"

namespace {

using namespace tf32;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int H, Hkv, S, T, causal, window, q_offset;
  float scale_log2;                        // 1 / sqrt(D) * log2(e)
  SoftCap cap;                             // in exp2 units
  long long sq[4], sk[4], sv[4], so[4];   // strides of [B, H|Hkv, S|T, D]
};

template <int D>
struct Cfg {
  static constexpr int P = D + 4;
  static constexpr int BM = D > 128 ? 64 : 128;      // query rows a CTA
  static constexpr int BN = D > 128 ? 16 : D > 64 ? 32 : 64;  // keys a tile
  static constexpr int WARPS = BM / 16;
  static constexpr int NT = WARPS * 32;
  // Q; K, V staging; K hi, K lo, V hi, V lo
  static constexpr size_t SMEM = sizeof(float) * P * (BM + 6 * BN);
};

// Grid (H, ceil(S / BM), B); blockIdx.y counts query tiles from the last
// (the heaviest under causality) down.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
fwd_kernel(const Params p) {
  using C = Cfg<D>;
  constexpr int P = C::P, BM = C::BM, BN = C::BN, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kraw = qs + BM * P;
  float* vraw = kraw + BN * P;
  float* khi = vraw + BN * P;
  float* klo = khi + BN * P;
  float* vhi = klo + BN * P;
  float* vlo = vhi + BN * P;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvh = h / (p.H / p.Hkv);
  // the key tiles some row of this CTA sees (rows at positions
  // q_offset + row)
  const int q_last = min(q0 + BM, p.S) - 1;
  const int kend = p.causal ? min(p.T, p.q_offset + q_last + 1) : p.T;
  const int kbeg =
      p.window > 0 ? max(0, p.q_offset + q0 - p.window + 1) : 0;
  const int t_begin = kbeg / BN;
  const int ntiles = max(0, (kend + BN - 1) / BN - t_begin);

  const float* qg = p.q + b * p.sq[0] + h * p.sq[1];
  const float* kg = p.k + b * p.sk[0] + kvh * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + kvh * p.sv[1];
  load_rows<D, BM, NT>(qs, qg, p.sq[2], q0, p.S - q0, tid);
  if (ntiles > 0) {
    load_rows<D, BN, NT>(kraw, kg, p.sk[2], t_begin * BN,
                         p.T - t_begin * BN, tid);
    load_rows<D, BN, NT>(vraw, vg, p.sv[2], t_begin * BN,
                         p.T - t_begin * BN, tid);
  }
  cp_async_commit();

  // this warp's rows: w_first .. w_last; the thread's rows row0, row0 + 8;
  // their positions from pw_first
  const int w_first = q0 + warp * 16;
  const int w_last = min(w_first + 15, p.S - 1);
  const int row0 = w_first + g;
  const int pw_first = p.q_offset + w_first, pw_last = p.q_offset + w_last;
  const float* qw = qs + warp * 16 * P;
  // scores to exp2 units: scale_log2 uncapped; capped, the cap's output
  // is already there
  const float mul = p.cap.on ? 1.f : p.scale_log2;

  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int n0 = (t_begin + it) * BN;
    cp_async_wait_all();
    __syncthreads();      // tile it staged; the split tile it - 1 consumed
    split_rows<D, BN, NT>(kraw, khi, klo, tid);
    split_rows<D, BN, NT>(vraw, vhi, vlo, tid);
    __syncthreads();      // split tile ready; staging free
    if (it + 1 < ntiles) {
      load_rows<D, BN, NT>(kraw, kg, p.sk[2], n0 + BN, p.T - n0 - BN, tid);
      load_rows<D, BN, NT>(vraw, vg, p.sv[2], n0 + BN, p.T - n0 - BN, tid);
    }
    cp_async_commit();

    // does some row of this warp see some key of the tile?
    if (w_first >= p.S || (p.causal && n0 > pw_last) ||
        (p.window > 0 && pw_first - (n0 + BN - 1) >= p.window))
      continue;

    float s[BN / 8][4];
    zero(s);
    gemm_abt<D, BN, true>(s, qw, khi, klo, lane);

    // the cap first: a masked key must stay at -inf
    if (p.cap.on) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = p.cap(s[n][e]);
    }
    // mask the tiles that cross the diagonal, the window or the end of T
    const bool edge = n0 + BN > p.T ||
                      (p.causal && n0 + BN - 1 > pw_first) ||
                      (p.window > 0 && pw_last - n0 >= p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + 8 * n + 2 * t + (e & 1);
          const int pos = p.q_offset + row0 + 8 * (e >> 1);
          const bool ok = key < p.T && (!p.causal || key <= pos) &&
                          (p.window <= 0 || pos - key < p.window);
          if (!ok) s[n][e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments; m is kept in exp2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * mul);
      // a row that has seen no key yet keeps m = -inf: subtract 0 so that
      // its masked entries give exp2(-inf) = 0, not NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = exp2f(fmaf(s[n][2 * r + e], mul, -m_use));
          s[n][2 * r + e] = pe;
          sum += pe;
        }
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    gemm_pb_add<BN, D, P>(o, s, vhi, vlo, lane);
  }
  cp_async_wait_all();

  float* og = p.o + b * p.so[0] + h * p.so[1];
  float* lg = p.lse + ((long long)b * p.H + h) * p.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int pos = row0 + 8 * r;
    if (pos >= p.S) continue;
    const float inv = 1.f / fmaxf(lr, 1e-20f);
    float* orow = og + pos * p.so[2];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0)
      lg[pos] = lr > 0.f ? (m[r] + log2f(lr)) * LN2 : -INFINITY;
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = allow_smem(fwd_kernel<D>, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.S + C::BM - 1) / C::BM, B);
  fwd_kernel<D><<<grid, C::NT, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: float32, 16 element strides ([B, H, S, D] of q,
// [B, Hkv, T, D] of k and v, [B, H, S, D] of out; every last-dim stride
// 1, every row 16-byte aligned); lse: contiguous [B, H, S].  window <= 0:
// none; q_offset >= 0: the position of query row 0; softcap <= 0: none.
// The caller checks shapes (H % Hkv == 0, S, T >= 1).  Returns the CUDA
// error of the launch (0 on success), or ERR_ARGS for a head dim other
// than 32, 64, 128 or 256 or a negative q_offset.
extern "C" int flash_attention_f32_fwd(const float* q, const float* k,
                                       const float* v, float* out,
                                       float* lse, int B, int H, int Hkv,
                                       int S, int T, int D, int causal,
                                       int window, int q_offset,
                                       float scale, float softcap,
                                       const long long* strides,
                                       void* stream) {
  if (q_offset < 0) return ERR_ARGS;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale * LOG2E;
  p.cap = SoftCap::make(softcap, scale, LOG2E);
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.so[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return (int)launch<32>(p, B, s);
    case 64: return (int)launch<64>(p, B, s);
    case 128: return (int)launch<128>(p, B, s);
    case 256: return (int)launch<256>(p, B, s);
    default: return ERR_ARGS;
  }
}
