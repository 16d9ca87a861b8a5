// The backward of the "f32tc" prefill attention (flash_attention_f32.cu):
// float32 dq, dk and dv from q, k, v, out, lse and dout, on the tensor
// cores at float32 accuracy (3xTF32, attention_tf32.cuh), deterministic,
// for Hopper (sm_90a).
//
// The Pallas kernel src/repro/kernels/flash_attention.py:78 has no
// backward (the reference trains through plain jnp attention); this is
// FlashAttention-2's backward for the same function: the masks, GQA and
// strides of the forward, head dim 32, 64, 128 or 256, query rows at
// positions 0.. (no query offset: no path trains at one).  With the
// scores Sc = scale Q K^T, or c tanh(scale Q K^T / c) under a softcap c
// (softcap.cuh), P = exp(Sc - lse) (0 where masked), dP = dO V^T,
// Delta = rowsum(dO * O) and dS = P * (dP - Delta), times 1 - (Sc / c)^2
// (the derivative of the cap) under a softcap:
//   dV = P^T dO, dK = scale dS^T Q (both summed over the H / Hkv query
//   heads of a kv head), dQ = scale dS K.
// Three launches, none with a float atomic, so two calls on the same
// inputs are bit-equal:
//   1. delta_kernel: Delta [B, H, S], one warp a row;
//   2. dkdv_kernel: one CTA a (batch, kv head, tile of 16 x WARPS keys,
//      column half at D = 256); each warp owns 16 keys and loops over the
//      group's query heads and the query tiles that see its keys,
//      recomputing S^T = K Q^T and dP^T = V dO^T and accumulating dV and
//      dK in registers; it writes dK and dV once;
//   3. dq_kernel: one CTA a (batch, head, tile of 16 x WARPS query rows,
//      column half at D = 256); each warp recomputes S, P, dP and dS for
//      its 16 rows over the key tiles they see and accumulates dQ.
// (One launch with both kinds of block was tried: at the dK / dV blocks'
// 255 registers the dQ blocks ran slower, 36.0 against 35.0 ms at Qwen2.5-
// 7B's training shape.)
// A row with lse = -inf (no visible key) has no visible pair, so it adds
// 0 to every gradient.
//
// What bounds it: operations, 5 products of 2 D flops per visible pair in
// FlashAttention-2's count (this design recomputes S and dP in both
// passes: 7 products), three TF32 products each.  The layouts, staging
// and masking follow the forward: the operand whose rows a warp owns is
// kept raw (A, split per k-step), the operand it sweeps is split once a
// tile into hi / lo buffers shared by the CTA's warps, and cp.async
// stages the next tile while the warps compute on the current one.  As
// in the forward, each tile's product is summed in fresh registers and
// added to the dK / dV / dQ sums by float32 adds: accumulated in the
// tensor cores (which truncate) across the 4,096 rows and 7 heads of a
// Qwen2.5-7B training step, the sums drifted to ~1.2e-4 of their max
// from the plain version.  At
// D = 256 the dK / dV / dQ accumulators of a full row do not fit a
// thread's registers, so each CTA owns one half of the columns and
// recomputes the full-width S and dP.

#include "attention_tf32.cuh"
#include "softcap.cuh"

namespace {

using namespace tf32;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* lse;
  const float* dout;
  float* delta;
  float* dq;
  float* dk;
  float* dv;
  int H, Hkv, S, T, causal, window;
  float scale, scale_log2;
  SoftCap cap;                     // in exp2 units
  // element strides of [B, H|Hkv, S|T, D]: q, k, v, out, dout, dq
  long long sq[4], sk[4], sv[4], so[4], sdo[4], sdq[4];
};

// ---- 1. Delta = rowsum(dout * out) -----------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
delta_kernel(const Params p, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int i = row % p.S, bh = row / p.S, h = bh % p.H, b = bh / p.H;
  const float* o = p.o + b * p.so[0] + h * p.so[1] + i * p.so[2];
  const float* d = p.dout + b * p.sdo[0] + h * p.sdo[1] + i * p.sdo[2];
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 4; c < D; c += 128) {
    const float4 x = *reinterpret_cast<const float4*>(o + c);
    const float4 y = *reinterpret_cast<const float4*>(d + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) p.delta[row] = acc;
}

// ---- 2. dK, dV -------------------------------------------------------------

template <int D>
struct KvCfg {
  static constexpr int P = D + 4;
  static constexpr int DO = D > 128 ? 128 : D;       // output columns a CTA
  static constexpr int WARPS = D > 128 ? 2 : 8;
  static constexpr int BN = 16 * WARPS;              // keys a CTA
  static constexpr int BM = D > 128 ? 16 : D > 64 ? 24 : 64;  // query tile
  static constexpr int NT = WARPS * 32;
  // K, V raw; Q, dO staging; Q hi, Q lo, dO hi, dO lo; lse, Delta
  // staged and in use
  static constexpr size_t SMEM =
      sizeof(float) * (P * (2 * BN + 6 * BM) + 4 * BM);
};

// Grid (Hkv * D / DO, ceil(T / BN), B): blockIdx.y counts key tiles from
// the first (the heaviest under causality) up.  CAP: p.cap is on (a
// template argument, so the uncapped kernel is the code it was before the
// cap, at its register count).
template <int D, bool CAP>
__global__ void __launch_bounds__(KvCfg<D>::NT, 1)
dkdv_kernel(const Params p) {
  using C = KvCfg<D>;
  constexpr int P = C::P, DO = C::DO, BN = C::BN, BM = C::BM, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BN * P;
  float* qraw = vs + BN * P;
  float* draw = qraw + BM * P;
  float* qhi = draw + BM * P;
  float* qlo = qhi + BM * P;
  float* dhi = qlo + BM * P;
  float* dlo = dhi + BM * P;
  float* lse2 = dlo + BM * P;      // lse * log2(e) of the tile's rows
  float* dlt = lse2 + BM;          // Delta of the tile's rows
  float* lse_st = dlt + BM;        // the next tile's lse and Delta, staged
  float* dlt_st = lse_st + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int halves = D / DO;
  const int kvh = blockIdx.x / halves, c0 = (blockIdx.x % halves) * DO;
  const int b = blockIdx.z, n0 = blockIdx.y * BN;
  const int group = p.H / p.Hkv;
  // the query rows some key of this CTA is seen by
  const int n_last = min(n0 + BN, p.T) - 1;
  const int qbeg = p.causal ? n0 : 0;
  const int qend = p.window > 0 ? min(p.S, n_last + p.window) : p.S;
  const int m_begin = qbeg / BM;
  const int nq = qbeg < qend ? (qend + BM - 1) / BM - m_begin : 0;
  const int total = nq * group;

  const float* kg = p.k + b * p.sk[0] + kvh * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + kvh * p.sv[1];
  load_rows<D, BN, NT>(ks, kg, p.sk[2], n0, p.T - n0, tid);
  load_rows<D, BN, NT>(vs, vg, p.sv[2], n0, p.T - n0, tid);
  auto stage = [&](int it) {
    const int h = kvh * group + it / nq, m0 = (m_begin + it % nq) * BM;
    load_rows<D, BM, NT>(qraw, p.q + b * p.sq[0] + h * p.sq[1], p.sq[2], m0,
                         p.S - m0, tid);
    load_rows<D, BM, NT>(draw, p.dout + b * p.sdo[0] + h * p.sdo[1],
                         p.sdo[2], m0, p.S - m0, tid);
    const long long r0 = ((long long)b * p.H + h) * p.S;
    for (int i = tid; i < BM; i += NT) {
      const bool ok = m0 + i < p.S;
      cp_async4(lse_st + i, p.lse + r0 + (ok ? m0 + i : 0), ok);
      cp_async4(dlt_st + i, p.delta + r0 + (ok ? m0 + i : 0), ok);
    }
  };
  if (total > 0) stage(0);
  cp_async_commit();

  // this warp's keys: kw .. kw + 15; the thread's keys key0, key0 + 8
  const int kw = n0 + warp * 16;
  const int key0 = kw + g;
  const float* kw_s = ks + warp * 16 * P;
  const float* vw_s = vs + warp * 16 * P;

  float dk[DO / 8][4], dv[DO / 8][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < total; ++it) {
    const int m0 = (m_begin + it % nq) * BM;
    cp_async_wait_all();
    __syncthreads();      // tile it staged; the split tile it - 1 consumed
    split_rows<D, BM, NT>(qraw, qhi, qlo, tid);
    split_rows<D, BM, NT>(draw, dhi, dlo, tid);
    if (tid < BM) {
      // rows past S: lse = +inf gives P = 0
      lse2[tid] = m0 + tid < p.S ? lse_st[tid] * LOG2E : INFINITY;
      dlt[tid] = dlt_st[tid];
    }
    __syncthreads();      // split tile ready; staging free
    if (it + 1 < total) stage(it + 1);
    cp_async_commit();

    // does some key of this warp see some row of the tile?
    const int m_last = min(m0 + BM, p.S) - 1;
    if (kw >= p.T || (p.causal && m_last < kw) ||
        (p.window > 0 && m0 - (kw + 15) >= p.window))
      continue;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x BM rows]
    float st[BM / 8][4], dpt[BM / 8][4];
    zero(st);
    zero(dpt);
    gemm_abt<D, BM, true>(st, kw_s, qhi, qlo, lane);
    gemm_abt<D, BM, true>(dpt, vw_s, dhi, dlo, lane);

    const bool edge = kw + 16 > p.T || m_last < m0 + BM - 1 ||
                      (p.causal && m0 < kw + 15) ||
                      (p.window > 0 && m_last - kw >= p.window);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int pos = m0 + col, key = key0 + 8 * (e >> 1);
        const bool ok = !edge ||
                        (key < p.T && pos < p.S &&
                         (!p.causal || key <= pos) &&
                         (p.window <= 0 || pos - key < p.window));
        if constexpr (CAP) {
          float th = 0.f;
          const float pe =
              ok ? exp2f(p.cap(st[n][e], th) - lse2[col]) : 0.f;
          st[n][e] = pe;
          dpt[n][e] = pe * (dpt[n][e] - dlt[col]) * (1.f - th * th);
        } else {
          const float pe =
              ok ? exp2f(fmaf(st[n][e], p.scale_log2, -lse2[col])) : 0.f;
          st[n][e] = pe;
          dpt[n][e] = pe * (dpt[n][e] - dlt[col]);
        }
      }
    }
    // dV += P^T dO, dK += dS^T Q (the query rows are the k index; each
    // tile's product is added to the sums by float32 adds)
    gemm_pb_add<BM, DO, P, false>(dv, st, dhi + c0, dlo + c0, lane);
    gemm_pb_add<BM, DO, P, false>(dk, dpt, qhi + c0, qlo + c0, lane);
  }
  cp_async_wait_all();

  // dK, dV: contiguous [B, Hkv, T, D]
  const long long base = ((long long)b * p.Hkv + kvh) * p.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.T) continue;
    float* dkr = p.dk + (base + key) * D + c0;
    float* dvr = p.dv + (base + key) * D + c0;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      *reinterpret_cast<float2*>(dkr + 8 * n + 2 * t) = make_float2(
          dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<float2*>(dvr + 8 * n + 2 * t) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---- 3. dQ -----------------------------------------------------------------

template <int D>
struct QCfg {
  static constexpr int P = D + 4;
  static constexpr int DO = D > 128 ? 128 : D;
  static constexpr int WARPS = D > 128 ? 2 : 8;
  static constexpr int BM = 16 * WARPS;              // query rows a CTA
  static constexpr int BN = D > 128 ? 16 : D > 64 ? 24 : 64;  // key tile
  static constexpr int NT = WARPS * 32;
  // Q, dO raw; K, V staging; K hi, K lo, V hi, V lo
  static constexpr size_t SMEM = sizeof(float) * P * (2 * BM + 6 * BN);
};

// Grid (H * D / DO, ceil(S / BM), B); blockIdx.y counts query tiles from
// the last (the heaviest under causality) down.  CAP as dkdv_kernel's.
template <int D, bool CAP>
__global__ void __launch_bounds__(QCfg<D>::NT, 1)
dq_kernel(const Params p) {
  using C = QCfg<D>;
  constexpr int P = C::P, DO = C::DO, BN = C::BN, BM = C::BM, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* dos = reinterpret_cast<float*>(smem4);
  float* kraw = dos + BM * P;
  float* vraw = kraw + BN * P;
  float* khi = vraw + BN * P;
  float* klo = khi + BN * P;
  float* vhi = klo + BN * P;
  float* vlo = vhi + BN * P;
  float* qs = vlo + BN * P;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int halves = D / DO;
  const int h = blockIdx.x / halves, c0 = (blockIdx.x % halves) * DO;
  const int b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvh = h / (p.H / p.Hkv);
  const int q_last = min(q0 + BM, p.S) - 1;
  const int kend = p.causal ? min(p.T, q_last + 1) : p.T;
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kbeg / BN;
  const int ntiles = max(0, (kend + BN - 1) / BN - t_begin);

  const float* kg = p.k + b * p.sk[0] + kvh * p.sk[1];
  const float* vg = p.v + b * p.sv[0] + kvh * p.sv[1];
  load_rows<D, BM, NT>(qs, p.q + b * p.sq[0] + h * p.sq[1], p.sq[2], q0,
                       p.S - q0, tid);
  load_rows<D, BM, NT>(dos, p.dout + b * p.sdo[0] + h * p.sdo[1], p.sdo[2],
                       q0, p.S - q0, tid);
  if (ntiles > 0) {
    load_rows<D, BN, NT>(kraw, kg, p.sk[2], t_begin * BN,
                         p.T - t_begin * BN, tid);
    load_rows<D, BN, NT>(vraw, vg, p.sv[2], t_begin * BN,
                         p.T - t_begin * BN, tid);
  }
  cp_async_commit();

  const int w_first = q0 + warp * 16;
  const int w_last = min(w_first + 15, p.S - 1);
  const int row0 = w_first + g;
  const float* qw = qs + warp * 16 * P;
  const float* dw = dos + warp * 16 * P;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    const long long idx = ((long long)b * p.H + h) * p.S + i;
    lse2[r] = i < p.S ? p.lse[idx] * LOG2E : INFINITY;
    dlt[r] = i < p.S ? p.delta[idx] : 0.f;
  }

  float dq[DO / 8][4];
  zero(dq);

  for (int it = 0; it < ntiles; ++it) {
    const int n0 = (t_begin + it) * BN;
    cp_async_wait_all();
    __syncthreads();
    split_rows<D, BN, NT>(kraw, khi, klo, tid);
    split_rows<D, BN, NT>(vraw, vhi, vlo, tid);
    __syncthreads();
    if (it + 1 < ntiles) {
      load_rows<D, BN, NT>(kraw, kg, p.sk[2], n0 + BN, p.T - n0 - BN, tid);
      load_rows<D, BN, NT>(vraw, vg, p.sv[2], n0 + BN, p.T - n0 - BN, tid);
    }
    cp_async_commit();

    if (w_first >= p.S || (p.causal && n0 > w_last) ||
        (p.window > 0 && w_first - (n0 + BN - 1) >= p.window))
      continue;

    // S = Q K^T and dP = dO V^T, [16 rows x BN keys]
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    gemm_abt<D, BN, true>(s, qw, khi, klo, lane);
    gemm_abt<D, BN, true>(dp, dw, vhi, vlo, lane);

    const bool edge = n0 + BN > p.T || (p.causal && n0 + BN - 1 > w_first) ||
                      (p.window > 0 && w_last - n0 >= p.window);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * n + 2 * t + (e & 1);
        const int r = e >> 1, pos = row0 + 8 * r;
        const bool ok = !edge || (key < p.T && (!p.causal || key <= pos) &&
                                  (p.window <= 0 || pos - key < p.window));
        if constexpr (CAP) {
          float th = 0.f;
          const float pe = ok ? exp2f(p.cap(s[n][e], th) - lse2[r]) : 0.f;
          s[n][e] = pe * (dp[n][e] - dlt[r]) * (1.f - th * th);
        } else {
          const float pe =
              ok ? exp2f(fmaf(s[n][e], p.scale_log2, -lse2[r])) : 0.f;
          s[n][e] = pe * (dp[n][e] - dlt[r]);
        }
      }
    }
    // dQ += dS K (the keys are the k index; each tile's product is
    // added to the sum by float32 adds)
    gemm_pb_add<BN, DO, P, false>(dq, s, khi + c0, klo + c0, lane);
  }
  cp_async_wait_all();

  float* dqg = p.dq + b * p.sdq[0] + h * p.sdq[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = row0 + 8 * r;
    if (pos >= p.S) continue;
    float* row = dqg + pos * p.sdq[2] + c0;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) = make_float2(
          dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

template <int D, bool CAP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using K = KvCfg<D>;
  using Q = QCfg<D>;
  cudaError_t err = allow_smem(dkdv_kernel<D, CAP>, K::SMEM);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D, CAP>, Q::SMEM);
  if (err != cudaSuccess) return err;
  const int rows = B * p.H * p.S;
  delta_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(p.Hkv * (D / K::DO), (p.T + K::BN - 1) / K::BN, B);
  dkdv_kernel<D, CAP><<<kv_grid, K::NT, K::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid(p.H * (D / Q::DO), (p.S + Q::BM - 1) / Q::BM, B);
  dq_kernel<D, CAP><<<q_grid, Q::NT, Q::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout: float32 by 20 element strides ([B, H, S, D] of q,
// [B, Hkv, T, D] of k and v, [B, H, S, D] of out and of dout), then dq's
// 4 ([B, H, S, D]); every last-dim stride 1, every row 16-byte aligned.
// lse and delta (scratch, written here): contiguous [B, H, S]; dk, dv:
// contiguous [B, Hkv, T, D].  window <= 0: none; softcap <= 0: none.  The
// caller checks shapes (H % Hkv == 0, S, T >= 1).  Returns the CUDA error
// of the launches (0 on success), or ERR_ARGS for a head dim other than
// 32, 64, 128 or 256.
extern "C" int flash_attention_f32_bwd(
    const float* q, const float* k, const float* v, const float* out,
    const float* lse, const float* dout, float* delta, float* dq, float* dk,
    float* dv, int B, int H, int Hkv, int S, int T, int D, int causal,
    int window, float scale, float softcap, const long long* strides,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = lse;
  p.dout = dout;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.cap = SoftCap::make(softcap, scale, LOG2E);
  for (int i = 0; i < 4; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.so[i] = strides[12 + i];
    p.sdo[i] = strides[16 + i];
    p.sdq[i] = strides[20 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = p.cap.on;
  switch (D) {
    case 32: return (int)(cap ? launch<32, true>(p, B, s)
                              : launch<32, false>(p, B, s));
    case 64: return (int)(cap ? launch<64, true>(p, B, s)
                              : launch<64, false>(p, B, s));
    case 128: return (int)(cap ? launch<128, true>(p, B, s)
                               : launch<128, false>(p, B, s));
    case 256: return (int)(cap ? launch<256, true>(p, B, s)
                               : launch<256, false>(p, B, s));
    default: return ERR_ARGS;
  }
}
