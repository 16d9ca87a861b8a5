// One-token GQA attention against a KV cache (decode), for Hopper
// (sm_90a): split-KV over the card's SMs, with a combine in split order.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, kernel body _decode_kernel): the G query heads of one
// kv head attend over cache rows [0, length[b]) with an online softmax in
// float32; rows at or past length[b] are masked, and a row with no valid
// key ends at exactly 0 (acc / max(l, 1e-20)).  With a softcap c > 0 each
// scaled score becomes c tanh(score / c) before the mask (softcap.cuh;
// on the mma route from the raw product, on the fma route from the
// pre-scaled query's, both the true scaled score).  K and V are taken by
// strides, so the model's [B, T, Hkv, D] cache (and a window's rows of
// it) is read through a permuted view with no copy.
//
// What bounds it on this card: the bytes of K and V up to length (a
// decode step does 4 operations per element and query head, far below
// the ~295 operations a byte at which the tensor cores become the limit).
// To reach the memory rate the cache must be read by many SMs at once,
// with many 16-byte loads in flight on each.  So:
//   * the cache axis is cut into `splits` ranges of `chunk` keys (a
//     multiple of the 64-key tile; the wrapper's plan() picks them from
//     the shapes alone, about two blocks per SM), grid (splits,
//     Hkv * query-head groups, B).  A split that starts at or past
//     length[b] writes m = -inf, l = 0 and returns: the Pallas kernel's
//     early stop, per block;
//   * bf16 at D in {64, 128, 256} (decode_mma_kernel): 4 warps stream
//     64-key tiles of K and V through a 3-stage cp.async ring in shared
//     memory (16-byte loads, XOR-swizzled rows), and run Q K^T and P V
//     on the tensor cores with mma.sync m16n8k16: the query heads of one
//     kv head (7 for Qwen2.5-7B, padded to 16; 16 for RecurrentGemma-9B)
//     are the 16 rows, K and V the B operands (ldmatrix, .trans for V),
//     P rounded to bf16 from the score accumulators.  Each warp folds 16
//     keys of every tile into its own online softmax; the 4 warps merge
//     in warp order;
//   * float32 (which must not round through TF32), and bf16 at other
//     head dims (decode_fma_kernel): the same split structure over FP32
//     FMAs (attention_common.cuh: 32-key chunks, 8 query rows a warp);
//   * with one split the block writes the output itself; with more, each
//     block writes its partial (m, l, acc) to float32 scratch and a second
//     launch (combine_kernel) sums the splits in split-index order, so two
//     calls on the same inputs are bit-equal.  No atomics;
//   * on request (lse non-null) the pass that writes the output also
//     writes each (row, head)'s log-sum-exp, m + log l of the capped,
//     scaled scores in natural units (-inf where no key is valid): the
//     partial result of a block of the cache's length, which the sharded
//     serving body merges across the "model" ranks' blocks.  It costs one
//     float a (row, head) and leaves the output's arithmetic as it was.

#include "attention_common.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;        // keys a tile; splits are multiples of it
constexpr int MROWS = 16;       // query heads a block on the mma route
constexpr int MWARPS = 4;       // each folds 16 keys of every tile
constexpr int MTHREADS = MWARPS * 32;
constexpr int STAGES = 3;       // tiles of K and V in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;            // [B, H, D]: written by the blocks (one split) or
                      // by the combine (several)
  float* part_acc;    // [B, H, splits, D]  (several splits only)
  float* part_ml;     // [B, H, splits, 2]: m in log2 units, l
  float* lse;         // [B, H] log-sum-exp (natural units), or null
  int H, Hkv, T, D, splits, chunk;
  float scale;
  float softcap;      // <= 0: none (each route makes its SoftCap)
  long long sq[3], sk[4], sv[4], so[3];   // [B, H, D]; [B, Hkv, T, D]
};

// m2 (log2 units) and l of a row as its natural log-sum-exp; -inf where
// no key was valid (l = 0)
__device__ __forceinline__ float log_sum_exp(float m2, float l) {
  return l > 0.f ? m2 * LN2 + logf(l) : -INFINITY;
}

// The block's result for query head h, dim d: the output itself (and, on
// request, the row's log-sum-exp) when there is one split, else the
// split's partial state (m2 in log2 units).
template <typename T>
__device__ __forceinline__ void put(const Params& p, int b, int h, int split,
                                    int d, float acc, float m2, float l) {
  if (p.splits == 1) {
    static_cast<T*>(p.o)[b * p.so[0] + h * p.so[1] + d] =
        from_f32<T>(acc / fmaxf(l, 1e-20f));
    if (p.lse && d == 0) p.lse[(long long)b * p.H + h] = log_sum_exp(m2, l);
    return;
  }
  const long long row = ((long long)b * p.H + h) * p.splits + split;
  p.part_acc[row * p.D + d] = acc;
  if (d == 0) {
    p.part_ml[2 * row] = m2;
    p.part_ml[2 * row + 1] = l;
  }
}

// A split with no valid key: m = -inf, l = 0 (an output of 0 when it is
// the only split).
template <typename T>
__device__ void empty_split(const Params& p, int b, int h0, int rows,
                            int split) {
  for (int i = threadIdx.x; i < rows * p.D; i += blockDim.x)
    put<T>(p, b, h0 + i / p.D, split, i % p.D, 0.f, -INFINITY, 0.f);
}

// ------------------------------------------------------------ mma route --

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// 16 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one register of bf16 (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile:
// chunks XOR-swizzled by r % 8, so the 8 rows an ldmatrix reads at one
// chunk hit 8 different bank groups (D >= 64: at least 8 chunks a row)
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)STAGES * 2 * TILE * D * sizeof(bf16) +
         (size_t)MROWS * D * sizeof(bf16);
}

// Issue the cp.asyncs of keys [key0, key0 + nvalid) of K and V into one
// ring stage; rows past nvalid are zero-filled and read nothing.
template <int D>
__device__ __forceinline__ void load_tile(bf16* ks, bf16* vs, const bf16* kb,
                                          long long skr, const bf16* vb,
                                          long long svr, int key0,
                                          int nvalid) {
  constexpr int CPR = D / 8;   // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < TILE * CPR; i += MTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nvalid;
    const long long key = key0 + (ok ? r : 0);
    cp_async16(smem_u32(ks + swz<D>(r, c)), kb + key * skr + c * 8,
               ok ? 16 : 0);
    cp_async16(smem_u32(vs + swz<D>(r, c)), vb + key * svr + c * 8,
               ok ? 16 : 0);
  }
}

// CAP: p.softcap > 0 (a template argument, so the uncapped kernel is the
// code it was before the cap)
template <int D, bool CAP>
__global__ void __launch_bounds__(MTHREADS)
    decode_mma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  bf16* qs = ring + STAGES * 2 * TILE * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row and column
  const int split = blockIdx.x;
  const int G = p.H / p.Hkv;
  const int groups = (G + MROWS - 1) / MROWS;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * G + (blockIdx.y % groups) * MROWS;   // first q head
  const int rows = min(MROWS, (kvh + 1) * G - h0);
  const int b = blockIdx.z;
  const int len = max(0, min(p.length[b], p.T));
  const int kbeg = split * p.chunk;
  const int kend = min(min(kbeg + p.chunk, p.T), len);
  if (kbeg >= kend) {
    empty_split<bf16>(p, b, h0, rows, split);
    return;
  }

  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.sk[0] +
                   kvh * p.sk[1];
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.sv[0] +
                   kvh * p.sv[1];
  const int ntiles = (kend - kbeg + TILE - 1) / TILE;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) {
      bf16* ks = ring + s * 2 * TILE * D;
      load_tile<D>(ks, ks + TILE * D, kb, p.sk[2], vb, p.sv[2],
                   kbeg + s * TILE, min(TILE, kend - kbeg - s * TILE));
    }
    cp_commit();
  }
  // the group's query rows (zero past rows), swizzled like the tiles:
  // every load issued before the first store, so their latencies overlap
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq[0];
  constexpr int QPT = MROWS * D / MTHREADS;   // elements a thread
  bf16 qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * MTHREADS, r = i / D, d = i % D;
    qv[u] = r < rows ? q[(h0 + r) * p.sq[1] + d] : __float2bfloat16(0.f);
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * MTHREADS, r = i / D, d = i % D;
    qs[swz<D>(r, d >> 3) + (d & 7)] = qv[u];
  }

  const float sl2 = p.scale * LOG2E;   // scores in log2 units
  const SoftCap cap = SoftCap::make(p.softcap, p.scale, LOG2E);
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int nxt = i + STAGES - 1;
    if (nxt < ntiles) {
      bf16* ks = ring + (nxt % STAGES) * 2 * TILE * D;
      load_tile<D>(ks, ks + TILE * D, kb, p.sk[2], vb, p.sv[2],
                   kbeg + nxt * TILE, min(TILE, kend - kbeg - nxt * TILE));
    }
    cp_commit();
    cp_wait<STAGES - 1>();   // tile i has landed
    __syncthreads();
    const bf16* ks = ring + (i % STAGES) * 2 * TILE * D;
    const bf16* vs = ks + TILE * D;
    const int j = lane >> 3;   // the 8x8 matrix this lane addresses

    // S = Q K^T over this warp's 16 keys: two 16x8 tiles, each summed
    // over D in two independent chains (even and odd 16-dim steps) that
    // halve the dependent mma latency
    float s[2][4], s2[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = s2[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], bk[4];
      ldsm_x4(smem_u32(qs + swz<D>((j & 1) * 8 + (lane & 7),
                                   kk * 2 + (j >> 1))), a);
      ldsm_x4(smem_u32(ks + swz<D>(warp * 16 + (j >> 1) * 8 + (lane & 7),
                                   kk * 2 + (j & 1))), bk);
      if (kk & 1) {
        mma_bf16(s2[0], a, bk[0], bk[1]);
        mma_bf16(s2[1], a, bk[2], bk[3]);
      } else {
        mma_bf16(s[0], a, bk[0], bk[1]);
        mma_bf16(s[1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] += s2[n][c];

    // online softmax in log2 units (capped first where there is a cap);
    // masked keys at probability 0
    const int kw = kbeg + i * TILE + warp * 16;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kw + n * 8 + 2 * t + (c & 1);
        float sc;
        if constexpr (CAP) sc = cap(s[n][c]);
        else sc = s[n][c] * sl2;
        s[n][c] = key < kend ? sc : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.f : mn;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
    // P as the A operand: the two score tiles' accumulators are its
    // fragment (rows g, g + 8; keys 2t, 2t + 1 of each 8)
    unsigned pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float pr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pr[c] = exp2f(s[n][c] - mu[c >> 1]);
        l[c >> 1] += pr[c];
      }
      pa[2 * n] = pack_bf16(pr[0], pr[1]);
      pa[2 * n + 1] = pack_bf16(pr[2], pr[3]);
    }
    // (the running max rarely moves after the first tiles: skip the
    // rescale when it moved for no row of the warp)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }
    // O += P V, 16 dims at a time (V transposed by ldmatrix)
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      unsigned bv[4];
      ldsm_x4_t(smem_u32(vs + swz<D>(warp * 16 + (j & 1) * 8 + (lane & 7),
                                     db * 2 + (j >> 1))), bv);
      mma_bf16(acc[2 * db], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * db + 1], pa, bv[2], bv[3]);
    }
    __syncthreads();   // stage i % STAGES is refilled next iteration
  }
  cp_wait<0>();
  __syncthreads();

  // merge the 4 warps' states, in warp order, through the idle ring: each
  // row's max and sum once, each warp's acc scaled to the row's max in its
  // fragment, then each output the sum of the 4 warps' in order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  constexpr int WP = D + 4;                     // row pitch: no conflicts
  float* wm = reinterpret_cast<float*>(ring);   // [MWARPS][MROWS]
  float* wl = wm + MWARPS * MROWS;              // [MWARPS][MROWS]
  float* rm = wl + MWARPS * MROWS;              // [MROWS] row max
  float* rl = rm + MROWS;                       // [MROWS] row sum
  float* wacc = rl + MROWS;                     // [MWARPS][MROWS][WP]
  if (t == 0) {
    wm[warp * MROWS + g] = m[0];
    wm[warp * MROWS + g + 8] = m[1];
    wl[warp * MROWS + g] = l[0];
    wl[warp * MROWS + g + 8] = l[1];
  }
  __syncthreads();
  if (tid < MROWS) {
    float mm = -INFINITY, ll = 0.f;
#pragma unroll
    for (int w = 0; w < MWARPS; ++w) mm = fmaxf(mm, wm[w * MROWS + tid]);
#pragma unroll
    for (int w = 0; w < MWARPS; ++w) {
      const float mw = wm[w * MROWS + tid];
      if (mw != -INFINITY) ll += wl[w * MROWS + tid] * exp2f(mw - mm);
    }
    rm[tid] = mm;
    rl[tid] = ll;
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    f[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - rm[g + 8 * r]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          wacc + (warp * MROWS + g + 8 * r) * WP + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * f[r], acc[n][2 * r + 1] * f[r]);
  __syncthreads();
#pragma unroll 4
  for (int u = 0; u < MROWS * D / MTHREADS; ++u) {
    const int i = tid + u * MTHREADS, r = i / D, d = i % D;
    if (r < rows) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < MWARPS; ++w) a += wacc[(w * MROWS + r) * WP + d];
      put<bf16>(p, b, h0 + r, split, d, a, rm[r], rl[r]);
    }
  }
}

// ------------------------------------------------------------ fma route --

struct SplitMask {
  int rows, end;
  __device__ bool operator()(int r, int key) const {
    return r < rows && key < end;
  }
};

// shared memory of one warp: its staged chunk, query rows and probabilities
template <typename T>
__host__ __device__ inline size_t warp_bytes(int D) {
  return chunk_bytes<T>(D) + rows_bytes(D);
}

template <typename T, int DPL>
__global__ void decode_fma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int split = blockIdx.x;
  const int G = p.H / p.Hkv;
  const int groups = (G + ROWS - 1) / ROWS;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * G + (blockIdx.y % groups) * ROWS;   // first q head
  const int rows = min(ROWS, (kvh + 1) * G - h0);
  const int b = blockIdx.z;
  const int D = p.D;
  const int len = max(0, min(p.length[b], p.T));
  const int kbeg = split * p.chunk;
  const int kend = min(min(kbeg + p.chunk, p.T), len);
  if (kbeg >= kend) {
    empty_split<T>(p, b, h0, rows, split);
    return;
  }
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

  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + kvh * p.sk[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + kvh * p.sv[1];
  const SplitMask ok{rows, kend};
  const SoftCap cap = SoftCap::make(p.softcap, 1.f, 1.f);   // q pre-scaled
  RowState<DPL> st;
  st.init();
  for (int key0 = kbeg + warp * CHUNK; key0 < kend;
       key0 += warps * CHUNK) {
    const int nk = min(CHUNK, kend - key0);
    stage_chunk<T>(kb, p.sk[2], vb, p.sv[2], key0, nk, D, ks, vs, lane, 32);
    __syncwarp();
    fold_chunk<T, DPL>(st, ks, vs, key0, nk, D, qs, ps, ok, cap, lane);
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
    put<T>(p, b, h0 + r, split, d, a, m * LOG2E, l);
  }
}

// -------------------------------------------------------------- combine --

// out[b, h] = sum over splits s, in order, of acc_s 2^(m_s - M) divided
// by the same sum of l_s; splits with m = -inf (no valid key) weigh 0 (their
// acc is 0), so a row with no valid key at all ends at 0.  One block a
// (b, h): the splits' weights go to shared memory first (one load a thread,
// all in flight at once), then each thread sums its dims over the splits in
// order, loading KSPLIT partials ahead of the adds.  It is launched as a
// programmatic dependent of the split kernel, so its launch overlaps that
// kernel's tail; griddepcontrol.wait holds it until the partials are
// complete and visible.
constexpr int KSPLIT = 16;

template <typename T>
__global__ void __launch_bounds__(128) combine_kernel(const Params p) {
  extern __shared__ float cw[];         // [splits] weights, [splits] l
  __shared__ float red[4];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float* cl = cw + p.splits;
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const float* ml = p.part_ml + (long long)bh * p.splits * 2;
  const float* acc = p.part_acc + (long long)bh * p.splits * p.D;
  float mm = -INFINITY;
  for (int s = tid; s < p.splits; s += blockDim.x) {
    cw[s] = ml[2 * s];
    cl[s] = ml[2 * s + 1];
    mm = fmaxf(mm, cw[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
  if ((tid & 31) == 0) red[tid >> 5] = mm;
  __syncthreads();
  mm = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  for (int s = tid; s < p.splits; s += blockDim.x)
    cw[s] = cw[s] == -INFINITY ? 0.f : exp2f(cw[s] - mm);
  __syncthreads();
  float ll = 0.f;
  for (int s = 0; s < p.splits; ++s) ll = fmaf(cl[s], cw[s], ll);
  if (p.lse && tid == 0) p.lse[bh] = log_sum_exp(mm, ll);
  for (int d = tid; d < p.D; d += blockDim.x) {
    float a = 0.f;
    for (int s0 = 0; s0 < p.splits; s0 += KSPLIT) {
      float v[KSPLIT];
#pragma unroll
      for (int u = 0; u < KSPLIT; ++u)
        v[u] = s0 + u < p.splits ? acc[(long long)(s0 + u) * p.D + d] : 0.f;
#pragma unroll
      for (int u = 0; u < KSPLIT; ++u)
        if (s0 + u < p.splits) a = fmaf(v[u], cw[s0 + u], a);
    }
    static_cast<T*>(p.o)[b * p.so[0] + h * p.so[1] + d] =
        from_f32<T>(a / fmaxf(ll, 1e-20f));
  }
}

// --------------------------------------------------------------- launch --

template <int D, bool CAP>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(decode_mma_kernel<D, CAP>, smem);
  if (err != cudaSuccess) return err;
  const int G = p.H / p.Hkv;
  const dim3 grid(p.splits, p.Hkv * ((G + MROWS - 1) / MROWS), B);
  decode_mma_kernel<D, CAP><<<grid, MTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t launch_fma(const Params& p, int B, cudaStream_t stream) {
  // 8 warps while their shared memory fits a block (227 KB), else fewer
  int warps = 8;
  while (warps > 1 && warps * warp_bytes<T>(p.D) > 227 * 1024) warps /= 2;
  const size_t smem = warps * warp_bytes<T>(p.D);
  cudaError_t err = allow_smem(decode_fma_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  const int G = p.H / p.Hkv;
  const dim3 grid(p.splits, p.Hkv * ((G + ROWS - 1) / ROWS), B);
  decode_fma_kernel<T, DPL><<<grid, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_dispatch(const Params& p, int B, cudaStream_t s) {
  const int dpl = (p.D + 31) / 32;
  if (dpl <= 1) return launch_fma<T, 1>(p, B, s);
  if (dpl <= 2) return launch_fma<T, 2>(p, B, s);
  if (dpl <= 4) return launch_fma<T, 4>(p, B, s);
  return launch_fma<T, 8>(p, B, s);
}

template <typename T>
cudaError_t launch_combine(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * p.splits;
  cudaError_t err = allow_smem(combine_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.H);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel<T>, p);
}

cudaError_t launch_blocks(int dtype, int tc, const Params& p, int B,
                          cudaStream_t s) {
  if (!tc) return dtype == 0 ? launch_fma_dispatch<float>(p, B, s)
                             : launch_fma_dispatch<bf16>(p, B, s);
  switch (p.D) {
    case 64: return p.softcap > 0.f ? launch_mma<64, true>(p, B, s)
                                    : launch_mma<64, false>(p, B, s);
    case 128: return p.softcap > 0.f ? launch_mma<128, true>(p, B, s)
                                     : launch_mma<128, false>(p, B, s);
    case 256: return p.softcap > 0.f ? launch_mma<256, true>(p, B, s)
                                     : launch_mma<256, false>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it); tc: 1 for
// the tensor-core route (bf16, D in {64, 128, 256}, K and V rows 16-byte
// aligned), 0 for the FP32-FMA route.  length: [B] int32 on the device.
// splits, chunk: the plan (splits * chunk >= T, chunk a multiple of 64);
// with splits > 1, part_acc [B, H, splits, D] and part_ml [B, H, splits, 2]
// float32 scratch (unused, may be null, with one split).  lse: null, or a
// contiguous [B, H] float32 output for each row's log-sum-exp.  strides: 14
// element strides, [B, H, D] of q, [B, Hkv, T, D] of k and of v, then
// [B, H, D] of out; every last-dim stride is 1.  softcap <= 0: none.  The
// caller checks shapes (D % 4 == 0, D <= 256, H % Hkv == 0).  Returns the
// CUDA error of the launches (0 on success).
extern "C" int decode_attention_fwd(int dtype, int tc, const void* q,
                                    const void* k, const void* v,
                                    const int* length, void* out,
                                    float* part_acc, float* part_ml,
                                    float* lse, int B,
                                    int H, int Hkv, int T, int D, int splits,
                                    int chunk, float scale, float softcap,
                                    const long long* strides, void* stream) {
  if (tc && dtype != 1) return (int)cudaErrorInvalidValue;
  if (splits < 1 || chunk % TILE || (long long)splits * chunk < T ||
      (splits > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.length = length;
  p.o = out;
  p.part_acc = part_acc;
  p.part_ml = part_ml;
  p.lse = lse;
  p.H = H;
  p.Hkv = Hkv;
  p.T = T;
  p.D = D;
  p.splits = splits;
  p.chunk = chunk;
  p.scale = scale;
  p.softcap = softcap;
  for (int i = 0; i < 3; ++i) p.sq[i] = strides[i];
  for (int i = 0; i < 4; ++i) {
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[7 + i];
  }
  for (int i = 0; i < 3; ++i) p.so[i] = strides[11 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_blocks(dtype, tc, p, B, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  err = dtype == 0 ? launch_combine<float>(p, B, s)
                   : launch_combine<bf16>(p, B, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
