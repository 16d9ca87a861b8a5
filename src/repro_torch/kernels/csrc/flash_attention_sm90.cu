// Causal (optionally sliding-window) GQA attention for prefill, forward
// only, bfloat16, for Hopper (sm_90a): the "sm90" route of
// kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:78
// (flash_attention, kernel body _flash_kernel) for bfloat16 inputs with
// head dim 32, 64, 128 or 256; float32 and other head dims take
// flash_attention.cu.  It computes what the Pallas kernel computes: an
// online softmax with a float32 running max, denominator and
// accumulator; q head h reads kv head h / (H / Hkv) with no repeat; query
// row i sits at position q_offset + i and key j at position j, causal
// masks j > q_offset + i, window masks q_offset + i - j >= window; masked
// keys get probability exactly 0; out = acc / max(l, 1e-20) in bfloat16.
// With a softcap c > 0 each scaled score becomes c tanh(score / c) before
// the mask (softcap.cuh), as the reference's gqa_attention computes.
// Unlike the Pallas kernel it takes any S and T, a query offset (a chunk
// of a prompt against the cache rows before it), and tensors by strides
// (the model's permuted views of its [B, S, H, D] activations and
// [B, T, Hkv, D] cache, no copy).
//
// What bounds it: at the serving shapes, operations on the bf16 tensor
// cores (4 D flops per visible (query, key) pair against ~2 (S H + T Hkv)
// D bytes: ~900 flops a byte for a causal Qwen2.5-7B prefill at S = T =
// 2048, three times the card's ridge point).  So both products run on
// the tensor cores, and the design keeps them fed:
//   * a CTA owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each (wgmma's M), plus one producer warpgroup;
//   * TMA brings Q once and K, V tiles (128 keys for D <= 128, 64 for
//     D = 256) into a ring of STAGES shared-memory stages, in 64-column
//     slabs of 128 bytes with the 128-byte swizzle, guarded by mbarriers:
//     one thread of the producer keeps the loads in flight while the
//     consumers compute, waiting on "full" barriers and releasing "empty"
//     ones;
//   * S = Q K^T is wgmma m64nBNk16 with both operands in shared memory
//     (K-major), f32 accumulators;
//   * the online softmax runs on the accumulator fragments (a row is
//     shared by the 4 threads of a quad: max by two shuffles; the sum is
//     kept per thread and reduced once at the end) and always rescales O;
//   * P is rounded to bf16 in registers, where S's accumulator layout is
//     already wgmma's register-A layout, and O += P V is wgmma m64nDk16
//     with V read from shared memory as an MN-major ("transposed") B
//     operand, so V needs no transpose pass;
//   * K tiles wholly above the causal diagonal or wholly before the
//     window are never loaded; only tiles that cross an edge (the
//     diagonal, the window, the end of T) are masked; all three are
//     worked out from the rows' positions (q_offset + row); the heaviest
//     query tiles launch first (the last rows: the most keys under
//     causality at any offset);
//   * setmaxnreg gives the producer 24 registers and each consumer 240.
// A softcap costs an accurate tanhf a score on the FP32 pipe, in the
// consumers between their wgmmas: it is on the critical path (PERF.md
// has its time against the uncapped kernel's).
// Head dims below 64 are loaded as one 64-column slab whose columns past D
// TMA fills with zeros; those output columns are never stored.

#include <cuda.h>  // CUtensorMap and the driver API's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "softcap.cuh"

namespace {

constexpr int BM = 128;        // query rows of a CTA (two warpgroups of 64)
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int THREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
// return codes of the entry point besides CUDA errors
constexpr int ERR_ARGS = 10001;        // not bfloat16, or an unsupported D
constexpr int ERR_NO_ENCODER = 10002;  // no cuTensorMapEncodeTiled found
constexpr int ERR_TENSOR_MAP = 20000;  // + the CUresult of a refused map

template <int D>
struct Tile {
  static constexpr int DP = D < 64 ? 64 : D;     // head dim in smem (padded)
  static constexpr int SLABS = DP / 64;          // 128-byte column slabs
  static constexpr int BN = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;   // one K or V tile
  // Q, STAGES x (K, V), barriers, and slack to align the base to 1024
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 128 + 1024;
};

struct Params {
  void* o;
  int H, Hkv, S, T, D, causal, window, q_offset;
  float scale_log2;    // 1 / sqrt(D) * log2(e): scores in exp2 units
  SoftCap cap;         // in exp2 units
  long long so[4];     // element strides of out [B, H, S, D]
};

// ---- shared memory, barriers, TMA ------------------------------------------

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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into smem
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  lbo / sbo in bytes:
// K-major operands (Q, K) step 1024 bytes between 8-row groups (lbo is
// unused); the MN-major V steps sbo = 1024 between 8-key groups and
// lbo = one slab between 64-column blocks of D.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 accumulate.
// wgmma_ss: A and B K-major in shared memory.  wgmma_rs: A in registers
// (the accumulator layout of a 64 x 16 f32 tile, as bf16 pairs), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel ------------------------------------------------------------

// Grid (H, ceil(S / BM), B); blockIdx.y counts query tiles from the last
// (the heaviest under causality) down.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Tile<D>;
  constexpr int DP = C::DP, BN = C::BN, SLABS = C::SLABS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;             // Q slabs
  const uint32_t sk = sq + C::Q_BYTES;                   // K stages
  const uint32_t sv = sk + STAGES * C::KV_BYTES;         // V stages
  const uint32_t bars = sv + STAGES * C::KV_BYTES;       // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int kvh = h / (p.H / p.Hkv);
  // the key tiles some row of this CTA sees (rows at positions
  // q_offset + row)
  const int q_last = min(q0 + BM, p.S) - 1;
  const int pos0 = p.q_offset + q0, pos_last = p.q_offset + q_last;
  const int kend = p.causal ? min(p.T, pos_last + 1) : p.T;
  const int kbeg = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;
  const int n_begin = kbeg / BN;
  const int ntiles = max(0, (kend + BN - 1) / BN - n_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);          // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && ntiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int s = 0; s < SLABS; ++s)
        tma_load(sq + s * BM * 128, &tq, q_full, s * 64, q0, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        const int n0 = (n_begin + it) * BN;
        mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), C::KV_BYTES);
        for (int s = 0; s < SLABS; ++s)
          tma_load(sk + st * C::KV_BYTES + s * BN * 128, &tk, k_full(st),
                   s * 64, n0, kvh, b);
        mbar_expect_tx(v_full(st), C::KV_BYTES);
        for (int s = 0; s < SLABS; ++s)
          tma_load(sv + st * C::KV_BYTES + s * BN * 128, &tv, v_full(st),
                   s * 64, n0, kvh, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);       // + 8 i: this thread's columns
  // scores to exp2 units: scale_log2 uncapped; capped, the cap's output
  // is already there
  const float mul = p.cap.on ? 1.f : p.scale_log2;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (ntiles > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    const int n0 = (n_begin + it) * BN;

    // S = Q K^T over DP / 16 steps of 16 columns
    float s[BN / 2];
    mbar_wait(k_full(st), par);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns within a slab
      wgmma_ss(s,
               desc(sq + (kk / 4) * BM * 128 + wg * 64 * 128 + off, 16,
                    1024),
               desc(sk + st * C::KV_BYTES + (kk / 4) * BN * 128 + off, 16,
                    1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the cap first: a masked key must stay at -inf
    if (p.cap.on) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = p.cap(s[i]);
    }
    // mask the tiles that cross the diagonal, the window or the end of T
    const bool edge = n0 + BN > p.T || (p.causal && n0 + BN - 1 > pos0) ||
                      (p.window > 0 && pos_last - n0 >= p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + 8 * i + col + (e & 1);
          const int pos = p.q_offset + row0 + 8 * (e >> 1);
          const bool ok = key < p.T && (!p.causal || key <= pos) &&
                          (p.window <= 0 || pos - key < p.window);
          if (!ok) s[4 * i + e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments; m is kept in exp2 units
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * mul);
      // a row that has seen no key yet keeps m = -inf: subtract 0 so that
      // its masked entries give exp2(-inf) = 0, not NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = ex2(fmaf(s[4 * i + 2 * r + e], mul, -m_use));
          s[4 * i + 2 * r + e] = pe;
          sum += pe;
        }
      }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i + 0] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }

    // P in bf16: the accumulator fragment of keys [16 kc, 16 kc + 16) is
    // the register-A fragment of the k-step kc
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kc][j] = pack_bf16(s[8 * kc + 2 * j], s[8 * kc + 2 * j + 1]);
    }

    // O += P V over BN / 16 steps of 16 keys
    mbar_wait(v_full(st), par);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
      wgmma_rs(o, pa[kc],
               desc(sv + st * C::KV_BYTES + kc * 16 * 128, BN * 128, 1024),
               1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // out = acc / max(l, 1e-20), each row's l summed over its quad
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.so[0] +
                       h * p.so[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-20f);
    const int pos = row0 + 8 * r;
    if (pos >= p.S) continue;
    __nv_bfloat16* orow = out + pos * p.so[2];
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col;
      if (c < p.D)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    }
  }
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map of [B, heads, rows, D] (element strides st) as dims {D, rows,
// heads, B}, boxes of 64 columns x box_rows rows, 128-byte swizzle, zeros
// past every edge.  A dimension of size 1 is never stepped, so its stride
// is replaced by the extent inside it (any stride the caller's view has
// there is then accepted).
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int B,
                  int heads, int rows, int D, const long long* st,
                  int box_rows) {
  const long long s_row = rows > 1 ? st[2] : D;
  const long long s_head = heads > 1 ? st[1] : s_row * rows;
  const long long s_b = B > 1 ? st[0] : s_head * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, const long long* strides, cudaStream_t stream) {
  using C = Tile<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, B, p.H, p.S, D, strides, BM);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &tk, k, B, p.Hkv, p.T, D, strides + 4, C::BN);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &tv, v, B, p.Hkv, p.T, D, strides + 8, C::BN);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + (int)r;
  // opt in to more than 48 KB of shared memory (on the current device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, (p.S + BM - 1) / BM, B);
  flash_sm90_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The same interface as flash_attention_fwd (flash_attention.cu).  dtype
// must be 1 (bfloat16) and D one of 32, 64, 128, 256; strides: 16 element
// strides, [B, H, S, D] of q, [B, Hkv, T, D] of k and v, then [B, H, S, D]
// of out; every last-dim stride is 1, the bases of q, k and v are 16-byte
// aligned and their other strides multiples of 8 elements where the
// dimension is longer than 1 (the wrapper checks).  window <= 0: none;
// q_offset >= 0: the position of query row 0; softcap <= 0: none.
// Returns 0, a CUDA error of the launch, ERR_TENSOR_MAP + the CUresult of
// a refused tensor map, or ERR_NO_ENCODER / ERR_ARGS.
extern "C" int flash_attention_sm90_fwd(int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* out, int B, int H, int Hkv,
                                        int S, int T, int D, int causal,
                                        int window, int q_offset,
                                        float scale, float softcap,
                                        const long long* strides,
                                        void* stream) {
  if (dtype != 1 || q_offset < 0) return ERR_ARGS;
  Params p;
  p.o = out;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.T = T;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale * LOG2E;
  p.cap = SoftCap::make(softcap, scale, LOG2E);
  for (int i = 0; i < 4; ++i) p.so[i] = strides[12 + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, p, B, strides, s);
    case 64: return launch<64>(q, k, v, p, B, strides, s);
    case 128: return launch<128>(q, k, v, p, B, strides, s);
    case 256: return launch<256>(q, k, v, p, B, strides, s);
    default: return ERR_ARGS;
  }
}
