// Shared device code of the float32 attention kernels on the tensor cores
// (flash_attention_f32.cu, flash_attention_f32_bwd.cu): float32 products
// as split-precision "3xTF32" on mma.sync m16n8k8, float32 rows staged in
// shared memory with cp.async.
//
// Accuracy.  Every float32 operand x is split into hi = tf32(x) (rounded
// to nearest with cvt.rna) and lo = tf32(x - hi) (x - hi is exact in
// float32), and a product is taken as lo*hi + hi*lo + hi*hi, accumulated
// in float32.  Only lo*lo (about 2^-22 of |a b|) and the rounding of lo
// (about 2^-22 of |x|) are dropped, so a product is as good as float32's
// to within a few units of its last place.  A single TF32 pass (hi*hi
// alone) keeps only about 2^-11: it is the planted fault of chip_smoke's
// accuracy check.
//
// Layouts.  Every staged row has a pitch of D + 4 floats, so the fragment
// loads of both products are free of bank conflicts:
//   * gemm_abt: C[16 x N] += A[16 x D] B[N x D]^T, A read raw from shared
//     memory (split per k-step, once for all N/8 column tiles), B read
//     already split (hi and lo arrays) -- lane (g, t) reads A[g][8k + t],
//     B[8n + g][8k + t]: banks 4 g + t, all 32 distinct;
//   * gemm_pb_add: O[16 x N] += P[16 x K] B[K x N], P from the accumulator
//     fragments of a gemm_abt (registers), B split in shared memory.  The
//     accumulator holds columns 2t and 2t + 1 of each 8-column tile and
//     the A operand wants columns t and t + 4, so the k index is permuted
//     within every 8 (A column t <-> key 2t, t + 4 <-> key 2t + 1) and B
//     is read at rows 2t and 2t + 1 to match: banks 8 t + g, distinct.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tf32 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ERR_ARGS = 10001;   // an unsupported head dim

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 values (as float32 bit patterns)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// c += hi * hi and cs += the two cross terms: the small terms sum apart
// (about 2^-11 of c), so the tensor cores' truncating accumulation does
// not cut them against c's partial sums; the caller adds cs to c once
__device__ __forceinline__ void mma3_apart(float (&c)[4], float (&cs)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma(cs, al, bh);
  mma(cs, ah, bl);
  mma(c, ah, bh);
}

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [row0, row0 + ROWS) of src (D floats each, `stride`
// floats apart; rows 16-byte aligned, which the wrapper checks) into dst
// at pitch D + 4; rows at or past row0 + nrows are zero-filled (nothing is
// read for them).  NT threads share the copies.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int P = D + 4, CH = D / 4;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (ROWS * CH % NT == 0 || e < ROWS * CH) {
      const int r = e / CH, c = (e % CH) * 4;
      const bool ok = r < nrows;
      cp_async16(dst + r * P + c, src + (ok ? (row0 + r) * stride : 0) + c,
                 ok);
    }
  }
}

// Split the staged rows raw[ROWS][P] into hi and lo (same layout).
template <int D, int ROWS, int NT>
__device__ __forceinline__ void split_rows(const float* raw, float* hi,
                                           float* lo, int tid) {
  constexpr int P = D + 4, CH = D / 4;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (ROWS * CH % NT == 0 || e < ROWS * CH) {
      const int off = (e / CH) * P + (e % CH) * 4;
      const float4 x = *reinterpret_cast<const float4*>(raw + off);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// ---- warp products ---------------------------------------------------------

// c[N/8][4] += A[16 x D] B[N x D]^T: a points at the warp's first A row
// (raw float32, pitch P), bh / bl at B's first row (split, pitch P).
// APART: the cross terms sum in their own registers (mma3_apart), added
// to c at the end -- more accurate, N / 2 more registers.
template <int D, int N, bool APART = false>
__device__ __forceinline__ void gemm_abt(float (&c)[N / 8][4], const float* a,
                                         const float* bh, const float* bl,
                                         int lane) {
  constexpr int P = D + 4;
  const int g = lane >> 2, t = lane & 3;
  float cs[APART ? N / 8 : 1][4];
  if constexpr (APART) zero(cs);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const float* ap = a + g * P + ks * 8 + t;
    uint32_t ah[4], al[4];
    split(ap[0], ah[0], al[0]);
    split(ap[8 * P], ah[1], al[1]);
    split(ap[4], ah[2], al[2]);
    split(ap[8 * P + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int off = (n * 8 + g) * P + ks * 8 + t;
      const uint32_t bhi[2] = {__float_as_uint(bh[off]),
                               __float_as_uint(bh[off + 4])};
      const uint32_t blo[2] = {__float_as_uint(bl[off]),
                               __float_as_uint(bl[off + 4])};
      if constexpr (APART)
        mma3_apart(c[n], cs[n], ah, al, bhi, blo);
      else
        mma3(c[n], ah, al, bhi, blo);
    }
  }
  if constexpr (APART) {
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += cs[n][e];
  }
}

// o[N/8][4] += P[16 x K] B[K x N]: p holds P as the accumulator fragments
// of a gemm_abt over K columns; bh / bl point at B's row 0, column 0 of
// the N columns wanted (split, pitch P).  Each 8-column product is summed
// over the K rows in fresh registers (with APART, the cross terms in
// registers of their own, mma3_apart) and then added to o by float32
// adds: the tensor cores' accumulation (which does not round to nearest)
// never carries a sum across tiles, so a sum over thousands of keys or
// query rows is added up in round-to-nearest float32 steps.
template <int K, int N, int P, bool APART = true>
__device__ __forceinline__ void gemm_pb_add(float (&o)[N / 8][4],
                                            const float (&p)[K / 8][4],
                                            const float* bh, const float* bl,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {
    split(p[ks][0], ah[ks][0], al[ks][0]);  // (g, key 2t)     -> a0 (g, t)
    split(p[ks][2], ah[ks][1], al[ks][1]);  // (g + 8, key 2t) -> a1
    split(p[ks][1], ah[ks][2], al[ks][2]);  // (g, key 2t + 1) -> a2 (g, t + 4)
    split(p[ks][3], ah[ks][3], al[ks][3]);  // (g + 8, key 2t + 1) -> a3
  }
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const int off = (ks * 8 + 2 * t) * P + n * 8 + g;
      const uint32_t bhi[2] = {__float_as_uint(bh[off]),
                               __float_as_uint(bh[off + P])};
      const uint32_t blo[2] = {__float_as_uint(bl[off]),
                               __float_as_uint(bl[off + P])};
      if constexpr (APART)
        mma3_apart(c, cs, ah[ks], al[ks], bhi, blo);
      else
        mma3(c, ah[ks], al[ks], bhi, blo);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += APART ? c[e] + cs[e] : c[e];
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tf32
