// Tensor-core pieces shared by the flash forward (flash_fwd.cu) and the
// two backward passes (flash_bwd_dq.cu, flash_bwd_dkv.cu): f32-accurate
// products on the TF32 tensor cores (3xTF32), 16-byte cp.async tile copies,
// and the m16n8k8 fragment layouts.
//
// 3xTF32. mma.sync.m16n8k8 with tf32 operands and f32 accumulators: each
// f32 operand x is split once into hi = tf32(x) and lo = tf32(x - hi)
// (round to nearest, ties away, as cvt.rna; see to_tf32), and a product is
// taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, summed in the f32 accumulator.
// The dropped a_lo*b_lo term is below 2^-22 of the product, so the result
// keeps f32-level accuracy at three tensor-core passes. A bf16 operand is
// exact in tf32 (8 mantissa bits of tf32's 10): its lo is zero, and the
// terms that would multiply it are skipped (EXACT_A / EXACT_B).
//
// Fragments of m16n8k8 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8 f32):        c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                          c3 (g + 8, 2t + 1)
// A C tile feeds the next product as its A operand with no data movement
// when the 8 k indices of that k-step are taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7): then a0 = c0, a1 = c2, a2 = c1, a3 = c3, and
// the B operand of the same k-step reads its rows 2t and 2t + 1 for b0 and
// b1 (see b_frag_perm). The sum over k is the same sum.
//
// Shared-memory tiles are 64 rows of D elements in the input type, each
// row padded by 16 bytes: the pitch is D + 4 floats or D + 8 bf16, i.e.
// 4 mod 32 words at every head dim that matters (D = 64, 128; D = 16, 32
// work out conflict-free too). A-fragment reads (row g, col t) and
// B-fragment reads of a K-major tile (row g, col t) then hit 32 distinct
// banks (word 4g + t), and so do the permuted reads of a row-major tile
// (rows 2t and 2t + 1, col g: word 8t + g and 8t + 4 + g). With bf16 two
// lanes share each word, which the hardware broadcasts. The padding also
// keeps every row 16-byte aligned for cp.async.

#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace zoo_mma {

using zoo_flash::ROWS;         // rows of a staged tile
using zoo_flash::to_f;

constexpr int THREADS = 128;   // 4 warps, 16 rows of the CTA's tile each

// Elements of one padded row, and of one padded 64-row tile.
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}
template <typename T, int D>
__host__ __device__ constexpr int tile_elems() {
  return ROWS * pitch<T, D>();
}

// f32 -> tf32, round to nearest with ties away from zero: add half a tf32
// ulp to the magnitude and clear the 13 bits tf32 drops. On finite values
// this is cvt.rna.tf32.f32 bit for bit; the cvt compiles to a compare-and-
// select sequence guarding NaN and Inf (FSETP, SEL, IMAD in the SASS), and
// with it the split was the costliest step of both kernels on the H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// One operand value as hi (and lo unless the value is exact in tf32).
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool EXACT>
__device__ __forceinline__ FragA make_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split<EXACT>(a0, f.hi[0], f.lo[0]);
  split<EXACT>(a1, f.hi[1], f.lo[1]);
  split<EXACT>(a2, f.hi[2], f.lo[2]);
  split<EXACT>(a3, f.hi[3], f.lo[3]);
  return f;
}

template <bool EXACT>
__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split<EXACT>(b0, f.hi[0], f.lo[0]);
  split<EXACT>(b1, f.hi[1], f.lo[1]);
  return f;
}

// A fragment of rows r0 .. r0+15, columns k0 .. k0+7 of a padded tile.
template <bool EXACT, typename T, int D>
__device__ __forceinline__ FragA a_frag(const T* s, int r0, int k0, int g,
                                        int t) {
  constexpr int P = pitch<T, D>();
  const T* p = s + (r0 + g) * P + k0 + t;
  return make_a<EXACT>(to_f(p[0]), to_f(p[8 * P]), to_f(p[4]),
                       to_f(p[8 * P + 4]));
}

// B fragment (k = column, n = row) of a K-major tile: rows n0 .. n0+7,
// columns k0 .. k0+7, i.e. B = tile^T, as K is in Q K^T.
template <bool EXACT, typename T, int D>
__device__ __forceinline__ FragB b_frag_t(const T* s, int n0, int k0, int g,
                                          int t) {
  constexpr int P = pitch<T, D>();
  const T* p = s + (n0 + g) * P + k0 + t;
  return make_b<EXACT>(to_f(p[0]), to_f(p[4]));
}

// B fragment (k = row, n = column) of a row-major tile, rows k0 .. k0+7 in
// the permuted k order of a C tile used as A (see the note above).
template <bool EXACT, typename T, int D>
__device__ __forceinline__ FragB b_frag_perm(const T* s, int k0, int n0,
                                             int g, int t) {
  constexpr int P = pitch<T, D>();
  const T* p = s + (k0 + 2 * t) * P + n0 + g;
  return make_b<EXACT>(to_f(p[0]), to_f(p[P]));
}

// The C tile c of a 16 x 8 accumulator as the A operand of the next
// product, in the permuted k order.
template <bool EXACT>
__device__ __forceinline__ FragA c_as_a(const float (&c)[4]) {
  return make_a<EXACT>(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 (fewer passes where an operand is exact in tf32);
// the small terms go first.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if (!EXACT_A) mma(d, a.lo, b.hi);
  if (!EXACT_B) mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// ---- cp.async ------------------------------------------------------------

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start copying rows r0 .. r0+63 of one head's (seq, D) slice, row stride
// rs elements, into a padded shared tile; rows at or past n become zeros.
// The global rows must be 16-byte aligned (the wrappers see to it).
template <typename T, int D>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, long long rs,
                                        int r0, int n) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int CPR = D / EPC;                           // copies a row
  constexpr int P = pitch<T, D>();
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i - (i / CPR) * CPR;
    const int s = r0 + r;
    const bool ok = s < n;
    cp_async16(dst + r * P + c * EPC, src + (ok ? s : 0) * rs + c * EPC,
               ok ? 16 : 0);
  }
}

}  // namespace zoo_mma
