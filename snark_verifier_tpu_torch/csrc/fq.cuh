// BN254 prime fields on the GPU, generic over a field tag: Fq (the base
// field, point coordinates) and Fr (the scalar field: transcript, Poseidon,
// verifier scalars).  An element is 8 little-endian 32-bit words of the
// Montgomery form x*R mod p, R = 2^256 -- the same numbers as the JAX
// package's 16x16-bit limbs, repacked.
//
// Lazy contract of ff/limb_field.py (and the JAX package's jnp_field.py):
// values lie in [0, 2p].  The Montgomery product maps [0,2p]x[0,2p] into
// [0,2p] with no final subtraction (4p < 2^256 for both fields); add and sub
// reduce mod 2p.  Each function here is the same function of its inputs as
// its plain twin, so kernel and twin agree bit for bit, even before
// canonicalization.  The product (a*b + m*p)/R is a function of a*b alone
// (m is the unique m < R that clears the low 256 bits), so operand order and
// limb width never change it.
//
// Cost model, for the kernels' bound: one fe_mul is word-serial Montgomery
// with 8x8 a*b word products, 8 reduction digits and 8x8 m*p products = 136
// 32x32->64 multiply-adds.  Integer Montgomery arithmetic has no tensor-core
// (wgmma) path -- the tensor cores take bf16/fp16/fp8/int8 -- so it runs on
// the SMs' integer pipes.  fe_add / fe_sub are carry chains with no
// multiplies.
//
// What bounds the multiply on an H100, and what the design does about it.
// The first version threaded a 64-bit `s >> 32` carry through all 136
// multiply-adds in C++ (616 instructions, 35 G muls/s on a full card, 1,573
// clocks for a warp alone).  Here the carries live in the carry flag and the
// partial products are split into even and odd columns (below): ptxas fuses
// each mad.lo.cc / madc.hi.cc pair into one IMAD.WIDE.U32(.X), 122 of them
// per multiply beside 16 narrow IMADs and ~43 IADD3 (cuobjdump).  IMAD.WIDE
// runs at half the 32-bit rate (32 per SM per clock), so a full card reaches
// 58 G muls/s, 94% of what 136 wide multiply-adds per product allow, and a
// warp alone takes ~805 clocks per multiply, the latency of its carry
// chains.  fe_sqr needs 36 products instead of 64: 70 G squares/s, ~670
// clocks alone.  (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the runs.)
#pragma once

#include <cstdint>

namespace svt {

constexpr int FQ_WORDS = 8;  // 32-bit words per element, either field

// Field tags: template arguments of every fe_* function and the `field`
// argument of the C entry points (ff/word_field.py passes the same values).
constexpr int FQ = 0;
constexpr int FR = 1;

static __constant__ uint32_t FIELD_ONE[2][FQ_WORDS] = {  // R mod p: 1 in Montgomery form
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
static __constant__ uint32_t FIELD_PM2[2][FQ_WORDS] = {  // p - 2, the inversion exponent
    {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xefffffffu, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
constexpr int FIELD_BITS = 254;  // bit length of p - 2, both fields

template <int F>
__device__ __forceinline__ uint32_t fe_pinv() {  // -p^-1 mod 2^32
  return F == FQ ? 0xe4866389u : 0xefffffffu;
}

// Word k of p and of 2p as literals: in the carry chains below every modulus
// word is an immediate of its instruction, not a register or a load.
__host__ __device__ constexpr uint32_t fe_pick(int k, uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3, uint32_t w4, uint32_t w5, uint32_t w6,
                                               uint32_t w7) {
  return k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : k == 3 ? w3 : k == 4 ? w4 : k == 5 ? w5
       : k == 6 ? w6 : w7;
}
template <int F>
__host__ __device__ constexpr uint32_t fe_p(int k) {
  return F == FQ ? fe_pick(k, 0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u)
                 : fe_pick(k, 0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u);
}
template <int F>
__host__ __device__ constexpr uint32_t fe_p2(int k) {
  return F == FQ ? fe_pick(k, 0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                           0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u)
                 : fe_pick(k, 0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                           0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u);
}

__device__ __forceinline__ void fe_copy(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r[i] = a[i];
}

// Every multi-word operation below is one inline-PTX statement whose words
// are linked by the carry flag (add.cc / addc.cc, sub.cc / subc.cc, mad.lo.cc
// / madc.hi.cc): no carry ever sits in a register or waits for a shift.  A
// statement is self-contained -- the flag never crosses from one asm to the
// next -- and tests/test_torch_mul_schedule.py executes these very
// statements, word by word with an explicit flag, against python ints.

// r = a + b mod 2^256.
__device__ __forceinline__ void fe_add8(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                        const uint32_t b[FQ_WORDS]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// r = a - b mod 2^256; returns 0xffffffff if it borrowed, else 0.
__device__ __forceinline__ uint32_t fe_sub8(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                            const uint32_t b[FQ_WORDS]) {
  uint32_t brw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7]), "=r"(brw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return brw;
}

// m = (p, or 2p if `twice`) & mask, as eight immediates.
template <int F>
__device__ __forceinline__ void fe_modulus(uint32_t m[FQ_WORDS], bool twice, uint32_t mask) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) m[i] = (twice ? fe_p2<F>(i) : fe_p<F>(i)) & mask;
}

// r = s - m if s >= m, else s.  r may alias s.
__device__ __forceinline__ void fe_cond_sub(uint32_t r[FQ_WORDS], const uint32_t s[FQ_WORDS],
                                            const uint32_t m[FQ_WORDS]) {
  uint32_t d[FQ_WORDS];
  const uint32_t brw = fe_sub8(d, s, m);
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r[i] = brw ? s[i] : d[i];
}

// r = a + b mod 2p (a + b <= 4p < 2^256: no carry out).  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_add(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  uint32_t s[FQ_WORDS], p2[FQ_WORDS];
  fe_modulus<F>(p2, true, 0xffffffffu);
  fe_add8(s, a, b);
  fe_cond_sub(r, s, p2);
}

// r = a - b, plus 2p (mod 2^256) when it borrows.  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_sub(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  uint32_t d[FQ_WORDS], p2[FQ_WORDS];
  const uint32_t brw = fe_sub8(d, a, b);
  fe_modulus<F>(p2, true, brw);
  fe_add8(r, d, p2);
}

// r = 2p - a, in [0, 2p] (no reduction, as LimbField.neg).  r may alias a.
template <int F>
__device__ __forceinline__ void fe_neg(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t p2[FQ_WORDS];
  fe_modulus<F>(p2, true, 0xffffffffu);
  fe_sub8(r, p2, a);
}

// The canonical representative in [0, p) of a value in [0, 2p].
template <int F>
__device__ __forceinline__ void fe_canon(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t m[FQ_WORDS];
  fe_modulus<F>(m, true, 0xffffffffu);
  fe_cond_sub(r, a, m);
  fe_modulus<F>(m, false, 0xffffffffu);
  fe_cond_sub(r, r, m);
}

// ---- the Montgomery multiply -------------------------------------------
//
// Word-serial Montgomery (one word b_i of b and one reduction digit m_i per
// row), with the running sum held as two 8-word accumulators instead of
// one: `e` collects the 64-bit products that start at even word offsets
// (a_0 b_i, a_2 b_i, ... and p_0 m_i, p_2 m_i, ...), `o` those that start at
// odd offsets, one word higher.  Inside one accumulator the products of a
// row do not overlap, so a row is a run of mad.lo.cc / madc.hi.cc pairs
// that depend on each other through the carry flag only, and the two
// accumulators' runs are independent of each other.  (The layout of CGBN
// and sppark.  The earlier CIOS loop threaded a 64-bit `s >> 32` carry
// through all 136 multiply-adds, so each waited for the one before.)
//
// After a row's reduction e[0] is 0, and dividing by 2^32 swaps the roles:
// the old `o` becomes the next row's even accumulator, the old `e`, moved
// down two words, its odd one.  All terms are non-negative and the whole
// sum stays below (a + p) 2^32 <= 3p 2^32 < 2^288, so no carry out of a
// top word is ever lost; the output is (a b + M p) / R <= 2p with no final
// subtraction, a function of a*b alone: bit-identical to any other
// word-serial schedule and to the plain version.

// Row i >= 1, first half.  On entry (e, o) = (the last row's odd, even).
// e[0] += o[1] (the word that falls to offset 0), then o <- (o >> 64) +
// a_1 b, a_3 b, a_5 b, a_7 b, the carry of that first add included.
__device__ __forceinline__ void fe_row_odd(uint32_t e[FQ_WORDS], uint32_t o[FQ_WORDS],
                                           const uint32_t a[FQ_WORDS], uint32_t b) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;"
      : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// Second half: e += a_0 b, a_2 b, a_4 b, a_6 b; the carry out of e's top
// word belongs to offset 8, o's top word.
__device__ __forceinline__ void fe_row_even(uint32_t e[FQ_WORDS], uint32_t o[FQ_WORDS],
                                            const uint32_t a[FQ_WORDS], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o[7])
      : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
}

// o += a_1 b, a_3 b, a_5 b, a_7 b in place (no shift): the odd half of a
// row's reduction (a = p, b = m) and of fe_mul_sum's second product.  The
// carry out of o's top word is 0 by the callers' bounds.
__device__ __forceinline__ void fe_mad_odd(uint32_t o[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                           uint32_t b) {
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// The reduction of a row: m = e[0] * (-p^-1) mod 2^32, then o += p_1 m,
// p_3 m, p_5 m, p_7 m and e += p_0 m, p_2 m, p_4 m, p_6 m; e[0] becomes 0.
template <int F>
__device__ __forceinline__ void fe_redc_odd(uint32_t o[FQ_WORDS], uint32_t m) {
  const uint32_t p[FQ_WORDS] = {fe_p<F>(0), fe_p<F>(1), fe_p<F>(2), fe_p<F>(3),
                                fe_p<F>(4), fe_p<F>(5), fe_p<F>(6), fe_p<F>(7)};
  fe_mad_odd(o, p, m);
}

template <int F>
__device__ __forceinline__ void fe_redc_even(uint32_t e[FQ_WORDS], uint32_t o[FQ_WORDS],
                                             uint32_t m) {
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(o[7])
      : "r"(fe_p<F>(0)), "r"(fe_p<F>(2)), "r"(fe_p<F>(4)), "r"(fe_p<F>(6)), "r"(m));
}

template <int F>
__device__ __forceinline__ void fe_redc_row(uint32_t e[FQ_WORDS], uint32_t o[FQ_WORDS]) {
  const uint32_t m = e[0] * fe_pinv<F>();
  fe_redc_odd<F>(o, m);
  fe_redc_even<F>(e, o, m);
}

// The two accumulators joined, after the last row (whose even accumulator
// was o): r = (e >> 32) + o... in words, r[j] = e[j] + o[j + 1].
__device__ __forceinline__ void fe_merge(uint32_t r[FQ_WORDS], const uint32_t e[FQ_WORDS],
                                         const uint32_t o[FQ_WORDS]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(e[6]), "r"(e[7]),
        "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
}

// r = a*b*R^-1.  Inputs in [0, 2p], output in [0, 2p].  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_mul(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  uint32_t e[FQ_WORDS], o[FQ_WORDS];
#pragma unroll
  for (int j = 0; j < FQ_WORDS; j += 2) {  // row 0: nothing to add to yet
    const uint64_t pe = (uint64_t)a[j] * b[0], po = (uint64_t)a[j + 1] * b[0];
    e[j] = (uint32_t)pe;
    e[j + 1] = (uint32_t)(pe >> 32);
    o[j] = (uint32_t)po;
    o[j + 1] = (uint32_t)(po >> 32);
  }
  fe_redc_row<F>(e, o);
#pragma unroll
  for (int i = 1; i < FQ_WORDS; i += 2) {
    fe_row_odd(o, e, a, b[i]);
    fe_row_even(o, e, a, b[i]);
    fe_redc_row<F>(o, e);
    if (i + 1 < FQ_WORDS) {
      fe_row_odd(e, o, a, b[i + 1]);
      fe_row_even(e, o, a, b[i + 1]);
      fe_redc_row<F>(e, o);
    }
  }
  fe_merge(r, e, o);
}

// r = (a*b + c*d + M*p) / R: a sum of two products with one Montgomery
// reduction (for the group law's layer 2, where three such sums end the
// add).  Each row adds a*b_i and c*d_i to the two accumulators -- the same
// even and odd runs as fe_mul's, the second product without the shift
// (fe_mad_odd, fe_row_even) -- and then reduces once: 2 * 64 + 8 + 64 =
// 200 multiply-adds where two fe_mul and an add take 272.
//
// Headroom.  For a, b, c, d in [0, 2p] the sum before row i's division by
// 2^32 is below (a + c + p) 2^32 <= 5p 2^32 < 0.95 * 2^288 (p < 0.19 *
// 2^256, both fields): it fits the nine words the two accumulators span
// (o's top word is word 8), every term is non-negative, so no carry ever
// leaves o's top word, as in fe_mul.  The result is below (8p^2 + R p) / R
// < 2.52p: eight words, but OUTSIDE the lazy [0, 2p] contract.  fe_canon
// (which maps [0, 3p) to [0, p)) or a conditional subtraction of 2p must
// follow before the value meets another function of this file.  A function
// of a*b + c*d alone, as fe_mul is of a*b.  r may alias any input.
template <int F>
__device__ __forceinline__ void fe_mul_sum(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                           const uint32_t b[FQ_WORDS], const uint32_t c[FQ_WORDS],
                                           const uint32_t d[FQ_WORDS]) {
  uint32_t e[FQ_WORDS], o[FQ_WORDS];
#pragma unroll
  for (int j = 0; j < FQ_WORDS; j += 2) {  // row 0 of a*b: nothing to add to yet
    const uint64_t pe = (uint64_t)a[j] * b[0], po = (uint64_t)a[j + 1] * b[0];
    e[j] = (uint32_t)pe;
    e[j + 1] = (uint32_t)(pe >> 32);
    o[j] = (uint32_t)po;
    o[j + 1] = (uint32_t)(po >> 32);
  }
  fe_mad_odd(o, c, d[0]);
  fe_row_even(e, o, c, d[0]);
  fe_redc_row<F>(e, o);
#pragma unroll
  for (int i = 1; i < FQ_WORDS; i += 2) {
    fe_row_odd(o, e, a, b[i]);
    fe_row_even(o, e, a, b[i]);
    fe_mad_odd(e, c, d[i]);
    fe_row_even(o, e, c, d[i]);
    fe_redc_row<F>(o, e);
    if (i + 1 < FQ_WORDS) {
      fe_row_odd(e, o, a, b[i + 1]);
      fe_row_even(e, o, a, b[i + 1]);
      fe_mad_odd(o, c, d[i + 1]);
      fe_row_even(e, o, c, d[i + 1]);
      fe_redc_row<F>(e, o);
    }
  }
  fe_merge(r, e, o);
}

// ---- the Montgomery square ----------------------------------------------
//
// r = a*a*R^-1, the same eight words as fe_mul(r, a, a).  The 16-word square
// t is built from the 28 products a_i a_j with i < j, doubled, plus the 8
// squares a_i^2: 36 products instead of 64.  The products of one distance
// d = j - i start two words apart, so each distance is one carry chain;
// odd distances collect in u, even ones in v (the same even/odd split as the
// multiply's).  Then eight reduction rows clear the low half -- rows with no
// product row before them, the shift fused into the odd half
// (fe_redc_shift_odd) -- and the high half is added at the end:
// (t + M p) / R = t_hi + (t_lo + M p) / R <= 2p, a function of a*a alone.

// u += a_i a_{i+3} 2^(32 (2i + 3)), i = 0..4; the carry runs to the top word.
__device__ __forceinline__ void fe_sqr_d3(uint32_t u[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %13, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %20, %9;\n\t"
      "addc.cc.u32 %10, %10, 0;\n\t"
      "addc.cc.u32 %11, %11, 0;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(u[3]), "+r"(u[4]), "+r"(u[5]), "+r"(u[6]), "+r"(u[7]), "+r"(u[8]), "+r"(u[9]),
        "+r"(u[10]), "+r"(u[11]), "+r"(u[12]), "+r"(u[13]), "+r"(u[14]), "+r"(u[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
}

// u += a_i a_{i+5} 2^(32 (2i + 5)), i = 0..2.
__device__ __forceinline__ void fe_sqr_d5(uint32_t u[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %11, %14, %0;\n\t"
      "madc.hi.cc.u32 %1, %11, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %15, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %15, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.cc.u32 %9, %9, 0;\n\t"
      "addc.u32 %10, %10, 0;"
      : "+r"(u[5]), "+r"(u[6]), "+r"(u[7]), "+r"(u[8]), "+r"(u[9]), "+r"(u[10]), "+r"(u[11]),
        "+r"(u[12]), "+r"(u[13]), "+r"(u[14]), "+r"(u[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
}

// u += a_0 a_7 2^(32 * 7).
__device__ __forceinline__ void fe_sqr_d7(uint32_t u[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(u[7]), "+r"(u[8]), "+r"(u[9]), "+r"(u[10]), "+r"(u[11]), "+r"(u[12]), "+r"(u[13]),
        "+r"(u[14]), "+r"(u[15])
      : "r"(a[0]), "r"(a[7]));
}

// v += a_i a_{i+4} 2^(32 (2i + 4)), i = 0..3.
__device__ __forceinline__ void fe_sqr_d4(uint32_t v[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %11, %15, %0;\n\t"
      "madc.hi.cc.u32 %1, %11, %15, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %16, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %14, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %14, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.cc.u32 %9, %9, 0;\n\t"
      "addc.u32 %10, %10, 0;"
      : "+r"(v[4]), "+r"(v[5]), "+r"(v[6]), "+r"(v[7]), "+r"(v[8]), "+r"(v[9]), "+r"(v[10]),
        "+r"(v[11]), "+r"(v[12]), "+r"(v[13]), "+r"(v[14])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
}

// v += a_i a_{i+6} 2^(32 (2i + 6)), i = 0..1.
__device__ __forceinline__ void fe_sqr_d6(uint32_t v[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mad.lo.cc.u32 %0, %9, %11, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(v[6]), "+r"(v[7]), "+r"(v[8]), "+r"(v[9]), "+r"(v[10]), "+r"(v[11]), "+r"(v[12]),
        "+r"(v[13]), "+r"(v[14])
      : "r"(a[0]), "r"(a[1]), "r"(a[6]), "r"(a[7]));
}

// u += v on words 2..15 (word 1 is u's alone; v ends at word 14).
__device__ __forceinline__ void fe_sqr_join(uint32_t u[2 * FQ_WORDS],
                                            const uint32_t v[2 * FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %14;\n\t"
      "addc.cc.u32 %1, %1, %15;\n\t"
      "addc.cc.u32 %2, %2, %16;\n\t"
      "addc.cc.u32 %3, %3, %17;\n\t"
      "addc.cc.u32 %4, %4, %18;\n\t"
      "addc.cc.u32 %5, %5, %19;\n\t"
      "addc.cc.u32 %6, %6, %20;\n\t"
      "addc.cc.u32 %7, %7, %21;\n\t"
      "addc.cc.u32 %8, %8, %22;\n\t"
      "addc.cc.u32 %9, %9, %23;\n\t"
      "addc.cc.u32 %10, %10, %24;\n\t"
      "addc.cc.u32 %11, %11, %25;\n\t"
      "addc.cc.u32 %12, %12, %26;\n\t"
      "addc.u32 %13, %13, 0;"
      : "+r"(u[2]), "+r"(u[3]), "+r"(u[4]), "+r"(u[5]), "+r"(u[6]), "+r"(u[7]), "+r"(u[8]),
        "+r"(u[9]), "+r"(u[10]), "+r"(u[11]), "+r"(u[12]), "+r"(u[13]), "+r"(u[14]), "+r"(u[15])
      : "r"(v[2]), "r"(v[3]), "r"(v[4]), "r"(v[5]), "r"(v[6]), "r"(v[7]), "r"(v[8]), "r"(v[9]),
        "r"(v[10]), "r"(v[11]), "r"(v[12]), "r"(v[13]), "r"(v[14]));
}

// t <- 2t on words 1..15 (2 sum_{i<j} a_i a_j 2^(32(i+j)) < a^2 < 2^512).
__device__ __forceinline__ void fe_sqr_double(uint32_t t[2 * FQ_WORDS]) {
  asm("add.cc.u32 %0, %0, %0;\n\t"
      "addc.cc.u32 %1, %1, %1;\n\t"
      "addc.cc.u32 %2, %2, %2;\n\t"
      "addc.cc.u32 %3, %3, %3;\n\t"
      "addc.cc.u32 %4, %4, %4;\n\t"
      "addc.cc.u32 %5, %5, %5;\n\t"
      "addc.cc.u32 %6, %6, %6;\n\t"
      "addc.cc.u32 %7, %7, %7;\n\t"
      "addc.cc.u32 %8, %8, %8;\n\t"
      "addc.cc.u32 %9, %9, %9;\n\t"
      "addc.cc.u32 %10, %10, %10;\n\t"
      "addc.cc.u32 %11, %11, %11;\n\t"
      "addc.cc.u32 %12, %12, %12;\n\t"
      "addc.cc.u32 %13, %13, %13;\n\t"
      "addc.u32 %14, %14, %14;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      :);
}

// t += sum_i a_i^2 2^(64 i); word 0 is the low half of a_0^2 alone.
__device__ __forceinline__ void fe_sqr_diag(uint32_t t[2 * FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  asm("mul.lo.u32 %0, %16, %16;\n\t"
      "mad.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]),
        "+r"(t[14]), "+r"(t[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]));
}

// A reduction row with no product row before it (the square's): e[0] +=
// o[1], m = e[0] * (-p^-1), o <- (o >> 64) + p_1 m, p_3 m, p_5 m, p_7 m with
// the carry of the first add; fe_redc_even then adds the even words of p.
template <int F>
__device__ __forceinline__ void fe_redc_shift_odd(uint32_t e[FQ_WORDS], uint32_t o[FQ_WORDS],
                                                  uint32_t& m) {
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "mul.lo.u32 %9, %0, %14;\n\t"
      "madc.lo.cc.u32 %1, %10, %9, %3;\n\t"
      "madc.hi.cc.u32 %2, %10, %9, %4;\n\t"
      "madc.lo.cc.u32 %3, %11, %9, %5;\n\t"
      "madc.hi.cc.u32 %4, %11, %9, %6;\n\t"
      "madc.lo.cc.u32 %5, %12, %9, %7;\n\t"
      "madc.hi.cc.u32 %6, %12, %9, %8;\n\t"
      "madc.lo.cc.u32 %7, %13, %9, 0;\n\t"
      "madc.hi.u32 %8, %13, %9, 0;"
      : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7]), "+r"(m)
      : "r"(fe_p<F>(1)), "r"(fe_p<F>(3)), "r"(fe_p<F>(5)), "r"(fe_p<F>(7)), "r"(fe_pinv<F>()));
}

// r = a*a*R^-1.  Input in [0, 2p], output in [0, 2p].  r may alias a.
template <int F>
__device__ __forceinline__ void fe_sqr(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t u[2 * FQ_WORDS], v[2 * FQ_WORDS];
  u[0] = 0;  // written by fe_sqr_diag
  u[2 * FQ_WORDS - 1] = 0;
  v[2 * FQ_WORDS - 2] = 0;
#pragma unroll
  for (int i = 0; i + 1 < FQ_WORDS; i++) {  // distance 1 starts u, distance 2 starts v
    const uint64_t p1 = (uint64_t)a[i] * a[i + 1];
    u[2 * i + 1] = (uint32_t)p1;
    u[2 * i + 2] = (uint32_t)(p1 >> 32);
    if (i + 2 < FQ_WORDS) {
      const uint64_t p2 = (uint64_t)a[i] * a[i + 2];
      v[2 * i + 2] = (uint32_t)p2;
      v[2 * i + 3] = (uint32_t)(p2 >> 32);
    }
  }
  fe_sqr_d3(u, a);
  fe_sqr_d5(u, a);
  fe_sqr_d7(u, a);
  fe_sqr_d4(v, a);
  fe_sqr_d6(v, a);
  fe_sqr_join(u, v);
  uint32_t* t = u;  // from here on the whole square
  fe_sqr_double(t);
  fe_sqr_diag(t, a);
  uint32_t* e = t;  // its low half is the first row's even accumulator
  uint32_t o[FQ_WORDS], m = 0;
#pragma unroll
  for (int j = 0; j < FQ_WORDS; j++) o[j] = 0;
  fe_redc_row<F>(e, o);
#pragma unroll
  for (int i = 1; i < FQ_WORDS; i += 2) {
    fe_redc_shift_odd<F>(o, e, m);
    fe_redc_even<F>(o, e, m);
    if (i + 1 < FQ_WORDS) {
      fe_redc_shift_odd<F>(e, o, m);
      fe_redc_even<F>(e, o, m);
    }
  }
  uint32_t lo[FQ_WORDS];
  fe_merge(lo, e, o);
  fe_add8(r, lo, t + FQ_WORDS);
}

// r = a^(p-2): square-and-multiply from the top bit of p - 2, starting at
// the Montgomery 1, as LimbField.inv (0 maps to 0).  254 squarings and
// popcount(p-2) multiplies.  r may alias a.
template <int F>
__device__ __forceinline__ void fe_inv(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t x[FQ_WORDS], acc[FQ_WORDS];
  fe_copy(x, a);
  fe_copy(acc, FIELD_ONE[F]);
#pragma unroll 1
  for (int i = FIELD_BITS - 1; i >= 0; i--) {
    fe_sqr<F>(acc, acc);
    if ((FIELD_PM2[F][i >> 5] >> (i & 31)) & 1u) fe_mul<F>(acc, acc, x);
  }
  fe_copy(r, acc);
}

// Fq under the names g1.cuh and msm_kernels.cu use.
__device__ __forceinline__ void fq_copy(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  fe_copy(r, a);
}
__device__ __forceinline__ void fq_add(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  fe_add<FQ>(r, a, b);
}
__device__ __forceinline__ void fq_sub(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  fe_sub<FQ>(r, a, b);
}
__device__ __forceinline__ void fq_mul(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  fe_mul<FQ>(r, a, b);
}

// r = 9a by the double/add chain of LimbField.mul_small (3b = 9 for BN254).
__device__ __forceinline__ void fq_mul9(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t acc[FQ_WORDS];
  fq_add(acc, a, a);
  fq_add(acc, acc, acc);
  fq_add(acc, acc, acc);
  fq_add(r, acc, a);
}

}  // namespace svt
