// BN254 Fq Montgomery multiply on the FP64 pipe: five 52-bit limbs held in
// doubles, each limb product split exactly into two 52-bit halves by FMAs
// (Emmart, Zheng and Weems, "Faster Modular Exponentiation Using Double
// Precision Floating Point Arithmetic on the GPU", ARITH 2018), the halves
// summed in 64-bit integer columns.  A second route beside fq.cuh's
// integer fe_mul, for the chain probe (fold_kernels.cu::svt_fq_mul_chain,
// route 1).
//
// Why.  fq.cuh's product is 122 wide 32x32->64 multiply-adds (IMAD.WIDE),
// which issue at 32 an SM a clock on an H100: half the 64 an SM a clock of
// the 32-bit rate on which the port's bounds are built.  The H100 SXM also
// issues 64 FP64 FMAs an SM a clock, on a pipe of its own.  Here the FP64
// pipe does the products and the integer ALU the column additions, and the
// two run at the same time.
//
// Limbs.  x = sum_i x_i 2^(52 i), i < 5, 0 <= x_i < 2^52, so x < 2^260.  A
// limb lives in a double as the exact integer (every integer below 2^53 is
// one), and in a uint64_t between products.
//
// The split of one limb product (a, b < 2^52, so ab < 2^104):
//   hi = fma_rz(a, b, 2^104)          = 2^104 + k 2^52,  k = floor(ab / 2^52)
//   s  = 2^104 + 2^52 - hi (dsub_rn)  = (1 - k) 2^52, exact
//   lo = fma_rn(a, b, s)              = 2^52 + (ab mod 2^52), exact
// ab + 2^104 lies in [2^104, 2^105), where doubles are the multiples of
// 2^52, so hi rounded toward zero is exact in the form above; s is a
// multiple of 2^52 below 2^104 in magnitude and lo an integer in [2^52,
// 2^53): both exact whatever the rounding.  Only hi needs its rounding:
// toward zero keeps both halves nonnegative and lo inside one binade.  (To
// nearest, lo would lie in [2^51, 3 2^51] and straddle 2^52, where the bit
// pattern stops being linear in the value.)  In [2^52, 2^53) and in
// [2^104, 2^105) a double's bit pattern is its binade's pattern plus the
// integer, so a half is taken out by reinterpretation, with no F2I:
//   bits(lo) = BITS_2P52 + (ab mod 2^52),  bits(hi) = BITS_2P104 + k.
// A column adds the raw patterns, and it starts at minus the sum of its
// halves' binade patterns (f64_mul_bias, mod 2^64), so once its last half
// is in it holds the true sum.  Every floating-point operation is an
// explicit intrinsic (__fma_rz, __fma_rn, __dsub_rn): no FMA contraction
// can change a rounding, and g++ compiles this text through a host shim
// (tests/test_torch_fq_f64_schedule.py).
//
// The product, R' = 2^260, p < 2^254, interleaved as fq.cuh's fe_mul: for
// each limb i, the row a_i b into columns i .. i+5, then m_i = (column i *
// -p^-1) mod 2^52, the row m_i p, and column i's carry into column i + 1.
// m_i p_0's low half is never formed: it is (-column i) mod 2^52, so the
// carry is ceil(column i / 2^52).  The result is (ab + m p) / R' with m =
// sum m_i 2^(52 i) < R', in columns 5 .. 9, normalized to limbs.
//
// Headroom.  Inputs in [0, 2p] give (ab + m p) / R' < 4p^2 / 2^260 + p <
// p / 16 + p < 2p: outputs stay in [0, 2p] with no final subtraction (4p <
// 2^256 < R'), and the top limb is below 2^47.  A column k receives the
// halves of a b from the pairs i + j = k (low) and i + j = k - 1 (high): at
// most 9 (5 + 4), and as many of m p, so at most 18 halves below 2^52 and a
// carry in.  A carry is ceil(column / 2^52) <= 19, so no column exceeds
// F64_COLUMN_BOUND = 18 (2^52 - 1) + 19 < 2^57: no 64-bit column sum can
// overflow.  The square doubles the sums of its 10 cross products (at most
// 4 halves a column) and adds its 5 diagonal ones (at most 1): at most 9
// equivalents, the same bound.
//
// Work a product: 25 + 25 limb products at 3 FP64 operations (m_i p_0 at
// 1), 5 conversions of m_i and 5 of the result's limbs into doubles (OR of
// the binade's pattern, then a dsub_rn of it): 150 FP64 operations; 100
// 64-bit column additions and the m_i, carries and normalization on the
// integer pipe.  The square: 15 limb products, 120 FP64 operations.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; kernel_compare.py --only
// fq_mul_chain): a product in the chain's loop is 150 FP64 instructions
// and 171 integer ones (cuobjdump: 143 on the ALU -- the IADD3 pairs of
// the column sums, LOP3, SHF -- and 28 IMAD), no F2I or I2F; 72 registers.
// The chain runs at 4.30 SM-clocks a product, as the integer route does
// (4.31): 65% of the card's measured FP64 FMA rate (53.9 an SM a clock) and
// ~52% of the ALU's.  At the probe's shape (2^17 lanes, CH = 16) it is 7%
// slower than the integer chain (the boundary, one product and the canon,
// is ~4% of its time); at CH = 256 it ties, and its dedicated square is 5%
// faster.  Warps of both routes in one launch (the probe's route 2) beat
// the integer chain alone by 4-10%.
//
// The chains (svt_fq_mul_chain route 1) read and write the port's words:
// R = 2^256 Montgomery, lazy in [0, 2p].  x R'-multiplied by v = y 2^4 is x
// y 2^-256, the R product itself, so the multiply chain scales its right
// operand once by 2^4 (a product by 2^264 mod p) and runs CH products on
// the words' own values.  The square chain scales its operand by 2^4 (u =
// 2^4 x squares to 2^8 x^2 2^-260 = 2^4 (x^2 2^-256)), runs CH squares and
// scales back by 2^-4 (a product by 2^256 mod p).  Each writes canonical
// words: the integer chain's values after canon.
#pragma once

#include <cstdint>

#ifndef SVT_F64_OBSERVE
// SVT_F64_OBSERVE(k, v): column k's value v, once complete (the g++ test
// defines it to check F64_COLUMN_BOUND).
#define SVT_F64_OBSERVE(k, v)
#endif

namespace svt {

constexpr int F64_LIMBS = 5;
constexpr uint64_t F64_MASK = (1ull << 52) - 1;
constexpr uint64_t F64_BITS_2P52 = 0x4330000000000000ull;   // bits of 2^52
constexpr uint64_t F64_BITS_2P104 = 0x4670000000000000ull;  // bits of 2^104
constexpr double F64_2P52 = 0x1p52;
constexpr double F64_2P104 = 0x1p104;
constexpr double F64_SPLIT = 0x1.0000000000001p104;  // 2^104 + 2^52
constexpr uint64_t F64_PINV = 0x20782e4866389ull;     // -p^-1 mod 2^52
constexpr uint64_t F64_COLUMN_BOUND = 18 * F64_MASK + 19;
static_assert(F64_COLUMN_BOUND < (1ull << 57), "a column fits 64 bits");

__host__ __device__ constexpr uint64_t f64_pick(int i, uint64_t l0, uint64_t l1, uint64_t l2,
                                                uint64_t l3, uint64_t l4) {
  return i == 0 ? l0 : i == 1 ? l1 : i == 2 ? l2 : i == 3 ? l3 : l4;
}
// Constants in 52-bit limbs: F64_P, p; F64_UP4, 2^264 mod p (a product by
// it is x -> 2^4 x); F64_DOWN4, 2^256 mod p (x -> 2^-4 x).
constexpr int F64_P = 0, F64_UP4 = 1, F64_DOWN4 = 2;
__host__ __device__ constexpr uint64_t f64_limb(int which, int i) {
  return which == F64_P ? f64_pick(i, 0x8c16d87cfd47ull, 0x916871ca8d3c2ull, 0x181585d97816aull,
                                   0xa029b85045b68ull, 0x30644e72e131ull)
       : which == F64_UP4 ? f64_pick(i, 0xb0f2afaec667aull, 0xed9626b0fffbdull, 0x9e2a0fcad825aull,
                                     0xe357276f48b70ull, 0xd791464ef86ull)
                          : f64_pick(i, 0xd438dc58f0d9dull, 0x28f5c70b3dd35ull, 0x879462c0a78ebull,
                                     0xdf2f666ea36f7ull, 0xe0a77c19a07ull);
}

// The binade patterns column k's raw halves carry: `lo` low halves and
// `hi` high halves.
__host__ __device__ constexpr uint64_t f64_bias(uint64_t lo, uint64_t hi) {
  return lo * F64_BITS_2P52 + hi * F64_BITS_2P104;
}

// Column k of the product: the low halves of a_i b_j (i + j = k) and of
// m_i p_j (i + j = k, j >= 1: m_i p_0's is never formed), the high halves
// of both (i + j = k - 1).
__host__ __device__ constexpr uint64_t f64_mul_bias(int k) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < F64_LIMBS; i++)
    for (int j = 0; j < F64_LIMBS; j++) {
      if (i + j == k) lo += j >= 1 ? 2 : 1;
      if (i + j + 1 == k) hi += 2;
    }
  return f64_bias(lo, hi);
}

// The square's cross products a_i a_j, i < j (summed, then doubled), and
// after the doubling its diagonal a_i a_i and the rows m_i p as above.
__host__ __device__ constexpr uint64_t f64_cross_bias(int k) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < F64_LIMBS; i++)
    for (int j = i + 1; j < F64_LIMBS; j++) {
      if (i + j == k) lo++;
      if (i + j + 1 == k) hi++;
    }
  return f64_bias(lo, hi);
}
__host__ __device__ constexpr uint64_t f64_sqr_bias(int k) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < F64_LIMBS; i++) {
    if (2 * i == k) lo++;
    if (2 * i + 1 == k) hi++;
    for (int j = 1; j < F64_LIMBS; j++)
      if (i + j == k) lo++;
    for (int j = 0; j < F64_LIMBS; j++)
      if (i + j + 1 == k) hi++;
  }
  return f64_bias(lo, hi);
}

__device__ __forceinline__ uint64_t f64_bits(double x) {
  return (uint64_t)__double_as_longlong(x);
}

// A limb below 2^52 as the exact double: its bits under 2^52's exponent
// are 2^52 + x, less 2^52 (exact).
__device__ __forceinline__ double f64_of(uint64_t x) {
  return __dsub_rn(__longlong_as_double((long long)(x | F64_BITS_2P52)), F64_2P52);
}

__device__ __forceinline__ void f64_from_limbs(double d[F64_LIMBS], const uint64_t l[F64_LIMBS]) {
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) d[i] = f64_of(l[i]);
}

// a b into columns k (low half) and k + 1 (high half), raw patterns.
__device__ __forceinline__ void f64_split_add(uint64_t& lo_col, uint64_t& hi_col, double a,
                                              double b) {
  const double hi = __fma_rz(a, b, F64_2P104);
  const double lo = __fma_rn(a, b, __dsub_rn(F64_SPLIT, hi));
  lo_col += f64_bits(lo);
  hi_col += f64_bits(hi);
}

// Reduction row i: m_i from the complete column i, m_i p into columns i ..
// i + 5, column i's carry into column i + 1.
__device__ __forceinline__ void f64_reduce_row(uint64_t c[2 * F64_LIMBS], int i) {
  SVT_F64_OBSERVE(i, c[i]);
  const double m = f64_of((c[i] * F64_PINV) & F64_MASK);
  c[i + 1] += f64_bits(__fma_rz(m, (double)f64_limb(F64_P, 0), F64_2P104));  // m_i p_0's high half
  c[i + 1] += (c[i] + F64_MASK) >> 52;                                // ceil(column i / 2^52)
#pragma unroll
  for (int j = 1; j < F64_LIMBS; j++) f64_split_add(c[i + j], c[i + j + 1], m, (double)f64_limb(F64_P, j));
}

// Columns 5 .. 9, complete, as normalized limbs.
__device__ __forceinline__ void f64_normalize(uint64_t r[F64_LIMBS], uint64_t c[2 * F64_LIMBS]) {
#pragma unroll
  for (int k = F64_LIMBS; k < 2 * F64_LIMBS; k++) {
    SVT_F64_OBSERVE(k, c[k]);
    if (k + 1 < 2 * F64_LIMBS) c[k + 1] += c[k] >> 52;
    r[k - F64_LIMBS] = k + 1 < 2 * F64_LIMBS ? c[k] & F64_MASK : c[k];
  }
}

// r = a b 2^-260 mod p: (ab + m p) / 2^260 exactly, a, b < 2^260 (in [0,
// 2p]: r in [0, 2p)), r in normalized limbs.
__device__ __forceinline__ void f64_mul(uint64_t r[F64_LIMBS], const double a[F64_LIMBS],
                                        const double b[F64_LIMBS]) {
  uint64_t c[2 * F64_LIMBS];
#pragma unroll
  for (int k = 0; k < 2 * F64_LIMBS; k++) c[k] = 0ull - f64_mul_bias(k);
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) {
#pragma unroll
    for (int j = 0; j < F64_LIMBS; j++) f64_split_add(c[i + j], c[i + j + 1], a[i], b[j]);
    f64_reduce_row(c, i);
  }
  f64_normalize(r, c);
}

// r = a^2 2^-260 mod p, the same value as f64_mul(r, a, a): the 10 cross
// products summed and doubled, then the 5 diagonal ones, then the rows.
__device__ __forceinline__ void f64_sqr(uint64_t r[F64_LIMBS], const double a[F64_LIMBS]) {
  uint64_t c[2 * F64_LIMBS];
#pragma unroll
  for (int k = 0; k < 2 * F64_LIMBS; k++) c[k] = 0ull - f64_cross_bias(k);
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++)
#pragma unroll
    for (int j = i + 1; j < F64_LIMBS; j++) f64_split_add(c[i + j], c[i + j + 1], a[i], a[j]);
#pragma unroll
  for (int k = 0; k < 2 * F64_LIMBS; k++) c[k] = (c[k] << 1) - f64_sqr_bias(k);
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) f64_split_add(c[2 * i], c[2 * i + 1], a[i], a[i]);
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) f64_reduce_row(c, i);
  f64_normalize(r, c);
}

// ---- the port's words at the boundary ----------------------------------

// 8 little-endian 32-bit words (a value below 2^256) -> 52-bit limbs.
__device__ __forceinline__ void f64_limbs_from_words(uint64_t l[F64_LIMBS], const uint32_t w[8]) {
  l[0] = w[0] | (uint64_t)(w[1] & 0xfffffu) << 32;
  l[1] = w[1] >> 20 | (uint64_t)w[2] << 12 | (uint64_t)(w[3] & 0xffu) << 44;
  l[2] = w[3] >> 8 | (uint64_t)(w[4] & 0xfffffffu) << 24;
  l[3] = w[4] >> 28 | (uint64_t)w[5] << 4 | (uint64_t)(w[6] & 0xffffu) << 36;
  l[4] = w[6] >> 16 | (uint64_t)w[7] << 16;
}

// Normalized limbs of a value below 2^256 -> 8 words.
__device__ __forceinline__ void f64_words_from_limbs(uint32_t w[8], const uint64_t l[F64_LIMBS]) {
  w[0] = (uint32_t)l[0];
  w[1] = (uint32_t)(l[0] >> 32) | (uint32_t)l[1] << 20;
  w[2] = (uint32_t)(l[1] >> 12);
  w[3] = (uint32_t)(l[1] >> 44) | (uint32_t)l[2] << 8;
  w[4] = (uint32_t)(l[2] >> 24) | (uint32_t)l[3] << 28;
  w[5] = (uint32_t)(l[3] >> 4);
  w[6] = (uint32_t)(l[3] >> 36) | (uint32_t)l[4] << 16;
  w[7] = (uint32_t)(l[4] >> 16);
}

// l in [0, 2p) -> l mod p, in place (2p -> p).
__device__ __forceinline__ void f64_canon(uint64_t l[F64_LIMBS]) {
  uint64_t d[F64_LIMBS], borrow = 0;
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) {
    const uint64_t t = l[i] - f64_limb(F64_P, i) - borrow;
    borrow = t >> 63;  // limbs are below 2^52: a borrow wraps to the top bit
    d[i] = t & F64_MASK;
  }
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) l[i] = borrow ? l[i] : d[i];
}

// A constant's limbs as doubles.
template <int WHICH>
__device__ __forceinline__ void f64_const(double d[F64_LIMBS]) {
#pragma unroll
  for (int i = 0; i < F64_LIMBS; i++) d[i] = (double)f64_limb(WHICH, i);
}

// out = canon(the R = 2^256 Montgomery product chain x <- x y, ch steps),
// x, y the port's lazy words.
__device__ __forceinline__ void f64_mul_chain(uint32_t out[8], const uint32_t x[8],
                                              const uint32_t y[8], int ch) {
  uint64_t xl[F64_LIMBS], vl[F64_LIMBS];
  double xd[F64_LIMBS], v[F64_LIMBS], k[F64_LIMBS];
  f64_limbs_from_words(vl, y);
  f64_from_limbs(xd, vl);
  f64_const<F64_UP4>(k);
  f64_mul(vl, xd, k);  // v = 2^4 y
  f64_from_limbs(v, vl);
  f64_limbs_from_words(xl, x);
#pragma unroll 1
  for (int s = 0; s < ch; s++) {
    f64_from_limbs(xd, xl);
    f64_mul(xl, xd, v);
  }
  if (ch == 0) f64_canon(xl);  // x itself, up to 2p: 2p -> p, then p -> 0 below
  f64_canon(xl);
  f64_words_from_limbs(out, xl);
}

// out = canon(x <- x^2, ch steps), x the port's lazy words.  DEDICATED: the
// square's 15 products (f64_sqr), else f64_mul(x, x).
template <bool DEDICATED>
__device__ __forceinline__ void f64_sqr_chain(uint32_t out[8], const uint32_t x[8], int ch) {
  uint64_t xl[F64_LIMBS];
  double xd[F64_LIMBS], k[F64_LIMBS];
  f64_limbs_from_words(xl, x);
  f64_from_limbs(xd, xl);
  f64_const<F64_UP4>(k);
  f64_mul(xl, xd, k);  // u = 2^4 x
#pragma unroll 1
  for (int s = 0; s < ch; s++) {
    f64_from_limbs(xd, xl);
    if constexpr (DEDICATED) {
      f64_sqr(xl, xd);
    } else {
      f64_mul(xl, xd, xd);
    }
  }
  f64_from_limbs(xd, xl);
  f64_const<F64_DOWN4>(k);
  f64_mul(xl, xd, k);  // 2^-4 u
  f64_canon(xl);
  f64_words_from_limbs(out, xl);
}

}  // namespace svt
