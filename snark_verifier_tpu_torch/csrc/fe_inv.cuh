// The inversion of svt_field_inv (field_kernels.cu): a variable-time binary
// extended GCD on 32-bit words, after Pornin, "Optimized Binary GCD for
// Modular Inversion" (2020).  No inline PTX, so that g++ compiles this very
// text: tests/test_torch_inv_schedule.py runs it against python ints and the
// JAX package's LimbField.inv.
//
// Why binary GCD.  Fermat (fq.cuh::fe_inv) is ~370 dependent Montgomery
// products, ~805 clocks each for a lone warp: ~0.15 ms whatever the batch.
// The verifier's inversions here take public values (coordinates of
// accumulators it folds), so a variable-time algorithm is allowed, and a
// binary GCD is a chain of cheap integer instructions instead: ~12 rounds
// (17 at most, see below) of 30 steps on 62-bit approximations of the two
// values, then one 2x2 update of the 256-bit values by signed factors of
// at most 2^30.  Bernstein-Yang divsteps would do the same work in a less
// direct form; Pornin's steps keep a and b non-negative and need no modular
// halving, and the division by 2^30 that the update owes is folded into a
// one-digit Montgomery reduction, so no power of 2 is left to undo at the end.
//
// The state: a, b >= 0 with b odd, and u, v in [0, p), with
//     c a = y u,  c b = y v  (mod p),     c = R^2 mod p,
// from a = y (the input reduced mod p), b = p, u = c, v = 0.  Each round
// keeps both equations; when a reaches 0, b = gcd(y, p) = 1, so v = c / y.
// For a Montgomery input x = A R, y = x mod p and v = R^2 / (A R) = A^-1 R:
// the Montgomery form of the inverse, canonical in [0, p), with no final
// product.  y = 0 leaves the loop at once and returns 0, as LimbField.inv.
//
// A round (Pornin's Algorithm 2 with k = 31): n = max(len a, len b, 62);
// a~ = (a mod 2^30) + 2^30 floor(a / 2^(n-32)), the same for b~ (exact once
// both values fit 62 bits).  30 steps on (a~, b~): if a~ is odd, swap when
// a~ < b~ and subtract; halve a~.  The factors (f0, g0; f1, g1) track them,
// each row packed into one 64-bit word f + 2^32 g (|f|, |g| <= 2^30, so a
// step's row subtraction and doubling are one 64-bit operation each):
// a' = (f0 a + g0 b) / 2^30, b' = (f1 a + g1 b) / 2^30, exact divisions
// since the low 30 bits are exact.  A comparison made on the approximations
// may be wrong, so a' or b' can come out negative: negate it with its row.
// Then u' = (f0 u + g0 v) / 2^30 mod p, v' likewise.  |f| + |g| <= 2^30 in
// each row, so every word product plus its carry fits a signed 64-bit sum.
// (Against 31 steps on 64-bit approximations with the four factors apart,
// this form measured 4-11% faster on an NVIDIA H100 80GB HBM3 at 700 W,
// kernel_compare.py.)
//
// Rounds: Pornin bounds them by ceil((2 len(p) - 1) / 30) = 17 for the
// 254-bit BN254 moduli; this loop stops as soon as a = 0 (~12 rounds on
// random inputs, measured in the test), and INV_MAX_ROUNDS only guards a
// thread against a loop that would not end.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define SVT_INV_FN __host__ __device__ __forceinline__
#else
#define SVT_INV_FN inline
#endif

namespace svt {

constexpr int INV_WORDS = 8;
constexpr int INV_STEPS = 30;  // steps a round (Pornin's k - 1)
constexpr int INV_MAX_ROUNDS = 64;

SVT_INV_FN constexpr uint32_t inv_pick(int k, uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                       uint32_t w4, uint32_t w5, uint32_t w6, uint32_t w7) {
  return k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : k == 3 ? w3 : k == 4 ? w4 : k == 5 ? w5
       : k == 6 ? w6 : w7;
}

// F is fq.cuh's field tag: 0 = Fq, 1 = Fr.  Word k of p (fq.cuh's fe_p).
template <int F>
SVT_INV_FN constexpr uint32_t inv_p(int k) {
  return F == 0 ? inv_pick(k, 0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u)
                : inv_pick(k, 0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u);
}

// Word k of R^2 mod p, u's start.
template <int F>
SVT_INV_FN constexpr uint32_t inv_r2(int k) {
  return F == 0 ? inv_pick(k, 0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
                           0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u)
                : inv_pick(k, 0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                           0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u);
}

// -p^-1 mod 2^30: the digit of the division by 2^30.
template <int F>
SVT_INV_FN constexpr uint32_t inv_pinv30() {
  return F == 0 ? 0x24866389u : 0x2fffffffu;
}

SVT_INV_FN int inv_clz(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __clz(x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

SVT_INV_FN bool inv_is_zero(const uint32_t a[INV_WORDS]) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) o |= a[k];
  return o == 0;
}

SVT_INV_FN int inv_bit_length(const uint32_t a[INV_WORDS]) {
  int n = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) n = a[k] ? 32 * k + 32 - inv_clz(a[k]) : n;
  return n;
}

// r = s - p if s >= p, else s.  r may alias s.
template <int F>
SVT_INV_FN void inv_reduce(uint32_t r[INV_WORDS], const uint32_t s[INV_WORDS]) {
  uint32_t d[INV_WORDS];
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    c += (int64_t)s[k] - inv_p<F>(k);
    d[k] = (uint32_t)c;
    c >>= 32;
  }
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) r[k] = c < 0 ? s[k] : d[k];
}

// a~: a's 32 bits from bit s (30 <= s <= 222) above its bits 0..29.  Each
// word's share is shifted into place by a computed amount: selecting words
// by a computed index would put a in local memory.
SVT_INV_FN uint64_t inv_approx(const uint32_t a[INV_WORDS], int s) {
  uint64_t top = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    const int d = 32 * k - s;  // where bit 0 of word k lands in `top`
    top |= d >= 32 || d <= -32 ? 0 : d >= 0 ? (uint64_t)a[k] << d : (uint64_t)(a[k] >> -d);
  }
  return ((top & 0xffffffffull) << 30) | (a[0] & 0x3fffffffu);
}

// t = f a + g b as a signed 9-word value, then |t| in t; returns t < 0.
// |f| + |g| <= 2^30, so each column's sum stays inside a signed 64-bit word.
SVT_INV_FN bool inv_comb(uint32_t t[INV_WORDS + 1], const uint32_t a[INV_WORDS],
                         const uint32_t b[INV_WORDS], int64_t f, int64_t g) {
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    c += (int64_t)a[k] * f + (int64_t)b[k] * g;
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  t[INV_WORDS] = (uint32_t)c;
  const bool neg = c < 0;
  uint64_t n = neg ? 1 : 0;  // two's complement negation where negative
#pragma unroll
  for (int k = 0; k <= INV_WORDS; k++) {
    n += neg ? (uint32_t)~t[k] : t[k];
    t[k] = (uint32_t)n;
    n >>= 32;
  }
  return neg;
}

// r = t / 2^30 (t has 9 words, r takes 8: the caller knows it fits).
SVT_INV_FN void inv_shift30(uint32_t r[INV_WORDS], const uint32_t t[INV_WORDS + 1]) {
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) r[k] = (t[k] >> 30) | (t[k + 1] << 2);
}

// r = (f u + g v) / 2^30 mod p in [0, p), for u, v in [0, p): |f u + g v|
// < 2^30 p, plus m p with m = -t p^-1 mod 2^30 < 2^30, over 2^30 is below 2p.
template <int F>
SVT_INV_FN void inv_comb_mod(uint32_t r[INV_WORDS], const uint32_t u[INV_WORDS],
                             const uint32_t v[INV_WORDS], int64_t f, int64_t g) {
  uint32_t t[INV_WORDS + 1];
  const bool neg = inv_comb(t, u, v, f, g);
  const uint32_t m = (t[0] * inv_pinv30<F>()) & 0x3fffffffu;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    c += (uint64_t)m * inv_p<F>(k) + t[k];
    t[k] = (uint32_t)c;
    c >>= 32;
  }
  t[INV_WORDS] += (uint32_t)c;
  inv_shift30(r, t);
  inv_reduce<F>(r, r);
  // a negative sum: p - r, except for r = 0
  const bool flip = neg && !inv_is_zero(r);
  int64_t d = 0;
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    d += (int64_t)inv_p<F>(k) - r[k];
    r[k] = flip ? (uint32_t)d : r[k];
    d >>= 32;
  }
}

// r = the canonical Montgomery inverse of x (x = A R in [0, 2p] -> A^-1 R in
// [0, p); 0 -> 0).  Returns the rounds it took.  r may alias x.
template <int F>
SVT_INV_FN int fe_inv_gcd(uint32_t r[INV_WORDS], const uint32_t x[INV_WORDS]) {
  uint32_t a[INV_WORDS], b[INV_WORDS], u[INV_WORDS], v[INV_WORDS];
  inv_reduce<F>(a, x);
  inv_reduce<F>(a, a);  // x = 2p
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) {
    b[k] = inv_p<F>(k);
    u[k] = inv_r2<F>(k);
    v[k] = 0;
  }
  int rounds = 0;
#pragma unroll 1
  while (!inv_is_zero(a) && rounds < INV_MAX_ROUNDS) {
    rounds++;
    const int la = inv_bit_length(a), lb = inv_bit_length(b);
    const int n = la > lb ? (la > 62 ? la : 62) : (lb > 62 ? lb : 62);
    uint64_t xa = inv_approx(a, n - 32), xb = inv_approx(b, n - 32);
    int64_t r0 = 1, r1 = 1ll << 32;  // rows packed: f + 2^32 g
#pragma unroll 1
    for (int j = 0; j < INV_STEPS; j++) {
      const bool odd = xa & 1;
      const bool swap = odd && xa < xb;
      const uint64_t ta = swap ? xb : xa, tb = swap ? xa : xb;
      const int64_t t0 = swap ? r1 : r0;
      r1 = swap ? r0 : r1;
      xa = (odd ? ta - tb : ta) >> 1;
      xb = tb;
      r0 = odd ? t0 - r1 : t0;
      r1 += r1;
    }
    int64_t f0 = (int32_t)(uint32_t)r0, f1 = (int32_t)(uint32_t)r1;
    int64_t g0 = (r0 - f0) >> 32, g1 = (r1 - f1) >> 32;
    uint32_t t[INV_WORDS + 1];
    if (inv_comb(t, a, b, f0, g0)) {
      f0 = -f0;
      g0 = -g0;
    }
    uint32_t na[INV_WORDS];
    inv_shift30(na, t);
    if (inv_comb(t, a, b, f1, g1)) {
      f1 = -f1;
      g1 = -g1;
    }
    inv_shift30(b, t);
#pragma unroll
    for (int k = 0; k < INV_WORDS; k++) a[k] = na[k];
    uint32_t nu[INV_WORDS];
    inv_comb_mod<F>(nu, u, v, f0, g0);
    inv_comb_mod<F>(v, u, v, f1, g1);
#pragma unroll
    for (int k = 0; k < INV_WORDS; k++) u[k] = nu[k];
  }
#pragma unroll
  for (int k = 0; k < INV_WORDS; k++) r[k] = v[k];
  return rounds;
}

}  // namespace svt
