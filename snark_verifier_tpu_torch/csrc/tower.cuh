// BN254's Fq2 = Fq[u]/(u^2 + 1) on one lane, over fq.cuh's Fq words: the
// operations a lane of a pairing team runs (tower_team.cuh builds Fq6 and
// Fq12 from them).  Every function is the formula of tower/tower.py's
// Fq2Field, op for op on fe_add / fe_sub / fe_neg / fe_mul, so each keeps
// fq.cuh's lazy [0, 2p] contract: every fe_mul input is an output of one of
// those four, all of which stay in [0, 2p].  All of it is inlined.
#pragma once

#include "fq.cuh"

namespace svt {

// c0 + c1 u; 16-byte aligned so that a copy to or from shared memory is
// four 128-bit moves.
struct alignas(16) Fq2 {
  uint32_t c[2][FQ_WORDS];
};
constexpr int FQ12_WORDS = 12 * FQ_WORDS;

__device__ __forceinline__ void fq2_add(Fq2& r, const Fq2& a, const Fq2& b) {
  fe_add<FQ>(r.c[0], a.c[0], b.c[0]);
  fe_add<FQ>(r.c[1], a.c[1], b.c[1]);
}

__device__ __forceinline__ void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  fe_sub<FQ>(r.c[0], a.c[0], b.c[0]);
  fe_sub<FQ>(r.c[1], a.c[1], b.c[1]);
}

__device__ __forceinline__ void fq2_neg(Fq2& r, const Fq2& a) {
  fe_neg<FQ>(r.c[0], a.c[0]);
  fe_neg<FQ>(r.c[1], a.c[1]);
}

// (c0, -c1).  r may alias a.
__device__ __forceinline__ void fq2_conj(Fq2& r, const Fq2& a) {
  fe_copy(r.c[0], a.c[0]);
  fe_neg<FQ>(r.c[1], a.c[1]);
}

__device__ __forceinline__ void fq2_zero(Fq2& r) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r.c[0][i] = r.c[1][i] = 0;
}

__device__ __forceinline__ void fq2_one(Fq2& r) {
  fq2_zero(r);
  fe_copy(r.c[0], FIELD_ONE[FQ]);
}

// r = 9a + b, or 9a + (2p - b) with `minus` (= 9a - b mod p), in [0, 2p]
// for a, b in [0, 2p]: v = 9a + b' < 20p < 2^258 in one carry chain, then
// one reduction v - q p with q = floor(v_hi / (p_hi + 1)) from v's top 64
// bits (q underestimates v / p by less than 2^-20, so it is floor(v / p)
// or one less and the result lies in [0, 2p)).  One reduction where
// fq.cuh's fq_mul9 and an add make five: x xi sits on the combine stages'
// critical path.  Portable C++ (64-bit columns): the g++ schedule twin
// compiles it as it is.
__device__ __forceinline__ void fq_nine_plus(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                             const uint32_t b[FQ_WORDS], bool minus) {
  uint32_t bb[FQ_WORDS], v[FQ_WORDS + 1];
  if (minus)
    fe_neg<FQ>(bb, b);
  else
    fe_copy(bb, b);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    c += (uint64_t)a[i] * 9u + bb[i];
    v[i] = (uint32_t)c;
    c >>= 32;
  }
  v[FQ_WORDS] = (uint32_t)c;
  const uint64_t top = ((uint64_t)v[FQ_WORDS] << 32) | v[FQ_WORDS - 1];
  const uint64_t q = top / ((uint64_t)fe_p<FQ>(FQ_WORDS - 1) + 1);
  uint64_t m = 0;
  int64_t d = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {  // r = v - q p
    m += q * fe_p<FQ>(i);
    d += (int64_t)v[i] - (int64_t)(uint32_t)m;
    r[i] = (uint32_t)d;
    d >>= 32;  // 0 or -1: the borrow
    m >>= 32;
  }
}

// Component c (0 or 1) of a lane's Fq2 value: selects, so that a runtime c
// indexes no register array (which would go to local memory).
__device__ __forceinline__ void fq2_part(uint32_t r[FQ_WORDS], const Fq2& a, int c) {
#pragma unroll
  for (int w = 0; w < FQ_WORDS; w++) r[w] = c ? a.c[1][w] : a.c[0][w];
}

// Component c of a * xi: 9 a0 - a1 (c = 0) or 9 a1 + a0 (c = 1).
__device__ __forceinline__ void fq2_mul_xi_part(uint32_t r[FQ_WORDS], const Fq2& a, int c) {
  uint32_t x[FQ_WORDS], y[FQ_WORDS];
  fq2_part(x, a, c);
  fq2_part(y, a, 1 - c);
  fq_nine_plus(r, x, y, c == 0);
}

// a * xi = (9 a0 - a1, a0 + 9 a1).  r may alias a.
__device__ __forceinline__ void fq2_mul_xi(Fq2& r, const Fq2& a) {
  uint32_t n0[FQ_WORDS];
  fq_nine_plus(n0, a.c[0], a.c[1], true);
  fq_nine_plus(r.c[1], a.c[1], a.c[0], false);
  fe_copy(r.c[0], n0);
}

// Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// r = (t0 - t1, t2 - (t0 + t1)).  Three independent Fq multiplies, yet one
// after another: each is a run of statements chained through the one
// carry flag and a warp issues in order, so a lane waits out three
// multiply latencies (csrc/probe/team_levels.cu measures it; interleaving
// the three products' statements did not shorten it: only other warps fill
// the stalls).  r may alias a or b.
__device__ __forceinline__ void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  uint32_t sa[FQ_WORDS], sb[FQ_WORDS], t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS];
  fe_add<FQ>(sa, a.c[0], a.c[1]);
  fe_add<FQ>(sb, b.c[0], b.c[1]);
  fe_mul<FQ>(t0, a.c[0], b.c[0]);
  fe_mul<FQ>(t1, a.c[1], b.c[1]);
  fe_mul<FQ>(t2, sa, sb);
  fe_sub<FQ>(r.c[0], t0, t1);
  fe_add<FQ>(sa, t0, t1);
  fe_sub<FQ>(r.c[1], t2, sa);
}

// a^2 = ((a0 + a1)(a0 - a1), 2 a0 a1): two Fq multiplies, as
// Fq2Field.square.  r may alias a.
__device__ __forceinline__ void fq2_sqr(Fq2& r, const Fq2& a) {
  uint32_t s[FQ_WORDS], d[FQ_WORDS], m[FQ_WORDS];
  fe_add<FQ>(s, a.c[0], a.c[1]);
  fe_sub<FQ>(d, a.c[0], a.c[1]);
  fe_mul<FQ>(m, a.c[0], a.c[1]);
  fe_mul<FQ>(r.c[0], s, d);
  fe_add<FQ>(r.c[1], m, m);
}

// 1/a = (a0 d, -a1 d), d = 1/(a0^2 + a1^2) (0 maps to 0).  r may alias a.
__device__ __forceinline__ void fq2_inv(Fq2& r, const Fq2& a) {
  uint32_t m0[FQ_WORDS], m1[FQ_WORDS], d[FQ_WORDS];
  fe_mul<FQ>(m0, a.c[0], a.c[0]);
  fe_mul<FQ>(m1, a.c[1], a.c[1]);
  fe_add<FQ>(m0, m0, m1);
  fe_inv<FQ>(d, m0);
  fe_neg<FQ>(m1, a.c[1]);
  fe_mul<FQ>(r.c[0], a.c[0], d);
  fe_mul<FQ>(r.c[1], m1, d);
}

}  // namespace svt
