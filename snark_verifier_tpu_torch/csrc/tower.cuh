// BN254 extension-field towers on the GPU, over fq.cuh's Fq words:
//   Fq2  = Fq[u]/(u^2 + 1)            c0 + c1 u
//   Fq6  = Fq2[v]/(v^3 - xi), xi = 9+u  c0 + c1 v + c2 v^2
//   Fq12 = Fq6[w]/(w^2 - v)           c0 + c1 w
// An Fq12 is 96 words in the (2, 3, 2, 8) order of tower/encode.py: its six
// Fq2 coordinates (c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2) one after the
// other.
//
// Every function is the formula of tower/tower.py (the JAX package's
// tower/tower.py), op for op on fe_add / fe_sub / fe_neg / fe_mul, so each
// keeps fq.cuh's lazy [0, 2p] contract: every fe_mul input is an output of
// one of those four, all of which stay in [0, 2p].
//
// Code size.  An Fq12 product is 54 Fq multiplies, ~300 instructions each.
// Inlined everywhere, the pairing kernels would be hundreds of thousands of
// instructions and nvcc would take minutes; so the Fq2 product and every
// function above it are __noinline__ calls on values in local memory, and
// only the Fq multiplies inside an Fq2 product (three independent ones)
// are inlined.  A call moves 48 words through the L1-cached local memory
// against ~900 instructions of arithmetic.
#pragma once

#include "fq.cuh"

namespace svt {

struct Fq2 {
  uint32_t c[2][FQ_WORDS];
};
struct Fq6 {
  Fq2 c[3];
};
struct Fq12 {
  Fq6 c[2];
};
constexpr int FQ12_WORDS = 12 * FQ_WORDS;

// ---- Fq2 ------------------------------------------------------------------

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

// a * xi = (9 a0 - a1, a0 + 9 a1), 9x by LimbField.mul_small's chain.  r may
// alias a.
__device__ __forceinline__ void fq2_mul_xi(Fq2& r, const Fq2& a) {
  uint32_t n0[FQ_WORDS], n1[FQ_WORDS];
  fq_mul9(n0, a.c[0]);
  fq_mul9(n1, a.c[1]);
  fe_sub<FQ>(n0, n0, a.c[1]);
  fe_add<FQ>(r.c[1], a.c[0], n1);
  fe_copy(r.c[0], n0);
}

// Karatsuba: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// r = (t0 - t1, t2 - (t0 + t1)).  r may alias a or b.
__device__ __noinline__ void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
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

// Both components times an Fq element s.  r may alias a.
__device__ __forceinline__ void fq2_smul(Fq2& r, const Fq2& a, const uint32_t s[FQ_WORDS]) {
  fe_mul<FQ>(r.c[0], a.c[0], s);
  fe_mul<FQ>(r.c[1], a.c[1], s);
}

// 1/a = (a0 d, -a1 d), d = 1/(a0^2 + a1^2) (0 maps to 0).  r may alias a.
__device__ __noinline__ void fq2_inv(Fq2& r, const Fq2& a) {
  uint32_t m0[FQ_WORDS], m1[FQ_WORDS], d[FQ_WORDS];
  fe_mul<FQ>(m0, a.c[0], a.c[0]);
  fe_mul<FQ>(m1, a.c[1], a.c[1]);
  fe_add<FQ>(m0, m0, m1);
  fe_inv<FQ>(d, m0);
  fe_neg<FQ>(m1, a.c[1]);
  fe_mul<FQ>(r.c[0], a.c[0], d);
  fe_mul<FQ>(r.c[1], m1, d);
}

// ---- Fq6 ------------------------------------------------------------------

__device__ __forceinline__ void fq6_add(Fq6& r, const Fq6& a, const Fq6& b) {
#pragma unroll
  for (int j = 0; j < 3; j++) fq2_add(r.c[j], a.c[j], b.c[j]);
}

__device__ __forceinline__ void fq6_sub(Fq6& r, const Fq6& a, const Fq6& b) {
#pragma unroll
  for (int j = 0; j < 3; j++) fq2_sub(r.c[j], a.c[j], b.c[j]);
}

__device__ __forceinline__ void fq6_neg(Fq6& r, const Fq6& a) {
#pragma unroll
  for (int j = 0; j < 3; j++) fq2_neg(r.c[j], a.c[j]);
}

// a * v = (xi a2, a0, a1).  r may alias a.
__device__ __forceinline__ void fq6_mul_by_v(Fq6& r, const Fq6& a) {
  Fq2 t;
  fq2_mul_xi(t, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// Toom-style: six Fq2 products t0, t1, t2, s12, s01, s02, then
// c0 = t0 + xi (s12 - (t1 + t2)), c1 = (s01 - (t0 + t1)) + xi t2,
// c2 = (s02 - (t0 + t2)) + t1.  r may alias a or b.
__device__ __noinline__ void fq6_mul(Fq6& r, const Fq6& a, const Fq6& b) {
  Fq2 t0, t1, t2, s12, s01, s02, u, v;
  fq2_add(u, a.c[1], a.c[2]);
  fq2_add(v, b.c[1], b.c[2]);
  fq2_mul(s12, u, v);
  fq2_add(u, a.c[0], a.c[1]);
  fq2_add(v, b.c[0], b.c[1]);
  fq2_mul(s01, u, v);
  fq2_add(u, a.c[0], a.c[2]);
  fq2_add(v, b.c[0], b.c[2]);
  fq2_mul(s02, u, v);
  fq2_mul(t0, a.c[0], b.c[0]);
  fq2_mul(t1, a.c[1], b.c[1]);
  fq2_mul(t2, a.c[2], b.c[2]);
  fq2_add(u, t1, t2);
  fq2_sub(u, s12, u);
  fq2_mul_xi(u, u);
  fq2_add(r.c[0], t0, u);
  fq2_add(u, t0, t1);
  fq2_sub(u, s01, u);
  fq2_mul_xi(v, t2);
  fq2_add(r.c[1], u, v);
  fq2_add(u, t0, t2);
  fq2_sub(u, s02, u);
  fq2_add(r.c[2], u, t1);
}

// 1/a by the norm to Fq2.  r may alias a.
__device__ __noinline__ void fq6_inv(Fq6& r, const Fq6& a) {
  Fq2 s0, s1, s2, m0, m1, m2, c0, c1, c2, t;
  fq2_mul(s0, a.c[0], a.c[0]);
  fq2_mul(s1, a.c[1], a.c[1]);
  fq2_mul(s2, a.c[2], a.c[2]);
  fq2_mul(m0, a.c[1], a.c[2]);
  fq2_mul(m1, a.c[0], a.c[1]);
  fq2_mul(m2, a.c[0], a.c[2]);
  fq2_mul_xi(m0, m0);
  fq2_sub(c0, s0, m0);  // a0^2 - xi a1 a2
  fq2_mul_xi(s2, s2);
  fq2_sub(c1, s2, m1);  // xi a2^2 - a0 a1
  fq2_sub(c2, s1, m2);  // a1^2 - a0 a2
  fq2_mul(m0, a.c[2], c1);
  fq2_mul(m1, a.c[1], c2);
  fq2_mul(m2, a.c[0], c0);
  fq2_add(t, m0, m1);
  fq2_mul_xi(t, t);
  fq2_add(t, t, m2);
  fq2_inv(t, t);
  fq2_mul(r.c[0], c0, t);
  fq2_mul(r.c[1], c1, t);
  fq2_mul(r.c[2], c2, t);
}

// ---- Fq12 -----------------------------------------------------------------

__device__ __forceinline__ void fq12_one(Fq12& r) {
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int j = 0; j < 3; j++) fq2_zero(r.c[i].c[j]);
  fe_copy(r.c[0].c[0].c[0], FIELD_ONE[FQ]);
}

// (c0, -c1).  r may alias a.
__device__ __forceinline__ void fq12_conj(Fq12& r, const Fq12& a) {
  r.c[0] = a.c[0];
  fq6_neg(r.c[1], a.c[1]);
}

// Karatsuba over Fq6: t0 = a0 b0, t1 = a1 b1, t2 = (a0 + a1)(b0 + b1);
// c0 = t0 + v t1, c1 = t2 - (t0 + t1).  r may alias a or b: every read of
// a and b comes before the first write of r.
__device__ __noinline__ void fq12_mul(Fq12& r, const Fq12& a, const Fq12& b) {
  Fq6 t0, t1, t2, u, v;
  fq6_add(u, a.c[0], a.c[1]);
  fq6_add(v, b.c[0], b.c[1]);
  fq6_mul(t0, a.c[0], b.c[0]);
  fq6_mul(t1, a.c[1], b.c[1]);
  fq6_mul(t2, u, v);
  fq6_add(u, t0, t1);
  fq6_sub(r.c[1], t2, u);
  fq6_mul_by_v(t1, t1);
  fq6_add(r.c[0], t0, t1);
}

// 1/a = (a0 t, -a1 t), t = 1/(a0^2 - v a1^2) (0 maps to 0).  r may alias a.
__device__ __noinline__ void fq12_inv(Fq12& r, const Fq12& a) {
  Fq6 s0, s1, n;
  fq6_mul(s0, a.c[0], a.c[0]);
  fq6_mul(s1, a.c[1], a.c[1]);
  fq6_mul_by_v(s1, s1);
  fq6_sub(s0, s0, s1);
  fq6_inv(s0, s0);
  fq6_neg(n, a.c[1]);
  fq6_mul(r.c[0], a.c[0], s0);
  fq6_mul(r.c[1], n, s0);
}

// f * (c0 + c3 w + c4 v w): the generic product on the sparse operand
// ((c0, 0, 0), (c3, c4, 0)), as tower.py's mul_by_034.  r may alias f.
__device__ __forceinline__ void fq12_mul_by_034(Fq12& r, const Fq12& f, const Fq2& c0,
                                                const Fq2& c3, const Fq2& c4) {
  Fq12 l;
  l.c[0].c[0] = c0;
  fq2_zero(l.c[0].c[1]);
  fq2_zero(l.c[0].c[2]);
  l.c[1].c[0] = c3;
  l.c[1].c[1] = c4;
  fq2_zero(l.c[1].c[2]);
  fq12_mul(r, f, l);
}

// The frobenius transform of the final-exponentiation tape: each of the
// six Fq2 coordinates conjugated (odd powers) and times its coefficient
// coef[j] (coordinate 0's is 1 and is skipped).  The same field element as
// pairing.py::f12_frobenius, which multiplies the w part twice.  r must not
// alias a.
__device__ __forceinline__ void fq12_frob(Fq12& r, const Fq12& a, bool conj,
                                          const uint32_t (*coef)[2][FQ_WORDS]) {
  const Fq2* x = &a.c[0].c[0];
  Fq2* y = &r.c[0].c[0];
#pragma unroll 1
  for (int j = 0; j < 6; j++) {
    Fq2 t;
    if (conj)
      fq2_conj(t, x[j]);
    else
      t = x[j];
    if (j == 0) {
      y[0] = t;
    } else {
      Fq2 k;
      fe_copy(k.c[0], coef[j][0]);
      fe_copy(k.c[1], coef[j][1]);
      fq2_mul(y[j], t, k);
    }
  }
}

__device__ __forceinline__ void fq12_load(Fq12& r, const uint32_t* __restrict__ src) {
  uint32_t* d = &r.c[0].c[0].c[0][0];
#pragma unroll
  for (int i = 0; i < FQ12_WORDS; i += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i);
    d[i] = v.x;
    d[i + 1] = v.y;
    d[i + 2] = v.z;
    d[i + 3] = v.w;
  }
}

__device__ __forceinline__ void fq12_store(uint32_t* __restrict__ dst, const Fq12& a) {
  const uint32_t* s = &a.c[0].c[0].c[0][0];
#pragma unroll
  for (int i = 0; i < FQ12_WORDS; i += 4)
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(s[i], s[i + 1], s[i + 2], s[i + 3]);
}

}  // namespace svt
