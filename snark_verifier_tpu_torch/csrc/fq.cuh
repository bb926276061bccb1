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
// Cost model, for the kernels' bound: one fe_mul is CIOS with 8x8 a*b word
// products, 8 reduction digits and 8x8 m*p products = 136 32x32->64
// multiply-adds.  Integer Montgomery arithmetic has no tensor-core (wgmma)
// path -- the tensor cores take bf16/fp16/fp8/int8 -- so it runs on the SMs'
// integer pipes.  fe_add / fe_sub are carry chains with no multiplies.
#pragma once

#include <cstdint>

namespace svt {

constexpr int FQ_WORDS = 8;  // 32-bit words per element, either field

// Field tags: template arguments of every fe_* function and the `field`
// argument of the C entry points (ff/word_field.py passes the same values).
constexpr int FQ = 0;
constexpr int FR = 1;

static __constant__ uint32_t FIELD_P[2][FQ_WORDS] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
static __constant__ uint32_t FIELD_P2[2][FQ_WORDS] = {  // 2p
    {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
     0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
    {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
     0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u}};
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

__device__ __forceinline__ void fe_copy(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r[i] = a[i];
}

// r = s - m if s >= m, else s (m a constant modulus row).
__device__ __forceinline__ void fe_cond_sub(uint32_t r[FQ_WORDS], const uint32_t s[FQ_WORDS],
                                            const uint32_t m[FQ_WORDS]) {
  uint32_t d[FQ_WORDS];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t t = (uint64_t)s[i] - m[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r[i] = borrow ? s[i] : d[i];
}

// r = a + b mod 2p (a + b <= 4p < 2^256: no carry out).  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_add(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  uint32_t s[FQ_WORDS];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t t = (uint64_t)a[i] + b[i] + c;
    s[i] = (uint32_t)t;
    c = t >> 32;
  }
  fe_cond_sub(r, s, FIELD_P2[F]);
}

// r = a - b, plus 2p (mod 2^256) when it borrows.  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_sub(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  uint32_t d[FQ_WORDS];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t t = (uint64_t)d[i] + (borrow ? FIELD_P2[F][i] : 0u) + c;
    r[i] = (uint32_t)t;
    c = t >> 32;
  }
}

// r = 2p - a, in [0, 2p] (no reduction, as LimbField.neg).  r may alias a.
template <int F>
__device__ __forceinline__ void fe_neg(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t t = (uint64_t)FIELD_P2[F][i] - a[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
}

// The canonical representative in [0, p) of a value in [0, 2p].
template <int F>
__device__ __forceinline__ void fe_canon(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS]) {
  fe_cond_sub(r, a, FIELD_P2[F]);
  fe_cond_sub(r, r, FIELD_P[F]);
}

// r = a*b*R^-1 (CIOS Montgomery, 32-bit words, 64-bit partial products).
// Inputs in [0, 2p], output in [0, 2p].  r may alias a or b.
template <int F>
__device__ __forceinline__ void fe_mul(uint32_t r[FQ_WORDS], const uint32_t a[FQ_WORDS],
                                       const uint32_t b[FQ_WORDS]) {
  const uint32_t* P = FIELD_P[F];
  uint32_t t[FQ_WORDS + 2];
#pragma unroll
  for (int j = 0; j < FQ_WORDS + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < FQ_WORDS; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FQ_WORDS] + c;
    t[FQ_WORDS] = (uint32_t)s;
    t[FQ_WORDS + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * fe_pinv<F>();
    s = (uint64_t)m * P[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FQ_WORDS; j++) {
      s = (uint64_t)m * P[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FQ_WORDS] + c;
    t[FQ_WORDS - 1] = (uint32_t)s;
    t[FQ_WORDS] = t[FQ_WORDS + 1] + (uint32_t)(s >> 32);
  }
  fe_copy(r, t);
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
    fe_mul<F>(acc, acc, acc);
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
