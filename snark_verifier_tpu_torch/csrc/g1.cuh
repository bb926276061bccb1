// BN254 G1 group law on the GPU: homogeneous projective (X : Y : Z) over Fq
// (fq.cuh, field tag FQ), infinity (0 : 1 : 0).  The Renes-Costello 2015 complete
// formulas (alg. 7 add, alg. 9 double, a = 0, 3b = 9) with the same field
// ops in the same order as ec/curve.py, so results equal the plain twin's
// bit for bit.  Complete: no branch for P == Q, P == -Q or the identity.
//
// Per add: 12 fq_mul = 12 * 136 = 1632 32x32->64 multiply-adds, plus 18
// add/sub carry chains.  Per double: 8 fq_mul = 1088 multiply-adds (two of
// them squares, which issue 108 of their 136).
#pragma once

#include "fq.cuh"

namespace svt {

constexpr int G1_WORDS = 3 * FQ_WORDS;  // 24 words = 96 bytes per point

struct G1 {
  uint32_t x[FQ_WORDS], y[FQ_WORDS], z[FQ_WORDS];
};

__device__ __forceinline__ void g1_identity(G1& p) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    p.x[i] = 0u;
    p.y[i] = FIELD_ONE[FQ][i];
    p.z[i] = 0u;
  }
}

// One point as six 16-byte loads (rows are 96 bytes; the wrappers check that
// every buffer is 16-byte aligned).
__device__ __forceinline__ void g1_load(G1& p, const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t* d[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    uint4 v = s[k];
    uint32_t* c = d[k / 2] + 4 * (k % 2);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
}

__device__ __forceinline__ void g1_store(uint32_t* __restrict__ dst, const G1& p) {
  uint4* s = reinterpret_cast<uint4*>(dst);
  const uint32_t* d[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    const uint32_t* c = d[k / 2] + 4 * (k % 2);
    s[k] = make_uint4(c[0], c[1], c[2], c[3]);
  }
}

// One point through the read-only path (six 16-byte loads).
__device__ __forceinline__ void g1_load_nc(G1& p, const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint32_t* d[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int k = 0; k < 6; k++) {
    const uint4 v = __ldg(s + k);
    uint32_t* c = d[k / 2] + 4 * (k % 2);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  }
}

// q = the point held by lane (lane ^ mask) of the warp (every lane calls it).
__device__ __forceinline__ void g1_shfl_xor(G1& q, const G1& p, int mask) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    q.x[i] = __shfl_xor_sync(0xffffffffu, p.x[i], mask);
    q.y[i] = __shfl_xor_sync(0xffffffffu, p.y[i], mask);
    q.z[i] = __shfl_xor_sync(0xffffffffu, p.z[i], mask);
  }
}

// o = p + q.  o may alias p or q: both are read before o is written.
__device__ __forceinline__ void g1_add(G1& o, const G1& p, const G1& q) {
  uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS], t3[FQ_WORDS], t4[FQ_WORDS],
      ty[FQ_WORDS], s1[FQ_WORDS], s2[FQ_WORDS];
  // Layer 1: X1X2, Y1Y2, Z1Z2 and the three cross terms.
  fq_mul(t0, p.x, q.x);
  fq_mul(t1, p.y, q.y);
  fq_mul(t2, p.z, q.z);
  fq_add(s1, p.x, p.y);
  fq_add(s2, q.x, q.y);
  fq_mul(t3, s1, s2);
  fq_add(s1, t0, t1);
  fq_sub(t3, t3, s1);  // X1Y2 + X2Y1
  fq_add(s1, p.y, p.z);
  fq_add(s2, q.y, q.z);
  fq_mul(t4, s1, s2);
  fq_add(s1, t1, t2);
  fq_sub(t4, t4, s1);  // Y1Z2 + Y2Z1
  fq_add(s1, p.x, p.z);
  fq_add(s2, q.x, q.z);
  fq_mul(ty, s1, s2);
  fq_add(s1, t0, t2);
  fq_sub(ty, ty, s1);  // X1Z2 + X2Z1
  fq_add(s1, t0, t0);
  fq_add(t0, s1, t0);  // t0_3 = 3 X1X2
  fq_mul9(t2, t2);     // t2b = 3b Z1Z2
  fq_add(s1, t1, t2);  // z3l = Y1Y2 + 3b Z1Z2
  fq_sub(t1, t1, t2);  // t1m = Y1Y2 - 3b Z1Z2
  fq_mul9(ty, ty);     // yb = 3b (X1Z2 + X2Z1)
  // Layer 2.
  fq_mul(s2, t3, t1);
  fq_mul(t2, t4, ty);
  fq_sub(o.x, s2, t2);  // t3 t1m - t4 yb
  fq_mul(s2, t1, s1);
  fq_mul(t2, ty, t0);
  fq_add(o.y, s2, t2);  // t1m z3l + yb t0_3
  fq_mul(s2, s1, t4);
  fq_mul(t2, t0, t3);
  fq_add(o.z, s2, t2);  // z3l t4 + t0_3 t3
}

// o = 2p.  o may alias p.  The two squares go through fe_sqr: the doubling
// chains of msm_loops.cu, which wait on each multiply's latency, measured 3%
// faster with it; a batch of independent doublings (svt_g1_double at 2^19
// points, throughput-bound) 2% slower.
__device__ __forceinline__ void g1_double(G1& o, const G1& p) {
  uint32_t t0[FQ_WORDS], t1[FQ_WORDS], zz[FQ_WORDS], xy[FQ_WORDS], z8[FQ_WORDS],
      t2[FQ_WORDS], y3l[FQ_WORDS], u[FQ_WORDS];
  // Layer 1: Y^2, YZ, Z^2, XY.
  fe_sqr<FQ>(t0, p.y);
  fq_mul(t1, p.y, p.z);
  fe_sqr<FQ>(zz, p.z);
  fq_mul(xy, p.x, p.y);
  fq_add(z8, t0, t0);
  fq_add(z8, z8, z8);
  fq_add(z8, z8, z8);  // 8Y^2
  fq_mul9(t2, zz);     // 3b Z^2
  fq_add(y3l, t0, t2); // Y^2 + 3b Z^2
  fq_add(u, t2, t2);
  fq_add(u, u, t2);
  fq_sub(t0, t0, u);   // t0m = Y^2 - 9b Z^2
  // Layer 2.
  fq_mul(u, t2, z8);
  fq_mul(zz, t0, y3l);
  fq_add(o.y, zz, u);  // (Y^2 - 9bZ^2)(Y^2 + 3bZ^2) + 3bZ^2 * 8Y^2
  fq_mul(xy, t0, xy);
  fq_add(o.x, xy, xy); // 2 XY (Y^2 - 9bZ^2)
  fq_mul(o.z, t1, z8); // 8 Y^3 Z
}

}  // namespace svt
