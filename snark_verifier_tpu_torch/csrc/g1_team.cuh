// The G1 group law of g1.cuh run by a team of T lanes of one warp: the same
// RC15 add (two layers of six independent Fq products) and double (two
// layers of four), with each layer's products spread over the team's lanes
// and exchanged through shared memory, as tower_team.cuh does for Fq12.
//
// Why a team.  One lane runs an add's twelve products or a double's eight
// one after another, each waiting out a multiply's carry-chain latency
// (~805 clocks for a warp alone, fq.cuh).  The point loops of msm_loops.cu
// are chains of such operations that nothing else can overlap: the bucket
// reduction's 2^248 scale of its top window, a ladder of 64 windows when a
// verify batch holds a few proofs.  A team runs a layer's products at once:
//
//   T = 1   g1_add / g1_double themselves                       add 12, double 8
//   T = 2   three, then two products a lane and layer          add  6, double 4
//   T = 4   two (lanes 0-1) or one product a lane and layer    add  4, double 2
//   T = 6   one product a lane and layer (lanes 4-5 rest       add  2, double 2
//           in a double)
//
// dependent multiplies, plus the additions between the layers, which every
// lane of the team runs on its own copy (they cost no multiply).
//
// Each operation:
//   layer 1: lane r forms the operands of products j = r, r + T, ... from
//            the points it holds, multiplies, and writes each product to
//            the team's slot j;
//   sync, then every lane reads the layer's products and forms the
//            additions of g1.cuh in the same order;
//   sync, layer 2 as layer 1, sync, every lane reads the layer-2 products
//            and forms the output; sync (the slots are free again).
// Every lane of the team passes the same operands and gets the same output,
// word for word, as g1_add / g1_double give one lane: the same field
// operations on the same words, the Montgomery product being a function of
// a*b alone (fq.cuh).  So operands stay in fq.cuh's lazy [0, 2p], and the
// output may alias an operand (all operands are read before the first
// barrier's products are written, and o is written after the last read).
//
// All 32 lanes of the warp call every operation together (a lane of a
// ragged last team, T = 6, works on whatever it holds and its result is
// dropped), so a barrier is the whole warp's __syncwarp().  The exchange
// goes through shared memory, not shuffles, so the g++ schedule twin
// (tests/test_torch_g1_team_schedule.py) runs this very code with a thread
// per lane and a barrier for __syncwarp.  A lane picks its products'
// operands with selects, not branches: a warp runs the sides of a
// divergent branch one after the other.
#pragma once

#include "g1.cuh"

namespace svt {

// A team's exchange slots: the products of one layer (six at most).
struct alignas(16) G1TeamSlots {
  uint32_t p[6][FQ_WORDS];
};

// The exchange of a layer's products through the team's slots: lane r
// writes its products v[k] (product r + kT) to their slots, the warp's
// barrier, every lane reads all NP products into P, the barrier again
// (the slots are free for the next layer).  A shuffle exchange measured
// slower (csrc/probe/point_loop_variants.cu, PERF.md).
struct G1SharedExchange {
  G1TeamSlots& s;
  __device__ G1SharedExchange(G1TeamSlots& slots, int) : s(slots) {}
  template <int T, int NP>
  __device__ __forceinline__ void exchange(uint32_t (*P)[FQ_WORDS],
                                           uint32_t (*v)[FQ_WORDS], int r) const {
#pragma unroll
    for (int k = 0; k * T < NP; k++)
      if (r + k * T < NP) fe_copy(s.p[r + k * T], v[k]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NP; j++) fe_copy(P[j], s.p[j]);
    __syncwarp();
  }
};

// r = c ? a : b, word by word.
__device__ __forceinline__ void fq_select(uint32_t r[FQ_WORDS], bool c, const uint32_t a[FQ_WORDS],
                                          const uint32_t b[FQ_WORDS]) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) r[i] = c ? a[i] : b[i];
}

// r = v[j] of six candidates (j < 6), word by word: selects, so that every
// candidate stays in registers (a pointer picked at run time would move the
// point to local memory).
__device__ __forceinline__ void fq_pick6(uint32_t r[FQ_WORDS], int j, const uint32_t* v0,
                                         const uint32_t* v1, const uint32_t* v2, const uint32_t* v3,
                                         const uint32_t* v4, const uint32_t* v5) {
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++)
    r[i] = j == 0 ? v0[i] : j == 1 ? v1[i] : j == 2 ? v2[i] : j == 3 ? v3[i] : j == 4 ? v4[i]
                                                                                      : v5[i];
}

// One layer of NP products over the team: lane r runs products r, r + T,
// ... (below NP), forming product j's operands with `operands(a, b, j)`;
// then the exchange gives every lane all NP products in P.  SQ: every
// product of the first step is a square (a == b), which fe_sqr forms in
// fewer instructions and to the same words.
template <int T, int NP, bool SQ = false, class X, class Operands>
__device__ __forceinline__ void g1_team_layer(uint32_t (*P)[FQ_WORDS], const X& x, int r,
                                              Operands operands) {
  uint32_t v[(NP + T - 1) / T][FQ_WORDS];
#pragma unroll
  for (int k = 0; k * T < NP; k++) {
    const int j = r + k * T;
    if (j < NP) {  // a branch only where T does not divide NP, on the last step
      uint32_t a[FQ_WORDS], b[FQ_WORDS];
      operands(a, b, j);
      if (SQ && k == 0)
        fe_sqr<FQ>(v[k], a);
      else
        fq_mul(v[k], a, b);
    }
  }
  x.template exchange<T, NP>(P, v, r);
}

// o = p + q by a team of T lanes (g1_add's words).  o may alias p or q.
template <int T, class X>
__device__ __forceinline__ void g1_team_add(G1& o, const G1& p, const G1& q, const X& x, int r) {
  if constexpr (T == 1) {
    g1_add(o, p, q);
  } else {
    // Layer 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2).
    uint32_t P[6][FQ_WORDS];
    g1_team_layer<T, 6>(P, x, r, [&](uint32_t* a, uint32_t* b, int j) {
      uint32_t c[FQ_WORDS], d[FQ_WORDS], sa[FQ_WORDS], sb[FQ_WORDS];
      fq_pick6(a, j, p.x, p.y, p.z, p.x, p.y, p.x);
      fq_pick6(b, j, q.x, q.y, q.z, q.x, q.y, q.x);
      fq_select(c, j == 3, p.y, p.z);
      fq_select(d, j == 3, q.y, q.z);
      fq_add(sa, a, c);
      fq_add(sb, b, d);
      fq_select(a, j >= 3, sa, a);
      fq_select(b, j >= 3, sb, b);
    });
    uint32_t t0[FQ_WORDS], t1[FQ_WORDS], t2[FQ_WORDS], t3[FQ_WORDS], t4[FQ_WORDS],
        ty[FQ_WORDS], s1[FQ_WORDS];
    fe_copy(t0, P[0]);
    fe_copy(t1, P[1]);
    fe_copy(t2, P[2]);
    fe_copy(t3, P[3]);
    fe_copy(t4, P[4]);
    fe_copy(ty, P[5]);
    fq_add(s1, t0, t1);
    fq_sub(t3, t3, s1);  // X1Y2 + X2Y1
    fq_add(s1, t1, t2);
    fq_sub(t4, t4, s1);  // Y1Z2 + Y2Z1
    fq_add(s1, t0, t2);
    fq_sub(ty, ty, s1);  // X1Z2 + X2Z1
    fq_add(s1, t0, t0);
    fq_add(t0, s1, t0);  // t0_3 = 3 X1X2
    fq_mul9(t2, t2);     // t2b = 3b Z1Z2
    fq_add(s1, t1, t2);  // z3l = Y1Y2 + 3b Z1Z2
    fq_sub(t1, t1, t2);  // t1m = Y1Y2 - 3b Z1Z2
    fq_mul9(ty, ty);     // yb = 3b (X1Z2 + X2Z1)
    // Layer 2: t3 t1m, t4 yb, t1m z3l, yb t0_3, z3l t4, t0_3 t3.
    g1_team_layer<T, 6>(P, x, r, [&](uint32_t* a, uint32_t* b, int j) {
      fq_pick6(a, j, t3, t4, t1, ty, s1, t0);
      fq_pick6(b, j, t1, ty, s1, t0, t4, t3);
    });
    fq_sub(o.x, P[0], P[1]);  // t3 t1m - t4 yb
    fq_add(o.y, P[2], P[3]);  // t1m z3l + yb t0_3
    fq_add(o.z, P[4], P[5]);  // z3l t4 + t0_3 t3
  }
}

// o = 2p by a team of T lanes (g1_double's words).  o may alias p.
template <int T, class X>
__device__ __forceinline__ void g1_team_double(G1& o, const G1& p, const X& x, int r) {
  if constexpr (T == 1) {
    g1_double(o, p);
  } else {
    // Layer 1: Y^2, Z^2, YZ, XY (at T = 2 the first step is the two squares).
    uint32_t P[4][FQ_WORDS];
    g1_team_layer<T, 4, T == 2>(P, x, r, [&](uint32_t* a, uint32_t* b, int j) {
      fq_pick6(a, j, p.y, p.z, p.y, p.x, p.x, p.x);
      fq_pick6(b, j, p.y, p.z, p.z, p.y, p.y, p.y);
    });
    uint32_t t0[FQ_WORDS], zz[FQ_WORDS], t1[FQ_WORDS], xy[FQ_WORDS], z8[FQ_WORDS],
        t2[FQ_WORDS], y3l[FQ_WORDS], u[FQ_WORDS];
    fe_copy(t0, P[0]);
    fe_copy(zz, P[1]);
    fe_copy(t1, P[2]);
    fe_copy(xy, P[3]);
    fq_add(z8, t0, t0);
    fq_add(z8, z8, z8);
    fq_add(z8, z8, z8);  // 8Y^2
    fq_mul9(t2, zz);     // 3b Z^2
    fq_add(y3l, t0, t2); // Y^2 + 3b Z^2
    fq_add(u, t2, t2);
    fq_add(u, u, t2);
    fq_sub(t0, t0, u);   // t0m = Y^2 - 9b Z^2
    // Layer 2: 3bZ^2 8Y^2, t0m y3l, t0m XY, YZ 8Y^2.
    g1_team_layer<T, 4>(P, x, r, [&](uint32_t* a, uint32_t* b, int j) {
      fq_pick6(a, j, t2, t0, t0, t1, t1, t1);
      fq_pick6(b, j, z8, y3l, xy, z8, z8, z8);
    });
    fq_add(o.y, P[1], P[0]);  // (Y^2 - 9bZ^2)(Y^2 + 3bZ^2) + 3bZ^2 * 8Y^2
    fq_add(o.x, P[2], P[2]);  // 2 XY (Y^2 - 9bZ^2)
    fe_copy(o.z, P[3]);       // 8 Y^3 Z
  }
}

}  // namespace svt
