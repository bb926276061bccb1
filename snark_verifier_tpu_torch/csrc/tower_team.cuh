// Fq12 operations run by a team: the 32 lanes of one warp work on one
// value, which lives in shared memory.  Tower: Fq6 = Fq2[v]/(v^3 - xi),
// xi = 9 + u; Fq12 = Fq6[w]/(w^2 - v).  An Fq12 in shared memory is its six
// Fq2 coordinates `Fq2 x[6]` in the (2, 3, 2, 8) word order of
// tower/encode.py: c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2.
//
// Why a team.  An Fq12 operation is a handful of independent Fq2 products
// (a Karatsuba product 18, a square 12, a sparse line product 13, a
// cyclotomic square 9 Fq2 squares) and a few additions.  One lane running
// them one after another waits out each multiply's carry-chain latency; a
// team runs them at once.  Each operation is
//
//   product pass: each working lane forms its operands' sums from shared
//                 memory and runs its part of the products: a whole Fq2
//                 product (team_mul), half of one over two rounds
//                 (pair_products: the Miller square and line product), or
//                 one Fq multiply (the cyclotomic square) -- a lane's
//                 multiplies run in sequence, so fewer a lane is a shorter
//                 chain; the products go to the team's P[];
//   __syncwarp()
//   combine:      a few lanes add the products into the output coordinates
//                 (one or two stages of additions, x xi, x v), each stage
//                 followed by a __syncwarp().  Where it measured faster
//                 (the Karatsuba output stage, the line product's and the
//                 cyclotomic square's stages) a stage runs one output
//                 component a lane: half a whole Fq2's chained additions
//                 on each lane, though x xi still reads both components.
//
// Every lane reads its operands before the first barrier and no lane
// writes the destination before it, so the destination may be either
// operand (the tape's t.mul(M, A, M), t.square(C, C)).  Every sum is made of
// fe_add / fe_sub, so operands stay in fq.cuh's lazy [0, 2p] (no multi-term
// sum reaches fe_mul unreduced).  The exchange goes through shared memory,
// not shuffles, so the g++ schedule twin (tests/test_torch_pairing_schedule.py)
// runs this very code with a thread per lane and a barrier for __syncwarp.
// All lanes call every function (lanes with no work skip to the barriers),
// and lanes of one stage run one instruction sequence where they can
// (selects, not branches: a warp runs the branches of a divergent if one
// after the other).
//
// The formulas are the least ones for each function, and compute the same
// field elements as tower/tower.py: Fq12Field.mul, square_complex,
// mul_by_034_sparse, cyclotomic_square, inv, and pairing.py::f12_frobenius.
#pragma once

#include "tower.cuh"

namespace svt {

// A team's scratch in shared memory.
struct TeamScratch {
  Fq2 P[18];                  // a product pass's Fq2 products
  Fq2 T[9];                   // a combine's first stage
  Fq2 Q[8];                   // the inverse's n, c, d
  uint32_t t1[16][FQ_WORDS];  // the second lanes' halves of two-lane Fq2 products
};

__device__ __forceinline__ void team_sync() { __syncwarp(); }

// Operand j of a Karatsuba Fq6 product over the Fq6 value whose coordinate
// i is x(i): x0, x1, x2, x1 + x2, x0 + x1, x0 + x2 for j = 0..5.
template <class Coord>
__device__ __forceinline__ Fq2 kara_operand(Coord x, int j) {
  Fq2 r = x(j < 3 ? j : (j == 3 ? 1 : 0));
  if (j >= 3) {
    const Fq2 s = x(j == 4 ? 1 : 2);
    fq2_add(r, r, s);
  }
  return r;
}

// Coordinate j of the Fq6 product whose six Karatsuba products are
// p = (t0, t1, t2, s12, s01, s02):
//   j = 0: t0 + xi (s12 - (t1 + t2))
//   j = 1: (s01 - (t0 + t1)) + xi t2
//   j = 2: (s02 - (t0 + t2)) + t1
// as one sequence for every j: u = p[s] - (p[x] + p[y]), z = p[zi]; xi
// times u (j = 0) or z (j = 1); r = u + z.
__device__ __forceinline__ void kara_combine(Fq2& r, const Fq2* p, int j) {
  const int s = 3 + j, x = j == 0 ? 1 : 0, y = j == 1 ? 1 : 2, zi = j == 0 ? 0 : (j == 1 ? 2 : 1);
  Fq2 u, z = p[zi];
  fq2_add(u, p[x], p[y]);
  fq2_sub(u, p[s], u);
  Fq2 q = j == 0 ? u : z;
  fq2_mul_xi(q, q);
  if (j == 0) u = q;
  if (j == 1) z = q;
  fq2_add(r, u, z);
}

// Lane l < 12 of a stage that writes a whole Fq12 (or six Fq2 values):
// output coordinate l / 2, component l % 2.
__device__ __forceinline__ uint32_t* part_of(Fq2* r, int lane) { return r[lane >> 1].c[lane & 1]; }

// The Fq12 Karatsuba output from its three Fq6 products t0 = a0 b0,
// t1 = a1 b1, t2 = (a0 + a1)(b0 + b1) (coordinate j of each at t0[j],
// t1[j], t2[j]): lane l < 12 writes component c = l % 2 of coordinate
// o = l / 2 = 3i + j,
//   c0 = t0 + v t1 (v t1 = (xi t1_2, t1_0, t1_1)), c1 = t2 - (t0 + t1),
// as one sequence for all twelve lanes: u = t1[.] (times xi for o = 0),
// w = t0_j + u, then c0_j = w or c1_j = t2_j - w.
__device__ __forceinline__ void kara12_out(Fq2* r, const Fq2* t0, const Fq2* t1, const Fq2* t2,
                                           int lane) {
  if (lane < 12) {
    const int o = lane >> 1, c = lane & 1, i = o / 3, j = o % 3;
    const Fq2 u = t1[i == 0 ? (j + 2) % 3 : j];
    uint32_t ux[FQ_WORDS], uc[FQ_WORDS], w[FQ_WORDS], d[FQ_WORDS];
    fq2_mul_xi_part(ux, u, c);
    fq2_part(uc, u, c);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) uc[k] = o == 0 ? ux[k] : uc[k];
    fe_add<FQ>(w, t0[j].c[c], uc);
    fe_sub<FQ>(d, t2[j].c[c], w);
    uint32_t* out = part_of(r, lane);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) out[k] = i == 0 ? w[k] : d[k];
  }
}

// r = a * b, Karatsuba over Fq6: 18 Fq2 products (lane 6k + j: Fq6 product
// k = a0 b0, a1 b1, (a0 + a1)(b0 + b1), its operand j), 54 Fq multiplies.
__device__ __forceinline__ void team_mul(Fq2* r, const Fq2* a, const Fq2* b, TeamScratch& s,
                                         int lane) {
  if (lane < 18) {
    const int k = lane / 6, j = lane % 6;
    auto half = [k](const Fq2* x) {  // Fq6 operand k: x0, x1 or x0 + x1
      return [x, k](int i) {
        Fq2 c = x[(k == 1 ? 3 : 0) + i];
        if (k == 2) fq2_add(c, c, x[3 + i]);
        return c;
      };
    };
    const Fq2 x = kara_operand(half(a), j);
    const Fq2 y = kara_operand(half(b), j);
    fq2_mul(s.P[lane], x, y);
  }
  team_sync();
  if (lane < 9) kara_combine(s.T[lane], s.P + 6 * (lane / 3), lane % 3);
  team_sync();
  kara12_out(r, s.T, s.T + 3, s.T + 6, lane);
  team_sync();
}

// Lanes outside a pass's products may bring an Fq multiply of their own
// into its first round, work that does not depend on the pass's inputs
// (the Miller loop's next line coefficients): side(lane, u, v) sets the
// operands and returns where u v goes (nullptr: none).
struct NoSideWork {
  __device__ __forceinline__ uint32_t* operator()(int, uint32_t*, uint32_t*) const {
    return nullptr;
  }
};

// The product pass of n Fq2 products x y (n <= 16), two lanes each, lane
// 2q + h for product q (operands(q, x, y) forms them from shared memory):
// round 1, h = 0 runs t0 = x0 y0 and h = 1 t1 = x1 y1 (into s.t1[q]), and
// the lanes past 2n their side work, all as one Fq multiply; round 2,
// h = 0 runs t2 = (x0 + x1)(y0 + y1) and writes the product
// (t0 - t1, t2 - (t0 + t1)) to s.P[q].  Two multiplies deep where a lane's
// fq2_mul is three.  Ends with a barrier.
template <class Operands, class Side>
__device__ __forceinline__ void pair_products(int n, Operands operands, TeamScratch& s, int lane,
                                              Side side) {
  const int q = lane >> 1, h = lane & 1;
  const bool mine = lane < 2 * n;
  Fq2 x, y;
  uint32_t u[FQ_WORDS], v[FQ_WORDS], m[FQ_WORDS];
  uint32_t* dst = nullptr;
  if (mine) {
    operands(q, x, y);
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) {  // x_h, y_h (selects: no indexed registers)
      u[w] = h ? x.c[1][w] : x.c[0][w];
      v[w] = h ? y.c[1][w] : y.c[0][w];
    }
    if (h) dst = s.t1[q];
  } else {
    dst = side(lane, u, v);
  }
  if (mine || dst) fe_mul<FQ>(m, u, v);
  if (dst) fe_copy(dst, m);
  team_sync();
  if (mine && h == 0) {
    uint32_t sa[FQ_WORDS], sb[FQ_WORDS], t2[FQ_WORDS], t1[FQ_WORDS];
    fe_add<FQ>(sa, x.c[0], x.c[1]);
    fe_add<FQ>(sb, y.c[0], y.c[1]);
    fe_mul<FQ>(t2, sa, sb);
    fe_copy(t1, s.t1[q]);
    fe_sub<FQ>(s.P[q].c[0], m, t1);
    fe_add<FQ>(sa, m, t1);
    fe_sub<FQ>(s.P[q].c[1], t2, sa);
  }
  team_sync();
}

// r = a^2 in the complex form over Fq6 (w^2 = v): t = a0 a1 and
// u = (a0 + a1)(a0 + v a1) (products 0..5 and 6..11, Karatsuba operand j,
// two lanes each), then c0 = u - t - v t, c1 = 2t: 12 Fq2 products, 36 Fq
// multiplies.
__device__ __forceinline__ void team_sqr(Fq2* r, const Fq2* a, TeamScratch& s, int lane) {
  pair_products(
      12,
      [a](int q, Fq2& x, Fq2& y) {
        const int k = q / 6, j = q % 6;
        auto xs = [a, k](int i) {  // a0, or a0 + a1
          Fq2 c = a[i];
          if (k == 1) fq2_add(c, c, a[3 + i]);
          return c;
        };
        auto ys = [a, k](int i) {  // a1, or a0 + v a1 (v a1 = (xi a1_2, a1_0, a1_1))
          if (k == 0) return a[3 + i];
          Fq2 c = a[i == 0 ? 5 : 2 + i];
          if (i == 0) fq2_mul_xi(c, c);
          fq2_add(c, c, a[i]);
          return c;
        };
        x = kara_operand(xs, j);
        y = kara_operand(ys, j);
      },
      s, lane, NoSideWork());
  if (lane < 6) kara_combine(s.T[lane], s.P + 6 * (lane / 3), lane % 3);  // t, then u
  team_sync();
  if (lane < 6) {  // c0_j = u_j - (t_j + (v t)_j), c1_j = t_j + t_j
    const int j = lane % 3;
    const Fq2* t = s.T;
    Fq2 v = t[lane < 3 ? (j + 2) % 3 : j], vx, w, d;
    fq2_mul_xi(vx, v);
    if (lane == 0) v = vx;
    fq2_add(w, t[j], v);
    fq2_sub(d, t[3 + j], w);
    r[lane] = lane < 3 ? d : w;
  }
  team_sync();
}

// r = f * (c0 + c3 w + c4 v w), the line L = (c0, c3, c4) in shared memory:
// Karatsuba over Fq6 with the line's halves l0 = c0, l1 = c3 + c4 v.
// Products 0..2: t0 = f0 c0; 3..7: t1 = f1 l1 and 8..12:
// t2 = (f0 + f1)(l0 + l1), each Fq6 times (b0 + b1 v) by five products
// a0 b0, a1 b1, (a1 + a2) b1, (a0 + a2) b0, (a0 + a1)(b0 + b1).  13 Fq2
// products (39 Fq multiplies) on lanes 0..25, two lanes each; lanes 26..31
// are free for side work.
template <class Side = NoSideWork>
__device__ __forceinline__ void team_mul_034(Fq2* r, const Fq2* f, const Fq2* L, TeamScratch& s,
                                             int lane, Side side = Side()) {
  pair_products(
      13,
      [f, L](int q, Fq2& x, Fq2& y) {
        if (q < 3) {
          x = f[q];
          y = L[0];
          return;
        }
        const int m = (q - 3) / 5, e = (q - 3) % 5;
        auto a = [f, m](int i) {  // f1, or f0 + f1
          Fq2 c = f[3 + i];
          if (m == 1) fq2_add(c, c, f[i]);
          return c;
        };
        Fq2 b0 = L[1];
        if (m == 1) fq2_add(b0, b0, L[0]);
        const Fq2 b1 = L[2];
        // e: (a0, b0), (a1, b1), (a1 + a2, b1), (a0 + a2, b0), (a0 + a1, b0 + b1)
        x = a(e == 1 || e == 2 ? 1 : 0);
        if (e >= 2) fq2_add(x, x, a(e == 4 ? 1 : 2));
        y = (e == 1 || e == 2) ? b1 : b0;
        if (e == 4) fq2_add(y, y, b1);
      },
      s, lane, side);
  if (lane < 12) {  // T[0..2] = t1, T[3..5] = t2: (aa + xi (s12 - bb), s01 - (aa + bb), s02 - aa + bb)
    const int t = lane >> 1, c = lane & 1, j = t % 3;
    const Fq2* p = s.P + 3 + 5 * (t / 3);
    const Fq2 aa = p[0], bb = p[1];
    Fq2 g, e;
    fq2_add(g, aa, bb);
    if (j != 1) g = j == 0 ? bb : aa;
    fq2_sub(e, p[j == 0 ? 2 : (j == 1 ? 4 : 3)], g);  // s12 - bb, s01 - (aa + bb), s02 - aa
    uint32_t ex[FQ_WORDS], ec[FQ_WORDS], z1[FQ_WORDS], z2[FQ_WORDS], z[FQ_WORDS];
    fq2_mul_xi_part(ex, e, c);
    fq2_part(ec, e, c);
    fq2_part(z1, aa, c);
    fq2_part(z2, bb, c);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) {
      z1[k] = j == 0 ? z1[k] : z2[k];
      ex[k] = j == 0 ? ex[k] : ec[k];
    }
    fe_add<FQ>(z, z1, ex);
    uint32_t* out = part_of(s.T, lane);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) out[k] = j == 1 ? ec[k] : z[k];
  }
  team_sync();
  kara12_out(r, s.P, s.T, s.T + 3, lane);
  team_sync();
}

// r = a^2 for a in the cyclotomic subgroup, by Granger-Scott: Fq12 as Fq4^3,
// Fq4 = Fq2[w^3]/(w^6 - xi), pairs (x, y) = (c0.c0, c1.c1), (c1.c0, c0.c2),
// (c0.c1, c1.c2) (coordinates (0, 4), (3, 2), (1, 5)).  The nine Fq2
// squares v^2 = ((v0 + v1)(v0 - v1), 2 v0 v1) of x, y, x + y of each pair
// (square q = 3 pair + m) run one Fq multiply a lane, lane 2q + h computing
// component h: 18 lanes, 18 Fq multiplies, one deep.  Then lane c < 6
// writes coordinate c from its pair's even part x^2 + xi y^2 or odd part
// (x + y)^2 - x^2 - y^2 (times xi for coordinate 3) and its own input r_c:
// 3t - 2 r_c (coordinates 0, 1, 2) or 3t + 2 r_c (3, 4, 5).  Right only
// inside the subgroup; maps 0 to 0.
__device__ __forceinline__ void team_cyclo_sqr(Fq2* r, const Fq2* a, TeamScratch& s, int lane) {
  if (lane < 18) {
    const int q = lane >> 1, h = lane & 1, p = q / 3, m = q % 3;
    const Fq2& x = a[p == 0 ? 0 : (p == 1 ? 3 : 1)];
    const Fq2& y = a[p == 0 ? 4 : (p == 1 ? 2 : 5)];
    Fq2 v = m == 1 ? y : x;
    if (m == 2) fq2_add(v, v, y);
    uint32_t sa[FQ_WORDS], sb[FQ_WORDS], t[FQ_WORDS];
    fe_add<FQ>(sa, v.c[0], v.c[1]);
    fe_sub<FQ>(sb, v.c[0], v.c[1]);
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) {  // h = 0: (v0 + v1)(v0 - v1); h = 1: v0 v1
      sa[w] = h ? v.c[0][w] : sa[w];
      sb[w] = h ? v.c[1][w] : sb[w];
    }
    fe_mul<FQ>(t, sa, sb);
    fe_add<FQ>(sa, t, t);
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) s.P[q].c[h][w] = h ? sa[w] : t[w];
  }
  team_sync();
  if (lane < 12) {  // component h of coordinate o
    const int o = lane >> 1, h = lane & 1;
    const bool odd = o >= 3;
    const Fq2* q = s.P + 3 * (o == 0 || o == 4 ? 0 : (o == 1 || o == 5 ? 1 : 2));
    Fq2 t;
    fq2_add(t, q[0], q[1]);
    fq2_sub(t, q[2], t);  // odd part (x + y)^2 - x^2 - y^2, whole
    uint32_t e[FQ_WORDS], tc[FQ_WORDS], te[FQ_WORDS], dp[FQ_WORDS], dm[FQ_WORDS];
    Fq2 ey = q[1];
    if (odd) ey = t;
    fq2_mul_xi_part(e, ey, h);              // xi y^2, or xi times the odd part
    fe_add<FQ>(te, q[0].c[h], e);           // even part x^2 + xi y^2
    fq2_part(tc, t, h);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) tc[k] = !odd ? te[k] : (o == 3 ? e[k] : tc[k]);
    const uint32_t* rc = a[o].c[h];
    fe_add<FQ>(dp, tc, rc);
    fe_sub<FQ>(dm, tc, rc);
#pragma unroll
    for (int k = 0; k < FQ_WORDS; k++) dp[k] = odd ? dp[k] : dm[k];
    fe_add<FQ>(dp, dp, dp);
    fe_add<FQ>(part_of(r, lane), dp, tc);  // 3t + 2 r_o, or 3t - 2 r_o
  }
  team_sync();
}

// Transform ids of the tape (pairing/fq12_vm.py): identity, conj12, frob^1..3.
constexpr int T_IDENTITY = 0, T_CONJ12 = 1, T_FROB1 = 2;

// r = transform tid (>= T_CONJ12) of a: lane j < 6 maps coordinate j, so
// r may alias a.  conj12 negates c1; frob^k conjugates each coordinate (odd
// k) and multiplies coordinates 1..5 by coef[k - 1][j] (pairing.py::
// f12_frobenius, which multiplies the w part twice, combined).
__device__ __forceinline__ void team_transform(Fq2* r, const Fq2* a, int tid,
                                               const uint32_t (*coef)[6][2][FQ_WORDS], int lane) {
  if (lane < 6) {
    const int j = lane;
    Fq2 x = a[j];
    if (tid == T_CONJ12) {
      if (j >= 3) fq2_neg(x, x);
    } else {
      const int k = tid - T_FROB1;  // power - 1
      if ((k & 1) == 0) fq2_conj(x, x);
      if (j > 0) {
        Fq2 cf;
        fe_copy(cf.c[0], coef[k][j][0]);
        fe_copy(cf.c[1], coef[k][j][1]);
        fq2_mul(x, x, cf);
      }
    }
    r[j] = x;
  }
  team_sync();
}

__device__ __forceinline__ void team_copy(Fq2* r, const Fq2* a, int lane) {
  if (lane < 6) r[lane] = a[lane];
  team_sync();
}

// r = 1/a (0 maps to 0), r may alias a: tower.py's Fq12Field.inv with the
// team's products.  s0 = a0^2, s1 = a1^2 (12 Fq2 squares); n = s0 - v s1;
// 1/n by the norm to Fq2 (six products, c = (s0 - xi m0, xi s2 - m1,
// s1 - m2), three products, d = xi (n2 c1 + n1 c2) + n0 c0, 1/d on lane 0
// with one Fq inversion, 1/n = c / d); then r = (a0 / n, -a1 / n)
// (12 Fq2 products).
__device__ __forceinline__ void team_inv(Fq2* r, const Fq2* a, TeamScratch& s, int lane) {
  Fq2* N = s.Q;      // n, then 1/n
  Fq2* C = s.Q + 3;  // c
  Fq2* D = s.Q + 6;  // d, 1/d
  if (lane < 12) {
    const int k = lane / 6;
    const Fq2 x = kara_operand([a, k](int i) { return a[3 * k + i]; }, lane % 6);
    fq2_sqr(s.P[lane], x);
  }
  team_sync();
  if (lane < 6) kara_combine(s.T[lane], s.P + 6 * (lane / 3), lane % 3);
  team_sync();
  if (lane < 3) {  // n_j = s0_j - (v s1)_j
    Fq2 u = s.T[3 + (lane + 2) % 3];
    if (lane == 0) fq2_mul_xi(u, u);
    fq2_sub(N[lane], s.T[lane], u);
  }
  team_sync();
  if (lane < 6) {  // n0^2, n1^2, n2^2, n1 n2, n0 n1, n0 n2
    const int x = lane < 3 ? lane : (lane == 3 ? 1 : 0), y = lane < 3 ? lane : (lane == 4 ? 1 : 2);
    fq2_mul(s.P[lane], N[x], N[y]);
  }
  team_sync();
  if (lane < 3) {  // c0 = s0 - xi m0, c1 = xi s2 - m1, c2 = s1 - m2
    const int j = lane;
    Fq2 e = s.P[j == 0 ? 3 : 2];
    fq2_mul_xi(e, e);
    const Fq2 lhs = j == 0 ? s.P[0] : (j == 1 ? e : s.P[1]);
    const Fq2 rhs = j == 0 ? e : s.P[j == 1 ? 4 : 5];
    fq2_sub(C[j], lhs, rhs);
  }
  team_sync();
  if (lane < 3) fq2_mul(s.P[lane], N[2 - lane], C[(lane + 1) % 3]);  // n2 c1, n1 c2, n0 c0
  team_sync();
  if (lane == 0) {
    Fq2 d;
    fq2_add(d, s.P[0], s.P[1]);
    fq2_mul_xi(d, d);
    fq2_add(d, d, s.P[2]);
    fq2_inv(D[0], d);
  }
  team_sync();
  if (lane < 3) fq2_mul(N[lane], C[lane], D[0]);
  team_sync();
  if (lane < 12) {  // (a0 / n, -a1 / n)
    const int k = lane / 6, j = lane % 6;
    const Fq2 x = kara_operand(
        [a, k](int i) {
          Fq2 c = a[3 * k + i];
          if (k == 1) fq2_neg(c, c);
          return c;
        },
        j);
    const Fq2 y = kara_operand([N](int i) { return N[i]; }, j);
    fq2_mul(s.P[lane], x, y);
  }
  team_sync();
  if (lane < 6) kara_combine(r[lane], s.P + 6 * (lane / 3), lane % 3);
  team_sync();
}

// Whole-value moves between device memory and a team's shared Fq12: 96
// words as 24 uint4, one a lane.
__device__ __forceinline__ void team_load12(Fq2* r, const uint32_t* __restrict__ src, int lane) {
  if (lane < FQ12_WORDS / 4)
    reinterpret_cast<uint4*>(r)[lane] = __ldg(reinterpret_cast<const uint4*>(src) + lane);
}

__device__ __forceinline__ void team_store12(uint32_t* __restrict__ dst, const Fq2* a, int lane) {
  if (lane < FQ12_WORDS / 4)
    reinterpret_cast<uint4*>(dst)[lane] = reinterpret_cast<const uint4*>(a)[lane];
}

}  // namespace svt
