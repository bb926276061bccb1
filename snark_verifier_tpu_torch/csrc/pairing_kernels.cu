// The BN254 pairing decide on the card (Hopper, sm_90a; plain C interface,
// ctypes: _build.py, pairing/pairing.py):
//
// * svt_miller_loop replaces the JAX package's pairing/pairing.py::
//   miller_loop (:151-164, positional path) with _mul_lines (:99-117): the
//   multi-Miller loop of every proof over the G2 lines prepared on the host
//   (65 steps; f^2, then each pair's doubling line, then its addition line
//   where has_add is set; the two Frobenius end steps last).
// * svt_final_exp replaces pairing/pairing.py::final_exponentiation
//   (:257-262) with pairing/fq12_vm.py::run_tape (:145-160): the easy part
//   m = conj(f) f^-1, then the 406-step hard-part tape over 8 Fq12
//   registers; the result canonical.
// * svt_fq12_op: one tower operation per launch, by op code (tower/
//   tower.py :223-257, pairing/pairing.py::f12_frobenius :213-232), one
//   team per element, through the same team functions as the path
//   kernels.  No path launches it: chip_smoke.py and the card tests use it
//   to find which tower function is wrong when a path kernel disagrees.
//
// What bounds them.  Not bytes (an Fq12 is 384 B a proof; the lines, 50 KB,
// are the same for every proof), and at the verify batch not the card's
// multiply rate either: 1,024 proofs x ~10,000 Fq multiplies x 136
// multiply-adds is ~0.08 ms of the whole card.  Each proof's decide is a
// chain of dependent Fq12 operations (every Miller step squares the f the
// step before made; every tape row reads a register an earlier row wrote),
// so the time is the length of that chain.  The first design (one thread
// per proof, the tower as calls on local memory) ran each Fq12 product's 54
// multiplies one after another on one lane: 8.66 and 10.41 ms at 1,024
// proofs, 8.52 and 10.19 for one (NVIDIA H100 80GB HBM3, 700 W; PERF.md),
// with 32 of the card's 528 warp schedulers busy.
//
// This design: a team per proof.  The 32 lanes of a warp share the proof's
// Fq12 values in shared memory, and each Fq12 operation runs its
// independent Fq2 products at once, one or two lanes each, then a few lanes
// combine them (tower_team.cuh).  And the least formulas: an Fq12 square in
// the complex form (36 multiplies, not 54), the sparse line product (39,
// not 54), the cyclotomic square for every tape row that squares (18: each
// such row runs after the easy part, in the cyclotomic subgroup; the kernel
// recognises them as src1 == src2 with the identity transform, so the tape
// is the JAX package's).  What a level costs, read from
// csrc/probe/team_levels.cu: a lane's Fq2 product is its three multiplies
// in sequence (their statements share the one carry flag and a warp issues
// in order), so the Miller loop's square and line products put each Fq2
// product on two lanes (two multiplies deep) and the cyclotomic square
// puts one multiply on each of 18 lanes; the generic product (18 Fq2
// products) has no lanes to spare; the line product's, the Karatsuba
// output's and the cyclotomic square's combine stages run one output
// component a lane.  The line coefficients c0 y, c3 x, c4 z
// do not depend on f: six idle lanes make the next line's during each line
// product.  Blocks hold PAIR_TEAMS proofs (warps) in static shared memory
// (a Miller team 3.5 KB, a final-exponentiation team 6.1 KB with its 8 tape
// registers), so at 1,024 proofs the card runs 1,024 warps, about two per
// scheduler.  The one serial piece left is the Fq inversion inside the
// easy part's Fq12 inverse: square-and-multiply on one lane (chip_smoke.py
// times the Fq12 inverse alone).  Tensor cores, TMA and cp.async do not
// serve this work: there is no matrix product (integer Montgomery
// multiplies run on the integer pipes) and a proof's inputs are 192-384
// bytes.  Nothing is a call and nothing lives in local memory (ptxas: no
// stack).  Measured: 0.91 and 0.99 ms at 1,024 proofs, 0.69 and 0.76 for
// one (NVIDIA H100 80GB HBM3, 700 W; PERF.md has the runs), ~5,700 clocks
// per Miller operation: the chained multiplies of a lane's Fq2 products
// and the combine stages' carry chains, not the card's rate, set it.  The
// kernels skip what the plain formulas do for nothing (the first Miller
// square of f = 1, a tape product by the register that holds 1, the
// identity transform; conj12 is a negation), so compare canonically.

#include <cuda_runtime.h>

#include <cstdint>

#include "tower_team.cuh"

namespace svt {

constexpr int PAIR_TEAMS = 4;  // proofs (warps) a block
constexpr int PAIR_THREADS = 32 * PAIR_TEAMS;
// The KZG decide's Miller loop: two pairs, (lhs, g2) and (rhs, -s g2), over
// the 65 steps of the NAF of 6x + 2 (pairing/pairing.py: NPAIRS, NSTEPS).
constexpr int PAIR_NPAIRS = 2;
constexpr int PAIR_NSTEPS = 65;
constexpr int LINE_WORDS = 3 * 2 * FQ_WORDS;  // (c0, c3, c4) coefficients of one line
constexpr int NREG = 8;                        // tape registers (pairing/fq12_vm.py)
constexpr int R_ONE = 0;                       // the register that holds 1

// Frobenius^1, ^2, ^3: six Fq2 coefficients each (fq12_vm.transform_table),
// loaded by svt_pairing_load_constants.
static __constant__ uint32_t PAIR_FROB[3][6][2][FQ_WORDS];

struct MillerTeam {
  Fq2 f[6];
  Fq2 lines[2][3];  // a ring of two lines' (c0, c3, c4): the one in use, the next
  TeamScratch s;
};

struct FinalExpTeam {
  Fq2 R[NREG][6];
  Fq2 t[6];  // a transformed operand
  TeamScratch s;
};

struct OpTeam {
  Fq2 x[6], y[6], r[6];
  TeamScratch s;
};

// One Fq multiply of one line coefficient at one proof's point, (c[0] y,
// c[1] x, c[2] z): component h of coefficient m, u = c[m]_h (the line's
// words, shared by the batch: one broadcast load a word) and v = the
// point's coordinate.
__device__ __forceinline__ void line_operands(uint32_t* u, uint32_t* v,
                                              const uint32_t* __restrict__ c, int m, int h,
                                              const uint32_t* __restrict__ px,
                                              const uint32_t* __restrict__ py,
                                              const uint32_t* __restrict__ pz) {
  const uint32_t* src = m == 0 ? py : (m == 1 ? px : pz);
#pragma unroll
  for (int i = 0; i < FQ_WORDS; i++) {
    u[i] = __ldg(c + (2 * m + h) * FQ_WORDS + i);
    v[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ bool step_has_add(int i, unsigned long long lo, unsigned long long hi) {
  return i < 64 ? (lo >> i) & 1ull : (hi >> (i - 64)) & 1ull;
}

__global__ void __launch_bounds__(PAIR_THREADS, 1)
    miller_loop_kernel(const uint32_t* __restrict__ xs, const uint32_t* __restrict__ ys,
                       const uint32_t* __restrict__ zs, const uint32_t* __restrict__ dbl,
                       const uint32_t* __restrict__ addc, const uint32_t* __restrict__ finals,
                       unsigned long long mask_lo, unsigned long long mask_hi, long long nlanes,
                       uint32_t* __restrict__ out) {
  __shared__ MillerTeam teams[PAIR_TEAMS];
  const int lane = threadIdx.x & 31;
  MillerTeam& tm = teams[threadIdx.x >> 5];
  const long long b = (long long)blockIdx.x * PAIR_TEAMS + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // the whole warp
  const uint32_t* px = xs + b * PAIR_NPAIRS * FQ_WORDS;
  const uint32_t* py = ys + b * PAIR_NPAIRS * FQ_WORDS;
  const uint32_t* pz = zs + b * PAIR_NPAIRS * FQ_WORDS;
  // The lines in the order the loop multiplies them: step i's lines q = 0..1
  // (pair q's doubling line), then q = 2..3 (pair q - 2's addition line)
  // where has_add is set; steps 65 and 66 are the end steps (finals, pair
  // q).  Each line's six coefficient multiplies run on lanes 26..31 during
  // the line product before it (the first line's in a pass of its own),
  // into the other slot of the ring.
  auto nlines = [&](int i) {
    return i < PAIR_NSTEPS && step_has_add(i, mask_lo, mask_hi) ? 2 * PAIR_NPAIRS : PAIR_NPAIRS;
  };
  auto coeff = [&](int i, int q, int idx, Fq2* slot, uint32_t* u, uint32_t* v) -> uint32_t* {
    const int k = q % PAIR_NPAIRS, m = idx >> 1, h = idx & 1;
    const uint32_t* c = i >= PAIR_NSTEPS ? finals + ((i - PAIR_NSTEPS) * PAIR_NPAIRS + k) * LINE_WORDS
                        : (q < PAIR_NPAIRS ? dbl : addc) + (i * PAIR_NPAIRS + k) * LINE_WORDS;
    line_operands(u, v, c, m, h, px + k * FQ_WORDS, py + k * FQ_WORDS, pz + k * FQ_WORDS);
    return slot[m].c[h];
  };
  // First pass: line (0, 0)'s coefficients (lanes 0..5) and f = 1 (24..29).
  if (lane < 6) {
    uint32_t u[FQ_WORDS], v[FQ_WORDS];
    uint32_t* dst = coeff(0, 0, lane, tm.lines[0], u, v);
    fe_mul<FQ>(dst, u, v);
  } else if (lane >= 24 && lane < 30) {
    if (lane == 24)
      fq2_one(tm.f[0]);
    else
      fq2_zero(tm.f[lane - 24]);
  }
  team_sync();
  int slot = 0;
  // Steps 0..64, then the two end steps (65, 66: their lines, no square).
#pragma unroll 1
  for (int i = 0; i < PAIR_NSTEPS + 2; i++) {
    if (i > 0 && i < PAIR_NSTEPS) team_sqr(tm.f, tm.f, tm.s, lane);  // step 0 squares f = 1
    const int nq = nlines(i);
#pragma unroll 1
    for (int q = 0; q < nq; q++) {
      const bool last = q + 1 == nq;
      const int ni = last ? i + 1 : i, nqn = last ? 0 : q + 1;  // the next line
      Fq2* next = tm.lines[slot ^ 1];
      team_mul_034(tm.f, tm.f, tm.lines[slot], tm.s, lane,
                   [&](int l, uint32_t* u, uint32_t* v) -> uint32_t* {
                     return l >= 26 && ni < PAIR_NSTEPS + 2 ? coeff(ni, nqn, l - 26, next, u, v)
                                                            : nullptr;
                   });
      slot ^= 1;
    }
  }
  team_store12(out + b * FQ12_WORDS, tm.f, lane);
}

// The tape's transform tid of a into r (lane j maps coordinate j).
__device__ __forceinline__ void pair_transform(Fq2* r, const Fq2* a, int tid, int lane) {
  team_transform(r, a, tid, PAIR_FROB, lane);
}

__global__ void __launch_bounds__(PAIR_THREADS, 1)
    final_exp_kernel(const uint32_t* __restrict__ fin, const int4* __restrict__ tape, int nsteps,
                     long long nlanes, uint32_t* __restrict__ out) {
  __shared__ FinalExpTeam teams[PAIR_TEAMS];
  const int lane = threadIdx.x & 31;
  FinalExpTeam& tm = teams[threadIdx.x >> 5];
  const long long b = (long long)blockIdx.x * PAIR_TEAMS + (threadIdx.x >> 5);
  if (b >= nlanes) return;  // the whole warp
  Fq2(*R)[6] = tm.R;
  // easy part, first half: m = conj(f) f^-1 = f^(p^6 - 1) into R[1]; f in R[2]
  team_load12(R[2], fin + b * FQ12_WORDS, lane);
  team_sync();
  team_inv(R[3], R[2], tm.s, lane);
  pair_transform(R[2], R[2], T_CONJ12, lane);
  team_mul(R[1], R[2], R[3], tm.s, lane);
  for (int c = lane; c < NREG * 6; c += 32)
    if (c / 6 != 1) {
      if (c % 6 == 0)
        fq2_one(R[c / 6][0]);
      else
        fq2_zero(R[c / 6][c % 6]);
    }
  team_sync();
  // R[dst] = transform(R[src1]) * R[src2]: the team functions read both
  // operands before they write, so dst may be src1 or src2.
#pragma unroll 1
  for (int s = 0; s < nsteps; s++) {
    const int4 st = __ldg(tape + s);  // (src1, src2, dst, transform id), the same for every lane
    Fq2* d = R[st.z];
    const Fq2* x = R[st.x];
    if (st.y == R_ONE) {  // a transform or a copy
      if (st.w != T_IDENTITY)
        pair_transform(d, x, st.w, lane);
      else if (st.x != st.z)
        team_copy(d, x, lane);
    } else if (st.w == T_IDENTITY && st.x == st.y) {  // a square, in the cyclotomic subgroup
      team_cyclo_sqr(d, x, tm.s, lane);
    } else {
      if (st.w != T_IDENTITY) {
        pair_transform(tm.t, x, st.w, lane);
        x = tm.t;
      }
      team_mul(d, x, R[st.y], tm.s, lane);
    }
  }
  if (lane < 12) {  // canonical words of R[1], one Fq coordinate a lane
    uint32_t* w = R[1][lane / 2].c[lane % 2];
    uint32_t v[FQ_WORDS];
    fe_copy(v, w);
    fe_canon<FQ>(v, v);
    fe_copy(w, v);
  }
  team_sync();
  team_store12(out + b * FQ12_WORDS, R[1], lane);
}

// Op codes of pairing/pairing.py::OPS.
enum Fq12Op {
  OP_MUL, OP_SQUARE, OP_MUL_BY_034, OP_FROB1, OP_FROB2, OP_FROB3, OP_CONJ, OP_INV,
  OP_CYCLO_SQUARE
};

__global__ void __launch_bounds__(PAIR_THREADS, 1)
    fq12_op_kernel(int op, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   long long n, uint32_t* __restrict__ out) {
  __shared__ OpTeam teams[PAIR_TEAMS];
  const int lane = threadIdx.x & 31;
  OpTeam& tm = teams[threadIdx.x >> 5];
  const long long e = (long long)blockIdx.x * PAIR_TEAMS + (threadIdx.x >> 5);
  if (e >= n) return;  // the whole warp
  team_load12(tm.x, a + e * FQ12_WORDS, lane);
  if (op == OP_MUL) team_load12(tm.y, b + e * FQ12_WORDS, lane);
  if (op == OP_MUL_BY_034 && lane < LINE_WORDS / 4)
    reinterpret_cast<uint4*>(tm.y)[lane] =
        __ldg(reinterpret_cast<const uint4*>(b + e * LINE_WORDS) + lane);
  team_sync();
  switch (op) {
    case OP_MUL:
      team_mul(tm.r, tm.x, tm.y, tm.s, lane);
      break;
    case OP_SQUARE:
      team_sqr(tm.r, tm.x, tm.s, lane);
      break;
    case OP_MUL_BY_034:
      team_mul_034(tm.r, tm.x, tm.y, tm.s, lane);
      break;
    case OP_FROB1:
    case OP_FROB2:
    case OP_FROB3:
      pair_transform(tm.r, tm.x, T_FROB1 + (op - OP_FROB1), lane);
      break;
    case OP_CONJ:
      pair_transform(tm.r, tm.x, T_CONJ12, lane);
      break;
    case OP_INV:
      team_inv(tm.r, tm.x, tm.s, lane);
      break;
    default:  // OP_CYCLO_SQUARE
      team_cyclo_sqr(tm.r, tm.x, tm.s, lane);
      break;
  }
  team_store12(out + e * FQ12_WORDS, tm.r, lane);
}

}  // namespace svt

// frob (3, 6, 2, 8) words, host memory.  Synchronous; call once per device
// before the first launch of the kernels below.
extern "C" int svt_pairing_load_constants(const void* frob) {
  return (int)cudaMemcpyToSymbol(svt::PAIR_FROB, frob, sizeof(svt::PAIR_FROB));
}

static unsigned pair_blocks(long long n) {
  return (unsigned)((n + svt::PAIR_TEAMS - 1) / svt::PAIR_TEAMS);
}

// xs, ys, zs (B, 2, 8); dbl, addc (65, 2, 3, 2, 8); finals (2, 2, 3, 2, 8);
// has_add as bits 0..63 and 64 -> out (B, 2, 3, 2, 8).
extern "C" int svt_miller_loop(const void* xs, const void* ys, const void* zs, const void* dbl,
                               const void* addc, const void* finals, long long mask_lo,
                               long long mask_hi, long long nlanes, void* out, void* stream) {
  if (nlanes > 0)
    svt::miller_loop_kernel<<<pair_blocks(nlanes), svt::PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)xs, (const uint32_t*)ys, (const uint32_t*)zs, (const uint32_t*)dbl,
        (const uint32_t*)addc, (const uint32_t*)finals, (unsigned long long)mask_lo,
        (unsigned long long)mask_hi, nlanes, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// f (B, 2, 3, 2, 8); tape (nsteps, 4) int32 rows (src1, src2, dst,
// transform id) -> out (B, 2, 3, 2, 8) canonical.
extern "C" int svt_final_exp(const void* f, const void* tape, int nsteps, long long nlanes,
                             void* out, void* stream) {
  if (nlanes > 0)
    svt::final_exp_kernel<<<pair_blocks(nlanes), svt::PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, (const int4*)tape, nsteps, nlanes, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// a (n, 2, 3, 2, 8); b (n, 2, 3, 2, 8) for mul, (n, 3, 2, 8) for
// mul_by_034, else unread -> out (n, 2, 3, 2, 8).
extern "C" int svt_fq12_op(int op, const void* a, const void* b, long long n, void* out,
                           void* stream) {
  if (op < svt::OP_MUL || op > svt::OP_CYCLO_SQUARE) return (int)cudaErrorInvalidValue;
  if (n > 0)
    svt::fq12_op_kernel<<<pair_blocks(n), svt::PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        op, (const uint32_t*)a, (const uint32_t*)b, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
