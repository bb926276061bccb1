// The BN254 pairing decide on the card (Hopper, sm_90a; plain C interface,
// ctypes: _build.py, pairing/pairing.py):
//
// * svt_miller_loop replaces the JAX package's pairing/pairing.py::
//   miller_loop (:151-164, positional path) with _mul_lines (:99-117): the
//   multi-Miller loop of every lane over the G2 lines prepared on the host
//   (65 steps; f^2, then each pair's doubling line, then its addition line
//   where has_add is set; the two Frobenius end steps last).
// * svt_final_exp replaces pairing/pairing.py::final_exponentiation
//   (:257-262) with pairing/fq12_vm.py::run_tape (:145-160): the easy part
//   m = conj(f) f^-1, then the 406-step hard-part tape over 8 Fq12
//   registers; the result canonical.
// * svt_fq12_op: one tower operation per launch, by op code (tower/
//   tower.py :223-257, pairing/pairing.py::f12_frobenius :213-232).  No
//   path launches it: chip_smoke.py and the card tests use it to find which
//   tower function is wrong when a path kernel disagrees.
//
// What bounds them.  Not bytes (an Fq12 is 384 B a lane; the lines, 50 KB,
// are the same for every lane), and, at the verify batch, not the card's
// multiply rate either: 1,024 proofs x ~30,000 Fq multiplies x 136
// multiply-adds is 0.25 ms of the whole card.  Each proof's decide is one
// chain of dependent Fq12 products (every Miller step squares the f the
// step before made; every tape step reads a register an earlier step
// wrote), so the time is the length of that chain at a lone warp's
// multiply latency (~830 clocks, PERF.md): ~14,000 multiplies for the
// Miller loop and ~16,000 for the final exponentiation.  Measured: 8.65 ms
// and 10.40 ms at 1,024 proofs, 8.51 and 10.37 for one (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md has the runs), ~1,200-1,280 clocks per multiply:
// the calls and local-memory traffic below cost ~1.5x the inlined chains.
//
// This first design is the simple one: one thread per proof, blocks of one
// warp (so the lanes of a batch spread over as many SMs as possible), f and
// the tape's registers in local memory (L1-cached), the Fq2 product as a
// call (tower.cuh).  The lines and the tape are read by every lane of a
// warp at the same address (one broadcast load); the Frobenius coefficient
// sets sit in __constant__ memory.  The kernels skip what the plain
// formulas do for nothing: the first Miller step's square of f = 1, a
// tape multiply by the register that holds 1, and the identity transform;
// conj12 is a negation, not a product by -1.  The field elements are the
// plain versions'; compare canonically.  A warp per proof with the Fq2
// products spread over its lanes, cyclotomic squares and a sparse line
// product are later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "tower.cuh"

namespace svt {

constexpr int PAIR_BLOCK = 32;       // one warp a block
// The KZG decide's Miller loop: two pairs, (lhs, g2) and (rhs, -s g2), over
// the 65 steps of the NAF of 6x + 2 (pairing/pairing.py: NPAIRS, NSTEPS).
constexpr int PAIR_NPAIRS = 2;
constexpr int PAIR_NSTEPS = 65;
constexpr int LINE_WORDS = 3 * 2 * FQ_WORDS;  // (c0, c3, c4) coefficients of one line
constexpr int NREG = 8;              // tape registers (pairing/fq12_vm.py)
constexpr int R_ONE = 0;             // the register that holds 1
// Transform ids of the tape (fq12_vm.py): identity, conj12, frob^1..3.
constexpr int T_IDENTITY = 0, T_CONJ12 = 1, T_FROB1 = 2;

// Frobenius^1, ^2, ^3: six Fq2 coefficients each (fq12_vm.transform_table),
// loaded by svt_pairing_load_constants.
static __constant__ uint32_t PAIR_FROB[3][6][2][FQ_WORDS];

// t = transform tid of a (tid >= T_CONJ12; the identity is the caller's).
__device__ __forceinline__ void fq12_transform(Fq12& t, const Fq12& a, int tid) {
  if (tid == T_CONJ12) {
    fq12_conj(t, a);
  } else {
    const int k = tid - T_FROB1;  // power - 1
    fq12_frob(t, a, (k & 1) == 0, PAIR_FROB[k]);
  }
}

// f *= line_k for each pair k: c0 = c[0] y, c3 = c[1] x, c4 = c[2] z.  The
// line words are the batch's own (one broadcast load per word).
__device__ __forceinline__ void mul_lines(Fq12& f, const uint32_t* __restrict__ lines,
                                          const uint32_t* __restrict__ xs,
                                          const uint32_t* __restrict__ ys,
                                          const uint32_t* __restrict__ zs) {
#pragma unroll 1
  for (int k = 0; k < PAIR_NPAIRS; k++) {
    const uint32_t* c = lines + k * LINE_WORDS;
    Fq2 c0, c3, c4;
    uint32_t pt[FQ_WORDS];
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) {
      c0.c[0][i] = __ldg(c + i);
      c0.c[1][i] = __ldg(c + FQ_WORDS + i);
      c3.c[0][i] = __ldg(c + 2 * FQ_WORDS + i);
      c3.c[1][i] = __ldg(c + 3 * FQ_WORDS + i);
      c4.c[0][i] = __ldg(c + 4 * FQ_WORDS + i);
      c4.c[1][i] = __ldg(c + 5 * FQ_WORDS + i);
    }
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) pt[i] = ys[k * FQ_WORDS + i];
    fq2_smul(c0, c0, pt);
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) pt[i] = xs[k * FQ_WORDS + i];
    fq2_smul(c3, c3, pt);
#pragma unroll
    for (int i = 0; i < FQ_WORDS; i++) pt[i] = zs[k * FQ_WORDS + i];
    fq2_smul(c4, c4, pt);
    fq12_mul_by_034(f, f, c0, c3, c4);
  }
}

__global__ void __launch_bounds__(PAIR_BLOCK)
    miller_loop_kernel(const uint32_t* __restrict__ xs, const uint32_t* __restrict__ ys,
                       const uint32_t* __restrict__ zs, const uint32_t* __restrict__ dbl,
                       const uint32_t* __restrict__ addc, const uint32_t* __restrict__ finals,
                       unsigned long long mask_lo, unsigned long long mask_hi, long long nlanes,
                       uint32_t* __restrict__ out) {
  const long long b = (long long)blockIdx.x * PAIR_BLOCK + threadIdx.x;
  if (b >= nlanes) return;
  const long long p0 = b * PAIR_NPAIRS * FQ_WORDS;
  constexpr int step_words = PAIR_NPAIRS * LINE_WORDS;
  Fq12 f;
  fq12_one(f);
#pragma unroll 1
  for (int i = 0; i < PAIR_NSTEPS; i++) {
    if (i > 0) fq12_mul(f, f, f);  // step 0 squares f = 1
    mul_lines(f, dbl + i * step_words, xs + p0, ys + p0, zs + p0);
    const bool has = i < 64 ? (mask_lo >> i) & 1ull : (mask_hi >> (i - 64)) & 1ull;
    if (has) mul_lines(f, addc + i * step_words, xs + p0, ys + p0, zs + p0);
  }
  mul_lines(f, finals, xs + p0, ys + p0, zs + p0);
  mul_lines(f, finals + step_words, xs + p0, ys + p0, zs + p0);
  fq12_store(out + b * FQ12_WORDS, f);
}

__global__ void __launch_bounds__(PAIR_BLOCK)
    final_exp_kernel(const uint32_t* __restrict__ fin, const int4* __restrict__ tape, int nsteps,
                     long long nlanes, uint32_t* __restrict__ out) {
  const long long b = (long long)blockIdx.x * PAIR_BLOCK + threadIdx.x;
  if (b >= nlanes) return;
  Fq12 R[NREG], f, t;
  fq12_load(f, fin + b * FQ12_WORDS);
  // easy part, first half: m = conj(f) f^-1 = f^(p^6 - 1)
  fq12_inv(t, f);
  fq12_conj(f, f);
  fq12_mul(R[1], f, t);
#pragma unroll 1
  for (int r = 0; r < NREG; r++)
    if (r != 1) fq12_one(R[r]);
  // R[dst] = transform(R[src1]) * R[src2]; fq12_mul reads both operands
  // before it writes, so dst may be src1 or src2 (t.mul(M, A, M),
  // t.square(C, C), t.mul(T, T, E) in the tape).
#pragma unroll 1
  for (int s = 0; s < nsteps; s++) {
    const int4 st = __ldg(tape + s);  // (src1, src2, dst, transform id)
    const Fq12* a = &R[st.x];
    if (st.w != T_IDENTITY) {
      fq12_transform(t, R[st.x], st.w);
      a = &t;
    }
    if (st.y == R_ONE) {
      if (a != &R[st.z]) R[st.z] = *a;
    } else {
      fq12_mul(R[st.z], *a, R[st.y]);
    }
  }
  Fq12& res = R[1];
  uint32_t* w = &res.c[0].c[0].c[0][0];
#pragma unroll 1
  for (int i = 0; i < 12; i++) fe_canon<FQ>(w + i * FQ_WORDS, w + i * FQ_WORDS);
  fq12_store(out + b * FQ12_WORDS, res);
}

// Op codes of pairing/pairing.py::OPS.
enum Fq12Op { OP_MUL, OP_SQUARE, OP_MUL_BY_034, OP_FROB1, OP_FROB2, OP_FROB3, OP_CONJ, OP_INV };

__global__ void __launch_bounds__(64)
    fq12_op_kernel(int op, const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                   long long n, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 64 + threadIdx.x;
  if (i >= n) return;
  Fq12 x, y, r;
  fq12_load(x, a + i * FQ12_WORDS);
  switch (op) {
    case OP_MUL:
      fq12_load(y, b + i * FQ12_WORDS);
      fq12_mul(r, x, y);
      break;
    case OP_SQUARE:
      fq12_mul(r, x, x);
      break;
    case OP_MUL_BY_034: {
      const uint32_t* c = b + i * LINE_WORDS;
      Fq2 c0, c3, c4;
#pragma unroll
      for (int k = 0; k < FQ_WORDS; k++) {
        c0.c[0][k] = c[k];
        c0.c[1][k] = c[FQ_WORDS + k];
        c3.c[0][k] = c[2 * FQ_WORDS + k];
        c3.c[1][k] = c[3 * FQ_WORDS + k];
        c4.c[0][k] = c[4 * FQ_WORDS + k];
        c4.c[1][k] = c[5 * FQ_WORDS + k];
      }
      fq12_mul_by_034(r, x, c0, c3, c4);
      break;
    }
    case OP_FROB1:
    case OP_FROB2:
    case OP_FROB3:
      fq12_transform(r, x, T_FROB1 + (op - OP_FROB1));
      break;
    case OP_CONJ:
      fq12_conj(r, x);
      break;
    default:  // OP_INV
      fq12_inv(r, x);
      break;
  }
  fq12_store(out + i * FQ12_WORDS, r);
}

}  // namespace svt

// frob (3, 6, 2, 8) words, host memory.  Synchronous; call once per device
// before the first launch of the kernels below.
extern "C" int svt_pairing_load_constants(const void* frob) {
  return (int)cudaMemcpyToSymbol(svt::PAIR_FROB, frob, sizeof(svt::PAIR_FROB));
}

// xs, ys, zs (B, 2, 8); dbl, addc (65, 2, 3, 2, 8); finals (2, 2, 3, 2, 8);
// has_add as bits 0..63 and 64 -> out (B, 2, 3, 2, 8).
extern "C" int svt_miller_loop(const void* xs, const void* ys, const void* zs, const void* dbl,
                               const void* addc, const void* finals, long long mask_lo,
                               long long mask_hi, long long nlanes, void* out, void* stream) {
  if (nlanes > 0)
    svt::miller_loop_kernel<<<(unsigned)((nlanes + svt::PAIR_BLOCK - 1) / svt::PAIR_BLOCK),
                              svt::PAIR_BLOCK, 0, (cudaStream_t)stream>>>(
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
    svt::final_exp_kernel<<<(unsigned)((nlanes + svt::PAIR_BLOCK - 1) / svt::PAIR_BLOCK),
                            svt::PAIR_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, (const int4*)tape, nsteps, nlanes, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// a (n, 2, 3, 2, 8); b (n, 2, 3, 2, 8) for mul, (n, 3, 2, 8) for
// mul_by_034, else unread -> out (n, 2, 3, 2, 8).
extern "C" int svt_fq12_op(int op, const void* a, const void* b, long long n, void* out,
                           void* stream) {
  if (op < svt::OP_MUL || op > svt::OP_INV) return (int)cudaErrorInvalidValue;
  if (n > 0)
    svt::fq12_op_kernel<<<(unsigned)((n + 63) / 64), 64, 0, (cudaStream_t)stream>>>(
        op, (const uint32_t*)a, (const uint32_t*)b, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
