// svt_fr_tape: a recorded Fr program (ff/fr_tape.py) run for a batch of
// lanes in one launch, for Hopper (sm_90a), bound through a plain C
// interface (ctypes, see _build.py).
//
// It replaces the succinct verifier's scalar algebra, which the JAX package
// compiles into its one jitted verify program (parallel/batch_verify.py
// :86-108, XLA fusing ff/jnp_field.py::LimbField.mul :145, batch_inv :236,
// pow_static :200), and which the port ran as one svt_field_* launch per op
// (558 launches a verify batch, ~1.7 us of device time each behind ~90 us of
// host work).  Every op is lane-wise and the sequence is fixed by the
// protocol, so the host records it once and this kernel replays it.
//
// What bounds it.  A lane's work is a few hundred rows (594 for vanilla
// PLONK k=10 with SHPLONK: 328 products, 26 outputs, 3 inversions, 237
// cheap rows), and a batch is at most a few thousand lanes: the card is
// nearly empty, so the time is a lane's latency, set by its dependent
// chain of products and inversions.  The operations bound (136
// multiply-adds a product over the card's 16.7e12 per s) is two orders of
// magnitude below.
//
// Design.
//   * A team of T threads (T = 1, 2, 4, 8) runs one lane, a block is one
//     warp of 32 / T lanes.  The host's list scheduler (fr_tape.py::
//     schedule) cuts the tape into steps of up to T independent rows of
//     one op class; thread r of the team runs place r of each step (op NOP:
//     nothing), and a __syncwarp separates the steps.  The classes
//     (products with OUT, squares, inversions, the cheap rows) keep a step's
//     threads on one branch; independent inversions share a step, so the
//     CPE's and SHPLONK's first cost one inversion's time.  Every thread of
//     the warp passes every barrier: a lane beyond B reads lane B - 1's
//     inputs, runs the steps, and stores no output (g1_team.cuh does the
//     same).  T = 1 is the tape in order, one row a step.
//   * INV is fe_inv.cuh's binary GCD (fe_inv_gcd<FR>), ~13 rounds of cheap
//     integer steps where Fermat's fe_inv was ~381 dependent products.  The
//     verifier's inversions take public values (challenge-derived
//     denominators), so a variable-time algorithm is allowed.  Its output
//     is canonical (A R -> A^-1 R in [0, p), 0 -> 0); the plain twin's INV is
//     LimbField's Fermat inverse after canon, the same word.
//   * The slot file lives in shared memory, [slot][lane of the block][8
//     words]: 32 B a slot and lane, 1 KB a slot at T = 1 and 1 KB / T at T.
//     It holds the schedule's slots, then the lane's inputs and the
//     constants, which a prologue copies in (the team's threads a row each),
//     so that every operand is a shared-memory read and no step waits on
//     device memory but for OUT's stores (measured 12-15% faster at T = 8
//     than reading inputs and constants from device memory at their
//     steps, NVIDIA H100 80GB HBM3 at 700 W, kernel_compare.py).  The
//     scheduler assigns slots anew (a slot is free from the step after its
//     last reader's), so no row writes a slot its step reads; it refuses a
//     tape whose slots, inputs and constants exceed the 227 KB a block may
//     use (227 T slots).  An operand is two 16-byte loads.  A 16-byte
//     shared access is served a quarter-warp (8 threads) at a time: slot s
//     of lane l starts
//     at 16-byte unit 2 (s L + l), L = 32 / T >= 4, so a thread's bank quad
//     is 2 (l mod 4) + half, whatever the slot; threads 4-7 of each eight
//     take their halves in the other order, so each quarter-warp touches all
//     eight quads and a step's reads and writes are free of bank conflicts
//     at every T.
//   * The schedule's rows (int4: op, dst, src1, src2) are read through the
//     read-only cache a step ahead: place r of a step is one broadcast to
//     the warp's teams.  Inputs (n_in, B, 8) and outputs (n_out, B, 8) are
//     row-major per input, 16-byte loads and stores.
//
// The ops are fq.cuh's Fr functions on the lazy [0, 2p] contract: fe_mul
// (fe_sqr in a step of squares: the same words), fe_add, fe_sub, fe_neg,
// fe_canon, the two selects of WordField.batch_inv, OUT (from_mont to a
// canonical plain word: the product by plain 1, then canon) and the
// canonical inverse.  Each is the same function of its inputs as its plain
// twin (fr_tape.py::plain_row), so kernel and run_plain agree word for word
// on every value, lazy ones included.

#include <cuda_runtime.h>

#include <cstdint>

#include "fe_inv.cuh"
#include "fq.cuh"

namespace svt {

constexpr int TAPE_WARP = 32;  // threads a block
constexpr int TAPE_SMEM_BYTES = 232448;  // the shared memory a block may use
enum { T_MUL, T_ADD, T_SUB, T_NEG, T_INV, T_CANON, T_ONE_IF_ZERO, T_ZERO_IF_ZERO, T_OUT, T_NOP };
enum { K_SLOT, K_INPUT, K_CONST };
constexpr int T_KIND_SHIFT = 24;
constexpr int T_INDEX_MASK = (1 << T_KIND_SHIFT) - 1;

// One thread's view: its lane's slots at slots[k * 8 L], slot k (the
// schedule's slots, then the lane's inputs from slot in_base, then the
// constants from slot const_base); where the lane is below B, its outputs.
struct TapeLane {
  uint32_t* slots;  // slot 0 of this lane
  int slot_stride;  // words from one slot of the lane to the next: 8 L
  bool swap;        // take the second 16 bytes first (bank quads)
  int in_base, const_base;
  uint32_t* outputs;
  long long lane, B;
};

__device__ __forceinline__ void tape_load_smem(uint32_t r[FQ_WORDS], const uint32_t* p,
                                               bool swap) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = q[swap ? 1 : 0], y = q[swap ? 0 : 1];
  const uint4 lo = swap ? y : x, hi = swap ? x : y;
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void tape_store_smem(uint32_t* p, const uint32_t r[FQ_WORDS],
                                                bool swap) {
  uint4* q = reinterpret_cast<uint4*>(p);
  const uint4 lo = make_uint4(r[0], r[1], r[2], r[3]), hi = make_uint4(r[4], r[5], r[6], r[7]);
  q[swap ? 1 : 0] = swap ? hi : lo;
  q[swap ? 0 : 1] = swap ? lo : hi;
}

// An operand from the slot file: a slot, an input row or a constant, each
// a slot since the prologue.
__device__ __forceinline__ void tape_fetch(uint32_t r[FQ_WORDS], int operand, const TapeLane& t) {
  const int kind = operand >> T_KIND_SHIFT, idx = operand & T_INDEX_MASK;
  const int slot = idx + (kind == K_INPUT ? t.in_base : kind == K_CONST ? t.const_base : 0);
  tape_load_smem(r, t.slots + (long long)slot * t.slot_stride, t.swap);
}

// All eight words of canon(a) are zero.
__device__ __forceinline__ bool tape_is_zero(const uint32_t a[FQ_WORDS]) {
  uint32_t c[FQ_WORDS], acc = 0;
  fe_canon<FR>(c, a);
#pragma unroll
  for (int w = 0; w < FQ_WORDS; w++) acc |= c[w];
  return acc == 0;
}

// One row of the schedule for this thread's lane.
__device__ __forceinline__ void fr_tape_row(const int4 row, const TapeLane& t) {
  const int op = row.x;
  uint32_t a[FQ_WORDS], b[FQ_WORDS], r[FQ_WORDS];
  tape_fetch(a, row.z, t);
  if (op == T_ADD || op == T_SUB || op == T_ZERO_IF_ZERO || (op == T_MUL && row.z != row.w))
    tape_fetch(b, row.w, t);
  if (op == T_MUL && row.z == row.w) {
    fe_sqr<FR>(r, a);
  } else if (op == T_MUL || op == T_OUT) {  // one product for both, OUT's by plain 1
    if (op == T_OUT) {
#pragma unroll
      for (int w = 0; w < FQ_WORDS; w++) b[w] = w == 0 ? 1u : 0u;
    }
    fe_mul<FR>(r, a, b);
    if (op == T_OUT) {
      uint32_t c[FQ_WORDS];
      fe_canon<FR>(c, r);
      if (t.lane < t.B) {
        uint4* d = reinterpret_cast<uint4*>(t.outputs +
                                            ((long long)row.y * t.B + t.lane) * FQ_WORDS);
        d[0] = make_uint4(c[0], c[1], c[2], c[3]);
        d[1] = make_uint4(c[4], c[5], c[6], c[7]);
      }
      return;
    }
  } else if (op == T_INV) {
    fe_inv_gcd<FR>(r, a);
  } else {
    switch (op) {
      case T_ADD: fe_add<FR>(r, a, b); break;
      case T_SUB: fe_sub<FR>(r, a, b); break;
      case T_NEG: fe_neg<FR>(r, a); break;
      case T_CANON: fe_canon<FR>(r, a); break;
      case T_ONE_IF_ZERO: {
        const bool z = tape_is_zero(a);
#pragma unroll
        for (int w = 0; w < FQ_WORDS; w++) r[w] = z ? FIELD_ONE[FR][w] : a[w];
        break;
      }
      default: {  // T_ZERO_IF_ZERO
        const bool z = tape_is_zero(a);
#pragma unroll
        for (int w = 0; w < FQ_WORDS; w++) r[w] = z ? 0u : b[w];
        break;
      }
    }
  }
  tape_store_smem(t.slots + (long long)row.y * t.slot_stride, r, t.swap);
}

// Thread tid of the block is member r = tid / L of the team of lane l =
// tid % L (L = 32 / team lanes a block), so the threads of one member are
// adjacent and the steps' broadcasts line up.  The prologue copies the
// lane's n_in inputs and the n_const constants into the slot file after
// the schedule's n_slots (member r the rows r, r + team, ...), so that no
// step waits on device memory for an operand; each step's row is loaded
// one step ahead.
__global__ void __launch_bounds__(TAPE_WARP)
    fr_tape_kernel(const int4* __restrict__ steps, int n_steps, int team, int n_slots,
                   const uint32_t* __restrict__ consts, int n_const,
                   const uint32_t* __restrict__ inputs, int n_in, uint32_t* __restrict__ outputs,
                   long long B) {
  extern __shared__ uint4 tape_slot_file[];  // [slot][lane of the block][word]
  const int L = TAPE_WARP / team, tid = (int)threadIdx.x, l = tid % L, r = tid / L;
  const long long lane = (long long)blockIdx.x * L + l, in_lane = lane < B ? lane : B - 1;
  const TapeLane t{reinterpret_cast<uint32_t*>(tape_slot_file) + l * FQ_WORDS, L * FQ_WORDS,
                   ((tid >> 2) & 1) != 0, n_slots, n_slots + n_in, outputs, lane, B};
#pragma unroll 4
  for (int i = r; i < n_in + n_const; i += team) {
    const uint4* s = reinterpret_cast<const uint4*>(
        i < n_in ? inputs + ((long long)i * B + in_lane) * FQ_WORDS
                 : consts + (long long)(i - n_in) * FQ_WORDS);
    const uint4 lo = s[0], hi = s[1];
    const uint32_t v[FQ_WORDS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    tape_store_smem(t.slots + (long long)(n_slots + i) * t.slot_stride, v, t.swap);
  }
  __syncwarp();
  int4 row = n_steps ? __ldg(steps + r) : int4{};
#pragma unroll 1
  for (int k = 0; k < n_steps; k++) {
    const int4 next = k + 1 < n_steps ? __ldg(steps + (long long)(k + 1) * team + r) : row;
    if (row.x != T_NOP) fr_tape_row(row, t);
    __syncwarp();
    row = next;
  }
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  steps (n_steps, team, 4) int32
// rows of the schedule, consts (n_const, 8), inputs (n_in, B, 8) and
// outputs (n_out, B, 8) words; n_slots the schedule's slot count.  The slot
// file holds n_slots + n_in + n_const slots of 32 / team lanes: at most
// 227 team.
extern "C" int svt_fr_tape(const void* steps, int n_steps, int team, const void* consts,
                           int n_const, const void* inputs, int n_in, void* outputs, long long B,
                           int n_slots, void* stream) {
  if (!(team == 1 || team == 2 || team == 4 || team == 8) || n_steps < 0 || B < 0 ||
      n_const < 0 || n_in < 0 || n_slots < 1)
    return (int)cudaErrorInvalidValue;
  const int lanes = svt::TAPE_WARP / team;
  const long long smem = ((long long)n_slots + n_in + n_const) * lanes * svt::FQ_WORDS *
                         (long long)sizeof(uint32_t);
  if (smem > svt::TAPE_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (B == 0 || n_steps == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(svt::fr_tape_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + lanes - 1) / lanes);
  svt::fr_tape_kernel<<<blocks, svt::TAPE_WARP, (size_t)smem, (cudaStream_t)stream>>>(
      (const int4*)steps, n_steps, team, n_slots, (const uint32_t*)consts, n_const,
      (const uint32_t*)inputs, n_in, (uint32_t*)outputs, B);
  return (int)cudaGetLastError();
}
