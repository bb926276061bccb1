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
// Design.  One thread per lane, one warp per block (a batch of 1,024 lanes
// is 32 blocks).  A lane's work is one chain of dependent rows: ~1,500 Fr
// multiplies for vanilla PLONK k=10, three quarters of them in the three
// inversions.  Values live in a slot file in shared memory laid out
// [slot][word][lane], lane fastest: a warp's access to one word of one slot
// touches 32 consecutive banks, no conflicts.  A slot costs 1 KB a block,
// so the 227 KB a block may use hold 227 slots; the recorder assigns slots
// by a linear scan over last uses and refuses a program that needs more
// (vanilla PLONK k=10 keeps 40 live).  The rows (int4: op, dst, src1, src2)
// and the constant table are read through the read-only cache: every lane
// of the warp reads the same row, one broadcast.  Inputs (n_in, B, 8) and
// outputs (n_out, B, 8) are row-major per input, so a warp's 16-byte loads
// of one input are coalesced.  An operand is kind << 24 | index (a slot, an
// input row, a constant).
//
// The ops are fq.cuh's Fr functions on the lazy [0, 2p] contract: fe_mul
// (fe_sqr where both operands are the same: the same words), fe_add,
// fe_sub, fe_neg, fe_inv, fe_canon, the two selects of WordField.batch_inv,
// and OUT, from_mont to a canonical plain word.  Each is the same function
// of its inputs as its plain twin, so kernel and run_plain agree word for
// word on every value, lazy ones included.
//
// Bound: one lane runs its rows in sequence, so at a batch of 1,024 the
// card is nearly empty and the chain sets the time: ~1,500 multiplies at the
// ~800 clocks a lone warp waits per multiply (PERF.md).  The operations
// bound (136 multiply-adds a multiply over the card's 16.7e12 per s) is two
// orders of magnitude below.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int TAPE_LANES = 32;  // lanes (threads) a block
constexpr int TAPE_MAX_SLOTS = 227;  // 1 KB a slot of the 227 KB a block may use
enum { T_MUL, T_ADD, T_SUB, T_NEG, T_INV, T_CANON, T_ONE_IF_ZERO, T_ZERO_IF_ZERO, T_OUT };
enum { K_SLOT, K_INPUT, K_CONST };
constexpr int T_KIND_SHIFT = 24;
constexpr int T_INDEX_MASK = (1 << T_KIND_SHIFT) - 1;

// One lane's view: word w of slot k at slots[k * 8 * TAPE_LANES + w * TAPE_LANES].
struct TapeLane {
  uint32_t* slots;
  const uint32_t* inputs;
  const uint32_t* consts;
  uint32_t* outputs;
  long long lane, B;
};

__device__ __forceinline__ void tape_fetch(uint32_t r[FQ_WORDS], int operand, const TapeLane& t) {
  const int kind = operand >> T_KIND_SHIFT, idx = operand & T_INDEX_MASK;
  if (kind == K_SLOT) {
    const uint32_t* s = t.slots + (long long)idx * FQ_WORDS * TAPE_LANES;
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) r[w] = s[w * TAPE_LANES];
  } else if (kind == K_INPUT) {
    const uint4* s = reinterpret_cast<const uint4*>(t.inputs + ((long long)idx * t.B + t.lane) * FQ_WORDS);
    const uint4 lo = s[0], hi = s[1];
    r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
    r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
  } else {
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) r[w] = __ldg(t.consts + idx * FQ_WORDS + w);
  }
}

// All eight words of canon(a) are zero.
__device__ __forceinline__ bool tape_is_zero(const uint32_t a[FQ_WORDS]) {
  uint32_t c[FQ_WORDS], acc = 0;
  fe_canon<FR>(c, a);
#pragma unroll
  for (int w = 0; w < FQ_WORDS; w++) acc |= c[w];
  return acc == 0;
}

// Run the whole tape for one lane.
__device__ void fr_tape_lane(const int4* __restrict__ tape, int n_rows, const TapeLane& t) {
#pragma unroll 1
  for (int i = 0; i < n_rows; i++) {
    const int4 row = __ldg(tape + i);
    const int op = row.x;
    uint32_t a[FQ_WORDS], b[FQ_WORDS], r[FQ_WORDS];
    tape_fetch(a, row.z, t);
    if (op == T_MUL || op == T_ADD || op == T_SUB || op == T_ZERO_IF_ZERO) tape_fetch(b, row.w, t);
    switch (op) {
      case T_MUL:
        if (row.z == row.w)
          fe_sqr<FR>(r, a);
        else
          fe_mul<FR>(r, a, b);
        break;
      case T_ADD: fe_add<FR>(r, a, b); break;
      case T_SUB: fe_sub<FR>(r, a, b); break;
      case T_NEG: fe_neg<FR>(r, a); break;
      case T_INV: fe_inv<FR>(r, a); break;
      case T_CANON: fe_canon<FR>(r, a); break;
      case T_ONE_IF_ZERO: {
        const bool z = tape_is_zero(a);
#pragma unroll
        for (int w = 0; w < FQ_WORDS; w++) r[w] = z ? FIELD_ONE[FR][w] : a[w];
        break;
      }
      case T_ZERO_IF_ZERO: {
        const bool z = tape_is_zero(a);
#pragma unroll
        for (int w = 0; w < FQ_WORDS; w++) r[w] = z ? 0u : b[w];
        break;
      }
      default: {  // T_OUT: from_mont, the product by plain 1, then canon
        uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}, m[FQ_WORDS];
        fe_mul<FR>(m, a, one);
        fe_canon<FR>(r, m);
        uint4* d = reinterpret_cast<uint4*>(t.outputs + ((long long)row.y * t.B + t.lane) * FQ_WORDS);
        d[0] = make_uint4(r[0], r[1], r[2], r[3]);
        d[1] = make_uint4(r[4], r[5], r[6], r[7]);
        continue;
      }
    }
    uint32_t* s = t.slots + (long long)row.y * FQ_WORDS * TAPE_LANES;
#pragma unroll
    for (int w = 0; w < FQ_WORDS; w++) s[w * TAPE_LANES] = r[w];
  }
}

__global__ void __launch_bounds__(TAPE_LANES)
    fr_tape_kernel(const int4* __restrict__ tape, int n_rows, const uint32_t* __restrict__ consts,
                   const uint32_t* __restrict__ inputs, uint32_t* __restrict__ outputs,
                   long long B) {
  extern __shared__ uint32_t tape_slot_file[];  // [slot][word][lane]
  const long long lane = (long long)blockIdx.x * TAPE_LANES + threadIdx.x;
  if (lane >= B) return;  // lanes share no data: no barrier follows
  const TapeLane t{tape_slot_file + threadIdx.x, inputs, consts, outputs, lane, B};
  fr_tape_lane(tape, n_rows, t);
}

}  // namespace svt

// C entry point: launches on the caller's stream, allocates nothing, and
// returns a cudaError_t (0 = launched).  tape (n_rows, 4) int32 rows,
// consts (n_const, 8), inputs (n_in, B, 8) and outputs (n_out, B, 8) words;
// n_slots the tape's slot count (at most 227).
extern "C" int svt_fr_tape(const void* tape, int n_rows, const void* consts, const void* inputs,
                           void* outputs, long long B, int n_slots, void* stream) {
  if (n_slots < 1 || n_slots > svt::TAPE_MAX_SLOTS || n_rows < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_rows == 0) return 0;
  const int smem = n_slots * svt::FQ_WORDS * svt::TAPE_LANES * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(svt::fr_tape_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + svt::TAPE_LANES - 1) / svt::TAPE_LANES);
  svt::fr_tape_kernel<<<blocks, svt::TAPE_LANES, smem, (cudaStream_t)stream>>>(
      (const int4*)tape, n_rows, (const uint32_t*)consts, (const uint32_t*)inputs,
      (uint32_t*)outputs, B);
  return (int)cudaGetLastError();
}
