// Elementwise Montgomery arithmetic over Fq and Fr for Hopper (sm_90a),
// bound through a plain C interface (ctypes, see _build.py and
// ff/word_field.py).  Elements are 8 little-endian 32-bit words.
//
// These replace work the JAX package leaves to XLA
// (ff/jnp_field.py::LimbField.mul :145, add :127, sub :132, neg :141,
// inv :211, canon :121).  Torch has no 256-bit modular arithmetic, and the
// plain limb twin (ff/limb_field.py) synchronizes the host once per carry
// pass, so on the card every op is one launch of a kernel here.
//
// svt_points_to_fr is the one launch the paths make: the Poseidon
// transcript's Fq -> Fr map (the JAX package's
// transcript/poseidon_transcript.py::fq_to_fr :31: from_mont, then Fr's
// to_mont, relying on q < 2r) over a verify batch's stream points, and, in
// projective mode, the fold's affine normalisation before that map
// (ec/curve.py::to_affine :261 under pcs/kzg/accumulation.py::
// read_proof_stacked :80-92): Z^-1 by fe_inv.cuh's binary GCD, x Z^-1 and
// y Z^-1, then the map of each.  It runs the fq.cuh / fe_inv.cuh functions
// in the order of the five single-op launches it replaced (inv, mul, then
// mul by plain 1, canon, and Fr's mul by R^2), so its words equal theirs:
// after the canon every word is a function of the value alone.  The
// identity (Z = 0, p or 2p) inverts to 0 and maps to (0, 0), as the JAX
// package's to_affine + fq_to_fr.  A third mode, projective to affine,
// stops before the map: canonical affine Fq Montgomery (x, y), the words
// the keccak read absorbs for an instance commitment (the JAX package's
// G1.to_affine under transcript/evm_transcript.py::EvmTranscript.
// common_ec_point :119-124, which hashes the coordinates' canonical values:
// the canon here only fixes the representative); the identity gives
// (0, 0).  On that path it takes the place of msm/cuda_ops.py::affine_xy's
// two single-op launches (inv, mul).  Affine mode is a thread an element
// in 256-thread blocks; the projective modes a thread a point in 32-thread
// blocks, as the inversion (latency-bound: the tree's 2,048 points spread
// over 64 SMs, not 8).  Bounds: affine 272 multiply-adds against 64 bytes an
// element; projective the inversion's steps and update rows for the rounds
// the data needs, plus 6 products, against 160 bytes a point.  At the
// paths' shapes both sit at their chain: the inversion's rounds, then three
// dependent products (chip_smoke.py's `points_to_fr_work`).
//
// The single-op launches (mul, add, sub, neg, inv, canon) apply one op to
// n elements, one thread per element; either operand may be a single
// element broadcast over all n (stride 0).  `field` is the tag of fq.cuh
// (0 = Fq, 1 = Fr).  No path launches them any more except the
// old-accumulator limb decode (pcs/kzg/accumulator.py: Fr from_mont, Fq
// to_mont); the succinct verifier's scalar algebra runs them only under
// the eager TorchLoader, the witness of the recorded Fr program that the
// verify path runs as one svt_fr_tape launch (csrc/fr_tape.cu).  Bounds:
// mul is 136 multiply-adds against 96 bytes moved (0.36 bytes per
// multiply-add, near the H100's ridge of 0.2); add, sub, neg and canon do
// no multiplies and are bound by bytes.
//
// inv is fe_inv.cuh's binary GCD (a variable-time inversion: the inputs are
// public), not fq.cuh's Fermat chain of ~370 dependent products (0.21 ms at
// any batch, a lone warp's latency): ~12 rounds of 30 cheap 64-bit steps and
// one 2x2 update by factors of at most 2^30 (80 multiply-adds), and its
// output is canonical, in [0, p).  A latency-bound thread per element, so
// it launches 32-thread blocks.  Its bound counts the steps' least integer
// instructions and the updates' multiply-adds for the rounds the data needs
// (chip_smoke.py's `inv_work`).

#include <cuda_runtime.h>

#include <cstdint>

#include "fe_inv.cuh"
#include "fq.cuh"

namespace svt {

constexpr int FE_THREADS = 256;
constexpr int INV_THREADS = 32;  // a block a warp: a small batch spreads over the SMs
enum { OP_MUL, OP_ADD, OP_SUB, OP_NEG, OP_INV, OP_CANON };

__device__ __forceinline__ void fe_load(uint32_t r[FQ_WORDS], const uint32_t* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const uint4 lo = s[0], hi = s[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void fe_store(uint32_t* __restrict__ dst, const uint32_t r[FQ_WORDS]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(r[0], r[1], r[2], r[3]);
  d[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

template <int F, int OP>
__global__ void __launch_bounds__(FE_THREADS)
    field_binary_kernel(const uint32_t* __restrict__ a, long long sa,
                        const uint32_t* __restrict__ b, long long sb,
                        uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * FE_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], y[FQ_WORDS], r[FQ_WORDS];
  fe_load(x, a + i * sa);
  fe_load(y, b + i * sb);
  if constexpr (OP == OP_MUL) fe_mul<F>(r, x, y);
  if constexpr (OP == OP_ADD) fe_add<F>(r, x, y);
  if constexpr (OP == OP_SUB) fe_sub<F>(r, x, y);
  fe_store(out + i * FQ_WORDS, r);
}

template <int F, int OP, int THREADS>
__global__ void __launch_bounds__(THREADS)
    field_unary_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], r[FQ_WORDS];
  fe_load(x, a + i * FQ_WORDS);
  if constexpr (OP == OP_NEG) fe_neg<F>(r, x);
  if constexpr (OP == OP_INV) fe_inv_gcd<F>(r, x);
  if constexpr (OP == OP_CANON) fe_canon<F>(r, x);
  fe_store(out + i * FQ_WORDS, r);
}

// The canonical-value map Fq -> Fr on Montgomery words: from_mont (the
// product by plain 1), canon (< q < 2r, so a lazy Fr input), then Fr's
// to_mont (the product by R^2 mod r, fe_inv.cuh's table).
__device__ __forceinline__ void fq_to_fr(uint32_t r[FQ_WORDS], const uint32_t x[FQ_WORDS]) {
  const uint32_t one[FQ_WORDS] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t r2[FQ_WORDS], t[FQ_WORDS], c[FQ_WORDS];
#pragma unroll
  for (int k = 0; k < FQ_WORDS; k++) r2[k] = inv_r2<FR>(k);
  fe_mul<FQ>(t, x, one);
  fe_canon<FQ>(c, t);
  fe_mul<FR>(r, c, r2);
}

// Affine mode: in (n, 8) Fq words -> out (n, 8) Fr words.
__global__ void __launch_bounds__(FE_THREADS)
    points_to_fr_affine_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                               long long n) {
  const long long i = (long long)blockIdx.x * FE_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], r[FQ_WORDS];
  fe_load(x, in + i * FQ_WORDS);
  fq_to_fr(r, x);
  fe_store(out + i * FQ_WORDS, r);
}

// Projective modes: in (n, 3, 8) Fq words (X, Y, Z) -> out (n, 2, 8) Fr
// words of the affine (X/Z, Y/Z) (MAP), or its canonical Fq Montgomery words
// (!MAP); Z^-1 is canonical, 0 for the identity.
template <bool MAP>
__global__ void __launch_bounds__(INV_THREADS)
    points_to_fr_projective_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                   long long n) {
  const long long i = (long long)blockIdx.x * INV_THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t* pt = in + i * 3 * FQ_WORDS;
  uint32_t z[FQ_WORDS], zinv[FQ_WORDS], x[FQ_WORDS], t[FQ_WORDS], r[FQ_WORDS];
  fe_load(z, pt + 2 * FQ_WORDS);
  fe_inv_gcd<FQ>(zinv, z);
#pragma unroll
  for (int c = 0; c < 2; c++) {
    fe_load(x, pt + c * FQ_WORDS);
    fe_mul<FQ>(t, x, zinv);
    if constexpr (MAP) fq_to_fr(r, t);
    else fe_canon<FQ>(r, t);
    fe_store(out + (i * 2 + c) * FQ_WORDS, r);
  }
}

inline unsigned fe_blocks(long long n, int threads = FE_THREADS) {
  return (unsigned)((n + threads - 1) / threads);
}

template <int OP>
int launch_binary(int field, const void* a, long long sa, const void* b, long long sb, void* out,
                  long long n, void* stream) {
  if (field != FQ && field != FR) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const auto st = (cudaStream_t)stream;
    if (field == FQ)
      field_binary_kernel<FQ, OP><<<fe_blocks(n), FE_THREADS, 0, st>>>(
          (const uint32_t*)a, sa, (const uint32_t*)b, sb, (uint32_t*)out, n);
    else
      field_binary_kernel<FR, OP><<<fe_blocks(n), FE_THREADS, 0, st>>>(
          (const uint32_t*)a, sa, (const uint32_t*)b, sb, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

template <int OP>
int launch_unary(int field, const void* a, void* out, long long n, void* stream) {
  if (field != FQ && field != FR) return (int)cudaErrorInvalidValue;
  constexpr int T = OP == OP_INV ? INV_THREADS : FE_THREADS;
  if (n > 0) {
    const auto st = (cudaStream_t)stream;
    if (field == FQ)
      field_unary_kernel<FQ, OP, T><<<fe_blocks(n, T), T, 0, st>>>(
          (const uint32_t*)a, (uint32_t*)out, n);
    else
      field_unary_kernel<FR, OP, T><<<fe_blocks(n, T), T, 0, st>>>(
          (const uint32_t*)a, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace svt

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns a cudaError_t (0 = launched).  sa / sb are the operands'
// strides in words: 8 (one element per lane) or 0 (one element broadcast).

extern "C" int svt_field_mul(int field, const void* a, long long sa, const void* b, long long sb,
                             void* out, long long n, void* stream) {
  return svt::launch_binary<svt::OP_MUL>(field, a, sa, b, sb, out, n, stream);
}

extern "C" int svt_field_add(int field, const void* a, long long sa, const void* b, long long sb,
                             void* out, long long n, void* stream) {
  return svt::launch_binary<svt::OP_ADD>(field, a, sa, b, sb, out, n, stream);
}

extern "C" int svt_field_sub(int field, const void* a, long long sa, const void* b, long long sb,
                             void* out, long long n, void* stream) {
  return svt::launch_binary<svt::OP_SUB>(field, a, sa, b, sb, out, n, stream);
}

extern "C" int svt_field_neg(int field, const void* a, void* out, long long n, void* stream) {
  return svt::launch_unary<svt::OP_NEG>(field, a, out, n, stream);
}

extern "C" int svt_field_inv(int field, const void* a, void* out, long long n, void* stream) {
  return svt::launch_unary<svt::OP_INV>(field, a, out, n, stream);
}

extern "C" int svt_field_canon(int field, const void* a, void* out, long long n, void* stream) {
  return svt::launch_unary<svt::OP_CANON>(field, a, out, n, stream);
}

// mode 0: in (n, 8) Fq Montgomery words -> out (n, 8) Fr Montgomery words;
// mode 1: in (n, 3, 8) projective points -> out (n, 2, 8) Fr Montgomery
// words; mode 2: the same points -> out (n, 2, 8) affine Fq Montgomery words.
extern "C" int svt_points_to_fr(const void* in, int mode, void* out, long long n,
                                void* stream) {
  if (n < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const auto st = (cudaStream_t)stream;
    const unsigned blocks = svt::fe_blocks(n, svt::INV_THREADS);
    if (mode == 1)
      svt::points_to_fr_projective_kernel<true><<<blocks, svt::INV_THREADS, 0, st>>>(
          (const uint32_t*)in, (uint32_t*)out, n);
    else if (mode == 2)
      svt::points_to_fr_projective_kernel<false><<<blocks, svt::INV_THREADS, 0, st>>>(
          (const uint32_t*)in, (uint32_t*)out, n);
    else
      svt::points_to_fr_affine_kernel<<<svt::fe_blocks(n), svt::FE_THREADS, 0, st>>>(
          (const uint32_t*)in, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
