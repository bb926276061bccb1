// Elementwise Montgomery arithmetic over Fq and Fr for Hopper (sm_90a),
// bound through a plain C interface (ctypes, see _build.py and
// ff/word_field.py).  Elements are 8 little-endian 32-bit words.
//
// These replace work the JAX package leaves to XLA
// (ff/jnp_field.py::LimbField.mul :145, add :127, sub :132, neg :141,
// inv :211, canon :121): on the verify path the transcript's Fq -> Fr map
// (three launches a batch); the succinct verifier's scalar algebra runs
// here only under the eager TorchLoader, the witness of the recorded Fr
// program that the verify path runs as one svt_fr_tape launch
// (csrc/fr_tape.cu).  Torch has no 256-bit modular arithmetic, and the
// plain limb twin (ff/limb_field.py) synchronizes the host once per carry
// pass, so on the card every one of these ops is one launch of a kernel
// here.
//
// Each launch applies one op to n elements, one thread per element; either
// operand may be a single element broadcast over all n (stride 0), which is
// how the verifier's constants enter.  `field` is the tag of fq.cuh (0 = Fq,
// 1 = Fr).  Bounds: mul is 136 multiply-adds against 96 bytes moved (0.36
// bytes per multiply-add, near the H100's ridge of 0.2); add, sub, neg and
// canon do no multiplies and are bound by bytes; inv is 254 squarings plus
// popcount(p - 2) multiplies (about 370 products, 50,000 multiply-adds) per
// element, bound by operations.  At the verifier's shapes (B = 1,024
// elements) every launch is far below either bound: launch overhead rules.

#include <cuda_runtime.h>

#include <cstdint>

#include "fq.cuh"

namespace svt {

constexpr int FE_THREADS = 256;
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

template <int F, int OP>
__global__ void __launch_bounds__(FE_THREADS)
    field_unary_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * FE_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x[FQ_WORDS], r[FQ_WORDS];
  fe_load(x, a + i * FQ_WORDS);
  if constexpr (OP == OP_NEG) fe_neg<F>(r, x);
  if constexpr (OP == OP_INV) fe_inv<F>(r, x);
  if constexpr (OP == OP_CANON) fe_canon<F>(r, x);
  fe_store(out + i * FQ_WORDS, r);
}

inline unsigned fe_blocks(long long n) { return (unsigned)((n + FE_THREADS - 1) / FE_THREADS); }

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
  if (n > 0) {
    const auto st = (cudaStream_t)stream;
    if (field == FQ)
      field_unary_kernel<FQ, OP><<<fe_blocks(n), FE_THREADS, 0, st>>>(
          (const uint32_t*)a, (uint32_t*)out, n);
    else
      field_unary_kernel<FR, OP><<<fe_blocks(n), FE_THREADS, 0, st>>>(
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
