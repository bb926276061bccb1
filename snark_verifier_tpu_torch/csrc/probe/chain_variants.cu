// The chain probe of ../fold_kernels.cu in the variants the library does not
// instantiate, for kernel_compare.py to time beside it in one process: the
// add chain (g1.cuh's g1_add_sum) at 3 to 6 persistent blocks of 128
// threads an SM (the launch bound and the grid); the FP64 square chain
// (fq_f64.cuh) as the product of x by itself; route 2, the two routes side
// by side in one launch (even warps integer, odd warps FP64); and the FP64
// pipe's own FMA rate.
// The library instantiates one of each (ADD_CHAIN_BLOCKS,
// F64_SQR_DEDICATED); this file builds them all from the library's own
// text, so that another card can measure them again.
//
// Not part of the library; built on its own:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//        -o libchain_variants.so chain_variants.cu

#include "../fold_kernels.cu"

// svt_g1_add_chain's arguments after the blocks an SM (3 to 6).
extern "C" int svt_g1_add_chain_variant(int blocks, const void* a, const void* b, void* out,
                                        long long n, int ch, void* stream) {
  const auto st = (cudaStream_t)stream;
  switch (blocks) {
    case 3: return svt::launch_g1_add_chain<3>(a, b, out, n, ch, st);
    case 4: return svt::launch_g1_add_chain<4>(a, b, out, n, ch, st);
    case 5: return svt::launch_g1_add_chain<5>(a, b, out, n, ch, st);
    case 6: return svt::launch_g1_add_chain<6>(a, b, out, n, ch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// svt_fq_mul_chain's arguments after the variant: the FP64 square's form
// (1: the dedicated square, 0: the product of x by itself) and a route of 1
// or 2 (2: even warps route 0, odd warps route 1).
extern "C" int svt_fq_mul_chain_variant(int dedicated, const void* a, const void* b, void* out,
                                        long long n, int ch, int route, void* stream) {
  const auto st = (cudaStream_t)stream;
  if (route == 1)
    return dedicated ? svt::launch_fq_mul_chain_route<1, true>(a, b, out, n, ch, st)
                     : svt::launch_fq_mul_chain_route<1, false>(a, b, out, n, ch, st);
  if (route == 2)
    return dedicated ? svt::launch_fq_mul_chain_route<2, true>(a, b, out, n, ch, st)
                     : svt::launch_fq_mul_chain_route<2, false>(a, b, out, n, ch, st);
  return (int)cudaErrorInvalidValue;
}

// The FP64 pipe's own rate on this card, for the FP64 chain's share of it:
// each thread runs 8 independent chains of `iters` FMAs (x <- x * y + z, to
// nearest or, rz != 0, toward zero) and writes their sum, n threads in
// blocks of 128.
namespace svt {

template <bool RZ>
__global__ void __launch_bounds__(CHAIN_THREADS)
    f64_peak_kernel(double* __restrict__ out, long long n, int iters) {
  const long long i = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= n) return;
  double x[8];
  const double y = 1.0 - 0x1p-40, z = (double)(i & 7) * 0x1p-30;
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = 1.0 + k * 0x1p-20;
#pragma unroll 1
  for (int s = 0; s < iters; s++)
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = RZ ? __fma_rz(x[k], y, z) : __fma_rn(x[k], y, z);
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < 8; k++) sum = __dadd_rn(sum, x[k]);
  out[i] = sum;
}

}  // namespace svt

extern "C" int svt_f64_peak(void* out, long long n, int iters, int rz, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + svt::CHAIN_THREADS - 1) / svt::CHAIN_THREADS);
  const auto st = (cudaStream_t)stream;
  if (rz)
    svt::f64_peak_kernel<true><<<blocks, svt::CHAIN_THREADS, 0, st>>>((double*)out, n, iters);
  else
    svt::f64_peak_kernel<false><<<blocks, svt::CHAIN_THREADS, 0, st>>>((double*)out, n, iters);
  return (int)cudaGetLastError();
}
