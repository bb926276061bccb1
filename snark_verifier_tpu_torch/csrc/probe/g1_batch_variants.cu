// The batch add and double of ../msm_kernels.cu in every variant of their
// template, for kernel_compare.py to time beside the library in one
// process: the shared reduction on or off (fq.cuh's fe_mul_sum, or
// g1.cuh's formulas then fe_canon), the loads and stores bulk-copied
// through shared memory or direct (16 bytes a thread), and 3 to 6
// blocks of 128 threads an SM (the launch bound and the grid).  The
// library instantiates one variant an operation (G1B_SUM, g1b_bulk,
// g1b_blocks); this file builds them all from the library's own text, so
// that another card can measure them again.
//
// Not part of the library; built on its own:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//        -o libg1_batch_variants.so g1_batch_variants.cu

#include "../msm_kernels.cu"

namespace svt {

template <int IN, int BLOCKS>
int g1_batch_variant(bool sum, bool bulk, const void* a, const void* b, void* out, long long n,
                     cudaStream_t st) {
  if (sum) return bulk ? launch_g1_batch<IN, true, true, BLOCKS>(a, b, out, n, st)
                       : launch_g1_batch<IN, true, false, BLOCKS>(a, b, out, n, st);
  return bulk ? launch_g1_batch<IN, false, true, BLOCKS>(a, b, out, n, st)
              : launch_g1_batch<IN, false, false, BLOCKS>(a, b, out, n, st);
}

template <int IN>
int g1_batch_blocks(int blocks, bool sum, bool bulk, const void* a, const void* b, void* out,
                    long long n, cudaStream_t st) {
  switch (blocks) {
    case 3: return g1_batch_variant<IN, 3>(sum, bulk, a, b, out, n, st);
    case 4: return g1_batch_variant<IN, 4>(sum, bulk, a, b, out, n, st);
    case 5: return g1_batch_variant<IN, 5>(sum, bulk, a, b, out, n, st);
    case 6: return g1_batch_variant<IN, 6>(sum, bulk, a, b, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace svt

// svt_g1_add's arguments after the variant: sum, bulk (0 or 1) and the
// blocks an SM (3 to 6: the launch bound and the grid).
extern "C" int svt_g1_add_variant(int sum, int bulk, int blocks, const void* a, const void* b,
                                  void* out, long long n, void* stream) {
  return svt::g1_batch_blocks<2>(blocks, sum, bulk, a, b, out, n, (cudaStream_t)stream);
}

// svt_g1_double's arguments after the variant.
extern "C" int svt_g1_double_variant(int sum, int bulk, int blocks, const void* a, void* out,
                                     long long n, void* stream) {
  return svt::g1_batch_blocks<1>(blocks, sum, bulk, a, nullptr, out, n, (cudaStream_t)stream);
}
