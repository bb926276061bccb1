// The C entry points of the point loops; msm_loops.cuh has the kernels and
// their design (csrc/probe/point_loop_variants.cu instantiates its other
// variants).

#include "msm_loops.cuh"

// C entry points: each launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 = launched).

// pts (nproofs, n, 3, 8) projective Montgomery words, scalars (nproofs, n, 8)
// canonical words -> out (nproofs, 3, 8); teams of `team` lanes (1 or 6),
// `per_block` proofs a block (msm/cuda_ops.py::msm_windowed_layout).
extern "C" int svt_msm_windowed(const void* pts, const void* scalars, long long nproofs, int n,
                                int team, int per_block, void* out, void* stream) {
  if (nproofs <= 0 || n < 0) return (int)cudaGetLastError();
  const auto st = (cudaStream_t)stream;
  switch (team) {
    case 1: return svt::launch_msm_windowed<1>(pts, scalars, nproofs, n, per_block, out, st);
    case 6: return svt::launch_msm_windowed<6>(pts, scalars, nproofs, n, per_block, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// buckets (32, 256, 3, 8) bucket sums -> out (1, 3, 8).  part: scratch of
// 32 points plus one word (the ticket) after them.
extern "C" int svt_bucket_reduce(const void* buckets, void* part, void* out, void* stream) {
  const auto st = (cudaStream_t)stream;
  auto* ticket = (unsigned*)((uint32_t*)part + svt::RED_WINDOWS * svt::G1_WORDS);
  const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  svt::bucket_reduce_kernel<svt::RED_T><<<svt::RED_WINDOWS, svt::red_warps<svt::RED_T>() * 32, 0,
                                         st>>>(
      (const uint32_t*)buckets, (uint32_t*)part, ticket, (uint32_t*)out);
  return (int)cudaGetLastError();
}
