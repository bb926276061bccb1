// TMA bulk copies from shared to global memory (sm_90's
// cp.async.bulk.global.shared::cta): one thread asks for a contiguous
// range of shared memory to be written to device memory; the copy runs in
// the async proxy while the block goes on.  Used by csrc/ipa_kernels.cu;
// tests/test_torch_h_coeffs_schedule.py replaces this header with a host
// emulation that copies at the wait, the latest moment the hardware may
// read the source.
#pragma once

#include <cstdint>

namespace svt {

// Make this thread's writes to shared memory visible to the async proxy
// (before the barrier after which one thread issues the copy).
__device__ __forceinline__ void bulk_fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16) from shared `src` to global `dst` (both
// 16-byte aligned) as one bulk-async group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until every group this thread issued has read its source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Wait until every group this thread issued is complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace svt
