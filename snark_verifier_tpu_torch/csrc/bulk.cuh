// TMA bulk copies between global and shared memory (sm_90's 1-D
// cp.async.bulk): one thread asks for a contiguous range to be copied; the
// copy runs in the async proxy while the block goes on.  A store from
// shared memory completes in bulk-async groups (bulk_wait_read,
// bulk_wait); a load into shared memory completes on an mbarrier, which
// counts the bytes it was armed for (bulk_expect) and flips its phase when
// they have all landed (bulk_wait_phase).  Used by csrc/ipa_kernels.cu
// (stores) and csrc/msm_kernels.cu (loads and stores);
// tests/test_torch_h_coeffs_schedule.py and
// tests/test_torch_g1_batch_schedule.py replace this header with host
// emulations.
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

// ---- loads, completed on an mbarrier -----------------------------------

// One thread: make `bar` (8 bytes of shared memory) an mbarrier that
// completes a phase at one arrival and the bytes it is armed for; then
// bulk_fence_init and a block barrier before any thread uses it.
__device__ __forceinline__ void bulk_barrier_init(uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(b), "r"(1u) : "memory");
}

__device__ __forceinline__ void bulk_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The arrival of the thread that issues a phase's loads: the phase now
// waits for `bytes` more (the sum of the bulk_load calls that follow).
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned); the bytes count against `bar`'s current phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Wait until the phase of `bar` whose parity is `parity` has completed:
// its loads' bytes are then visible to the waiting thread.
__device__ __forceinline__ void bulk_wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
  } while (!done);
}

}  // namespace svt
