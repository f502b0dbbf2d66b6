// Asynchronous copies from device memory into shared memory, for kernels
// that stage the next operands while they compute on the current ones.
//
// cp.async (sm_80 and later): each thread issues its own copies, closes them
// into a group with cp_async_commit(), and waits with cp_async_wait<N>()
// until at most N of its groups are still in flight; a __syncthreads() after
// the wait makes every thread's copies visible to the whole block.
//
// Bulk copies (the tensor memory accelerator, sm_90): one thread announces
// the bytes on an mbarrier (mbar_expect_tx) and issues whole spans
// (bulk_copy, 16-byte aligned, a multiple of 16 bytes); a thread that has
// waited on the barrier's phase (mbar_wait) sees the data.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace psvo {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// After mbar_init, before the barrier is used by the copy engine.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's earlier shared-memory accesses before later bulk copies.
__device__ __forceinline__ void bulk_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* gmem_src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem_dst)),
      "l"(gmem_src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 4 bytes; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes; both addresses 16-byte aligned. Bypasses L1 (data read once).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace psvo
