// Barriers over a named group of whole warps: a kernel whose warps split
// into groups that synchronise among themselves without stopping the rest
// of the CTA (barrier 0 is __syncthreads').
#pragma once

#include <cuda_runtime.h>

namespace psvo {

// Wait until `count` threads (a multiple of 32, whole warps) have arrived at
// barrier `id` (1-15); orders their shared-memory accesses as __syncthreads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace psvo
