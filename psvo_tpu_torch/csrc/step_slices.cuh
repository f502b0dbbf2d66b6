// K14 (scan_forward.cuh) and K15 (scan_backward.cu) on S CTAs per trajectory
// row, with no cluster: CTA b·S + r owns the particles [r·K/S, (r+1)·K/S) of
// row b. The row's CTAs need not be resident together and never wait for one
// another. Each writes its slice's results to device memory and arrives at
// the row's counter; the CTA that arrives last does the row's one exchange
// (K14: ℓ, the ESS and the filtered mean over the whole row; K15: the
// ancestor scatter and the d_coef sum), reading the other slices from L2.
// A cluster (K1, K4: cluster.cuh) would need its S SMs in one GPC, and the
// H100 holds only 30 clusters of 4; B·S independent CTAs fill 128 of its 132
// SMs at B = 32, S = 4.
//
// Here: the arrival, the launch of B·S CTAs, and the occupancy query from
// which fused_step.step_slices picks S.
#pragma once

#include <cuda_runtime.h>

#include "resample.cuh"

namespace psvo {

// Whether this CTA is the last of its row's `ctas` CTAs to arrive at
// *counter (a device-memory int, 0 before the first arrives; the last one
// sets it back to 0 for the next launch on the stream). What any thread of
// the CTA wrote to device memory before the call is visible to the last CTA
// after it, which reads the other slices' writes with __ldcg (L2), never
// through a possibly stale L1. Every thread of the CTA calls it.
__device__ __forceinline__ bool last_to_arrive(int* counter, int ctas) {
  __shared__ int last;
  __threadfence();  // this thread's writes before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == ctas - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();  // the other CTAs' writes before this CTA's reads
  return true;
}

// rows·slices CTAs of kThreads threads with `smem` bytes of dynamic shared
// memory each; CTA b·slices + r is slice r of row b.
template <class Args>
cudaError_t launch_slices(void (*kernel)(Args), const Args& a, int rows, int slices, size_t smem,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<rows * slices, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// How many CTAs of `kernel` with `smem` bytes each the current device holds
// at once: the occupancy per SM times the SM count.
template <class Args>
cudaError_t max_resident(void (*kernel)(Args), size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return err;
}

// K15's query, defined in step_backward.cu (psvo_step_max_active, in
// step_forward.cu, serves both kernels).
int step_backward_resident(int dx, int dy, int hidden, int smem, int* out);

}  // namespace psvo
