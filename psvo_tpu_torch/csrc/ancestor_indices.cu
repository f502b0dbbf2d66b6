// K3 ancestor_indices: systematic ancestors of one resampling step,
// logw [B, K] and offsets u0 [B] -> idx int32 [B, K], through the very
// device functions the whole-scan kernel inlines (resample.cuh), so the
// index semantics can be checked on their own against the plain version.
//
// Replaces psvo_tpu/ops/pallas_resample.py::_two_level_indices as
// pallas_step._fwd_core inlines it. Bounded by latency, not bytes: one CTA
// per row does a block scan and K binary searches of log2(K) shared-memory
// probes each.
#include <cuda_runtime.h>

#include <cstdint>

#include "resample.cuh"

namespace psvo {

__global__ void __launch_bounds__(kThreads)
    ancestor_indices_kernel(const float* logw, const float* u0, int K, int* idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cdf = reinterpret_cast<double*>(smem);  // [K]
  double* dred = cdf + K;                          // [kWarps]
  float* lw = reinterpret_cast<float*>(dred + kWarps);  // [K]
  float* red = lw + K;                             // [kWarps]
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < K; i += kThreads) lw[i] = logw[(size_t)b * K + i];
  __syncthreads();
  const float m = block_max_of(lw, K, red);
  float s1, s2;
  const double total = block_cdf(lw, K, m, cdf, dred, red, &s1, &s2);
  const float off = u0[b];
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float pos = systematic_position(i, off, K);
    idx[(size_t)b * K + i] = ancestor(cdf, K, static_cast<double>(pos) * total);
  }
}

}  // namespace psvo

extern "C" int psvo_ancestor_indices(const float* logw, const float* u0, int* idx, int B,
                                     int K, void* stream) {
  const size_t smem = sizeof(double) * (K + psvo::kWarps) + sizeof(float) * (K + psvo::kWarps);
  cudaError_t err = cudaFuncSetAttribute(psvo::ancestor_indices_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psvo::ancestor_indices_kernel<<<B, psvo::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      logw, u0, K, idx);
  return static_cast<int>(cudaGetLastError());
}
