// The large-K resampling step, in two kernels: ancestor indices, then the
// particle gather. The per-step trunk path (smc._forward_filter_trunk) runs
// them before each trunk_forward launch.
//
// K7 ancestor_indices_large: logw [B, K] and the sorted positions [B, K]
// (systematic or multinomial) -> idx int32 [B, K]. Replaces
// psvo_tpu/ops/pallas_resample.py::_indices_large (its kernel body is
// _two_level_indices: an MXU triangular cumsum and a two-level
// compare-and-count, built for the TPU's lanes). Here, as in K1 and K3
// (resample.cuh), one CTA owns one row: the log-weights sit in shared
// memory, the CDF is a block scan accumulated in fp64, and each particle
// finds its ancestor by binary search, so the index semantics are the count
// form a_i = #{j : C_j <= pos_i·C_{K-1}} of fused_step.count_form_indices.
// Shared memory is 12·K + 96 bytes (fp64 CDF and fp32 log-weights): K up to
// 19200 fits the 227 KB a CTA may use. Bounded by latency, not bytes: one
// CTA per row (8 at the Lorenz-96 preset) scans K values and runs K binary
// searches of log2(K) probes each.
//
// K8 gather_particles: x [B, D, K], idx int32 [B, K] -> x[b, d, idx[b, k]].
// Replaces the gather half of pallas_resample.py::_win_pallas_call
// (_win_gather_kernel) together with what _win_gather's validity cond
// falls back to: _compact_gather (and its use of _rank_of_positions) and
// XLA's dynamic gather. Those windows, anchors and ranks exist because a TPU
// core cannot address lanes one by one; on Hopper a gather by index is a
// plain load, so one kernel covers every regime, degenerate weights
// included. Bounded by bytes (each x_res element written once, each source
// read once when the indices are near the identity); a grid over (k-tile,
// d-tile, b) puts B·ceil(D/8)·ceil(K/256) CTAs on the card, not B. The
// indices must lie in [0, K): K7 guarantees it.
#include <cuda_runtime.h>

#include <cstdint>

#include "resample.cuh"

namespace psvo {

__global__ void __launch_bounds__(kThreads)
    ancestor_indices_large_kernel(const float* logw, const float* pos, int K, int* idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cdf = reinterpret_cast<double*>(smem);        // [K]
  double* dred = cdf + K;                                // [kWarps]
  float* lw = reinterpret_cast<float*>(dred + kWarps);  // [K]
  float* red = lw + K;                                   // [kWarps]
  const size_t row = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += kThreads) lw[i] = logw[row + i];
  __syncthreads();
  const float m = block_max_of(lw, K, red);
  float s1, s2;
  const double total = block_cdf(lw, K, m, cdf, dred, red, &s1, &s2);
  for (int i = threadIdx.x; i < K; i += kThreads) {
    idx[row + i] = ancestor(cdf, K, static_cast<double>(pos[row + i]) * total);
  }
}

constexpr int kGatherRows = 8;  // state rows per CTA: the index is loaded once for them

__global__ void __launch_bounds__(kThreads)
    gather_particles_kernel(const float* x, const int* idx, int D, int K, float* out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const int b = blockIdx.z, d0 = blockIdx.y * kGatherRows;
  const int a = idx[(size_t)b * K + k];
  const int rows = min(kGatherRows, D - d0);
  const float* src = x + ((size_t)b * D + d0) * K;
  float* dst = out + ((size_t)b * D + d0) * K;
  for (int d = 0; d < rows; ++d) dst[(size_t)d * K + k] = src[(size_t)d * K + a];
}

}  // namespace psvo

extern "C" int psvo_ancestor_indices_large(const float* logw, const float* pos, int* idx, int B,
                                           int K, void* stream) {
  const size_t smem = sizeof(double) * (K + psvo::kWarps) + sizeof(float) * (K + psvo::kWarps);
  cudaError_t err = cudaFuncSetAttribute(psvo::ancestor_indices_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psvo::ancestor_indices_large_kernel<<<B, psvo::kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(logw, pos, K, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvo_gather_particles(const float* x, const int* idx, float* out, int B, int D,
                                     int K, void* stream) {
  const dim3 grid((K + psvo::kThreads - 1) / psvo::kThreads,
                  (D + psvo::kGatherRows - 1) / psvo::kGatherRows, B);
  psvo::gather_particles_kernel<<<grid, psvo::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, D, K, out);
  return static_cast<int>(cudaGetLastError());
}
