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
//
// K11 segment_sum_scatter, the VJP of K8: g [B, D, K], idx int32 [B, K]
// nondecreasing along K -> d_x[b, d, s] = Σ_{q : idx[b,q] = s} g[b, d, q],
// exactly 0 for a source with no children. Replaces four TPU functions that
// compute this one transpose of a gather by sorted indices:
// pallas_resample.py::_rg_bwd's fused _scatter_kernel (one-hot MXU scatter,
// K <= 2048), the scatter half of _win_pallas_call (_win_scatter_kernel,
// 128-lane windows), and the fallback _sorted_segsum with its
// _rank_of_positions (a bf16-exact rank) and _lane_cumsum (a triangular-
// matmul cumsum). Those exist because a TPU core moves whole lanes; on
// Hopper one segmented sum covers every K and every regime. The children of
// each ancestor are one contiguous run of q, so one CTA per (b, d) row walks
// the row in chunks of 1024 particles (4 consecutive per thread) with a
// block-wide segmented inclusive scan (head flags where idx changes) and a
// carry between chunks, and the last particle of each run writes its total
// into the row's output, held in shared memory (K floats, zeroed first);
// the row is then written out whole. So a row whose particles all descend
// from one ancestor (the degenerate regime: mean ESS 1.55 on the trained
// Lorenz-96 snapshot) costs what a healthy row costs, where a thread per
// source that sums its run serially (K4's form) would leave one thread
// reading all K values. Bounded by bytes: g read once, d_x written once,
// idx read by each of the D rows of b (from L2). The additions of a run go
// through a fixed tree (within a thread, then the warp's shuffles, then the
// warps in order): no atomics, the same bits on every launch. idx must be
// nondecreasing in [0, K), as K7's are; an index outside [0, K) is dropped.
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

constexpr int kSegPer = 4;                    // consecutive particles per thread
constexpr int kSegChunk = kThreads * kSegPer;  // particles per block-wide scan

// (fa, va) ⊕ (fb, vb) of a segmented sum: a head flag fb restarts the sum.
__device__ __forceinline__ void seg_add(int fa, float va, int& fb, float& vb) {
  vb = fb ? vb : va + vb;
  fb |= fa;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_scatter_kernel(const float* g, const int* idx, int D, int K, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [K]: this row's d_x
  __shared__ int tot_f[kWarps + 1];             // warp totals, then the prefixes
  __shared__ float tot_v[kWarps + 1];
  __shared__ int pre_f[kWarps + 1];
  __shared__ float pre_v[kWarps + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d = blockIdx.x;
  const float* grow = g + ((size_t)b * D + d) * K;
  const int* irow = idx + (size_t)b * K;
  for (int s = tid; s < K; s += kThreads) acc[s] = 0.0f;
  if (tid == 0) {
    pre_f[kWarps] = 1;  // the carry into the first chunk: an empty run
    pre_v[kWarps] = 0.0f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < K; c0 += kSegChunk) {
    const int q0 = c0 + tid * kSegPer;
    int a[kSegPer], h[kSegPer], last[kSegPer];
    float v[kSegPer];
    int prev = q0 > 0 && q0 <= K ? irow[q0 - 1] : -1;
#pragma unroll
    for (int j = 0; j < kSegPer; ++j) {
      const int q = q0 + j;
      const bool live = q < K;
      a[j] = live ? irow[q] : -1;
      v[j] = live ? grow[q] : 0.0f;
      h[j] = !live || q == 0 || a[j] != prev;  // a run starts here
      last[j] = live && (q == K - 1 || irow[q + 1] != a[j]);  // a run ends here
      prev = a[j];
    }
    // this thread's aggregate, in particle order
    int f = h[0];
    float s = v[0];
#pragma unroll
    for (int j = 1; j < kSegPer; ++j) {
      int fj = h[j];
      float sj = v[j];
      seg_add(f, s, fj, sj);
      f = fj;
      s = sj;
    }
    // inclusive scan of the aggregates within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fo = __shfl_up_sync(kFull, f, o);
      const float so = __shfl_up_sync(kFull, s, o);
      if (lane >= o) seg_add(fo, so, f, s);
    }
    int fx = __shfl_up_sync(kFull, f, 1);  // exclusive, within the warp
    float sx = __shfl_up_sync(kFull, s, 1);
    if (lane == 31) {
      tot_f[warp] = f;
      tot_v[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {  // the warps' prefixes in order, the previous chunk's carry first
      int cf = pre_f[kWarps];
      float cv = pre_v[kWarps];
      for (int w = 0; w < kWarps; ++w) {
        pre_f[w] = cf;
        pre_v[w] = cv;
        int tf = tot_f[w];
        float tv = tot_v[w];
        seg_add(cf, cv, tf, tv);
        cf = tf;
        cv = tv;
      }
      pre_f[kWarps] = cf;  // the carry into the next chunk
      pre_v[kWarps] = cv;
    }
    __syncthreads();
    int pf = pre_f[warp];
    float pv = pre_v[warp];
    if (lane > 0) {
      seg_add(pf, pv, fx, sx);
      pf = fx;
      pv = sx;
    }
#pragma unroll
    for (int j = 0; j < kSegPer; ++j) {
      int fj = h[j];
      float sj = v[j];
      seg_add(pf, pv, fj, sj);
      pf = fj;
      pv = sj;
      if (last[j] && a[j] >= 0 && a[j] < K) acc[a[j]] = sj;
    }
  }
  __syncthreads();
  float* orow = out + ((size_t)b * D + d) * K;
  for (int s = tid; s < K; s += kThreads) orow[s] = acc[s];
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

extern "C" int psvo_segment_sum_scatter(const float* g, const int* idx, float* out, int B, int D,
                                        int K, void* stream) {
  const size_t smem = sizeof(float) * K;
  cudaError_t err = cudaFuncSetAttribute(psvo::segment_sum_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psvo::segment_sum_scatter_kernel<<<dim3(D, B), psvo::kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(g, idx, D, K, out);
  return static_cast<int>(cudaGetLastError());
}
