// Block-level pieces of the resampling step, shared by the whole-scan forward
// kernel (scan_forward.cuh) and the standalone index kernel (ancestor_indices.cu).
//
// Replaces psvo_tpu/ops/pallas_resample.py::_two_level_indices as the TPU
// megakernel inlines it. There the CDF was a triangular-ones MXU contraction
// with bf16-rounded operands and the count a two-level compare-and-sum. Here
// one CTA owns one trajectory row: the K log-weights sit in shared memory, the
// CDF is a block-wide inclusive scan accumulated in fp64, and each particle
// finds its ancestor by binary search. fp64 makes the kernel and its plain
// version (fused_step.ancestor_indices_reference, a float64 torch.cumsum)
// agree on every ancestor except at exact ties, which both break alike; with
// an fp32 scan the two summation orders flip a few hundred ancestors per
// forward at B=32, K=1024, T=100.
//
// Ancestor semantics (the reference's inverse_cdf_indices, side="right"):
//   a_i = #{j : C_j <= pos_i * C_{K-1}}, clipped to K-1,
// with C the inclusive CDF of w_j = exp(lw_j - max lw), computed unnormalized
// (the position is scaled by the total instead of dividing K weights).
#pragma once

#include <cstdint>

namespace psvo {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result. `red` holds kWarps
// floats. The trailing barrier lets the caller reuse `red` at once.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// max_j lw[j] over the row in shared memory.
__device__ __forceinline__ float block_max_of(const float* lw, int K, float* red) {
  float m = __int_as_float(0xff800000);  // -inf
  for (int i = threadIdx.x; i < K; i += kThreads) m = fmaxf(m, lw[i]);
  return block_reduce<true>(m, red);
}

// Inclusive fp64 CDF of w_j = exp(lw_j - m) into cdf[0..K). Thread tid owns
// the contiguous chunk [tid*per, min(tid*per + per, K)), per = ceil(K /
// kThreads) (one element for tid < K when K <= kThreads). Also returns the
// fp32 sums s1 = Σw, s2 = Σw² of the ESS. Returns the total C_{K-1}. Ends
// on a barrier: cdf is readable by all.
__device__ __forceinline__ double block_cdf(const float* lw, int K, float m, double* cdf,
                                            double* dred, float* red, float* s1,
                                            float* s2) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + kThreads - 1) / kThreads;
  const int base = tid * per;
  const bool active = base < K;
  const int cnt = active ? min(per, K - base) : 0;
  double run = 0.0;
  float p1 = 0.0f, p2 = 0.0f;
  if (active) {
    for (int j = 0; j < cnt; ++j) {
      const float w = expf(lw[base + j] - m);
      p1 += w;
      p2 += w * w;
      run += static_cast<double>(w);
      cdf[base + j] = run;
    }
  }
  // exclusive prefix of the chunk totals: within the warp, then across warps
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) dred[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += dred[w];
  if (active) {
    for (int j = 0; j < cnt; ++j) cdf[base + j] += excl;
  }
  *s1 = block_reduce<false>(p1, red);  // its barriers publish cdf
  *s2 = block_reduce<false>(p2, red);
  return cdf[K - 1];
}

// Systematic position (i + u0) / K, IEEE-rounded as the plain version's
// float32 `(arange(K) + u0) / K`.
__device__ __forceinline__ float systematic_position(int i, float u0, int K) {
  return __fdiv_rn(__fadd_rn(static_cast<float>(i), u0), static_cast<float>(K));
}

// a = #{j : cdf[j] <= target}, clipped to K-1 (cdf non-decreasing).
__device__ __forceinline__ int ancestor(const double* cdf, int K, double target) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < K - 1 ? lo : K - 1;
}

}  // namespace psvo
