// K5 ffbsi_forward: the whole FFBSi reverse sweep, t = T-2 .. 0, in one launch.
// K6 ffbsi_backward: its VJP, on K5's selections, in one launch.
//
// K5 replaces psvo_tpu/ops/pallas_ffbsi.py::_scan_fwd (pallas_call at
// pallas_ffbsi.py:294; kernel body _fwd_kernel with _step_fwd_math). K6
// replaces ::_scan_bwd (pallas_call at pallas_ffbsi.py:358; body _bwd_kernel).
// ops/ffbsi.py holds their wrappers and plain versions.
//
// The step (per row b and smoothed path m, query q = x~_{t+1}):
//   pair   = max(-1/2 * sum_d q_d^2 r_d + sum_d q_d mr_d + c, -1e30)     [K]
//   logits = pair + lwn;   idx = argmax(logits + gum), first maximum on ties
//   logq  += pair[idx] + lwn[idx] - lse(logits);   logp += pair[idx] + lg[idx]
//   x~_t   = xs[:, idx]
// pair_of() computes the pair in the plain version's order of terms with
// every product and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), so the kernels and ops/ffbsi.py::pair_logp produce the same
// logits bit for bit and pick the same particles. Lorenz-63 states reach
// |x| ~ 25, where t1, t2 and c are large and nearly cancel: the expanded
// form is the reference's function and is kept as it is.
//
// K5 design. Paths are independent: a path depends only on its own carry
// x~. One CTA of 256 threads walks one path through all T-1 steps (the TPU
// kernel's sequential t grid axis): B*M = 512 CTAs, about four per SM. Per
// step each thread visits particles j = tid, tid + 256, ... once and keeps
// the running argmax of logits + gum (ascending j, strict >: the first
// maximum) and an online (max, sum of exp) of the logits; warp butterflies
// and then one merge of the eight warps in a fixed order combine them, ties
// to the lower index, so every thread ends with the same selection and lse.
// The selected particle's pair, lwn, lg and state are then block-uniform
// loads. One barrier per step (the warps' partials are double-buffered by
// the step's parity). Besides the op's outputs K5 writes the selections sel
// [T-1, B, M] (int32) for K6. One warp per path (four warps per SM) was
// 3.5x slower on the H100: each of its 32 iterations per step waited on its
// own loads.
//
// K6 design. The TPU kernel recomputes each step's argmax from gum; K6 reads
// K5's selections instead, the same function without gum's bytes (the
// largest operand), and teacher-forced as K4 is on K1's ancestors. d_q, the
// cotangent of step t's query, depends only on step t's own inputs (the TPU
// kernel's dq_c scratch only hands it on to step t+1's output), so one CTA
// per (t, b) runs all steps at once:
//   1. one warp per path: the online max and sum of exp of the logits;
//   2. one thread per particle j adds the M paths' terms in path order:
//      d_pair = oh*(gp + gq) - soft*gq, cut to 0 where the unfloored pair <
//      -1e30; d_c = sum d_pair, d_r = -1/2 sum q^2 d_pair, d_mr = sum q d_pair,
//      d_lwn = sum (oh - soft) gq, d_lg = sum oh gp;
//   3. one warp per path: d_q = sum_j d_pair (mr - q r), a warp reduction;
//   4. the CTA of step t writes d_xs of trajectory point t+1, whose
//      cotangent is d_xtilde[t+1] + d_q (the CTA of the last step writes d_q
//      to d_x_anchor instead), and the CTA of step 0 also d_xs of point 0
//      (d_xtilde[0] + d_x_first): one owning thread per particle adds the
//      paths that selected it, in path order.
// No atomics: every run gives the same bits. Without d_logp and d_logq no
// pair carries a cotangent, and steps 1-3 are skipped.
//
// What bounds them. At the preset (B=32, M=16, K=1024, T=100, Dx=3) K5 reads
// gum (208 MB), xs/r/mr (39 MB each) and c/lwn/lg (13 MB each), about 363 MB,
// for ~1.5e9 operations: bytes bound it, 0.11 ms at 3.35 TB/s. K6 reads
// r/mr/c/lwn (104 MB) and writes d_xs, d_r, d_mr (39 MB each) and d_c,
// d_lwn, d_lg (13 MB each): 0.08 ms; without pair cotangents it writes d_xs
// alone. K5 is latency-bound: each step's loads, reductions and the
// dependent load of the selected particle lie on the sweep's critical path;
// prefetching the next step's support is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "resample.cuh"

namespace psvo {

constexpr float kMinLogp = -1e30f;  // distributions._MIN_LOGP

struct FfbsiFwdArgs {
  const float* x_anchor;  // [B, M, DX]: x~_{T-1}
  const float* xs;        // [T1, B, DX, K]: support particles
  const float* r;         // [T1, B, DX, K]: 1/s^2
  const float* mr;        // [T1, B, DX, K]: m/s^2
  const float* c;         // [T1, B, K]
  const float* lwn;       // [T1, B, K]: normalized log-weights
  const float* lg;        // [T1, B, K]
  const float* gum;       // [T1, B, M, K]: Gumbel noise
  float* x_first;         // [B, M, DX]
  float* logp;            // [B, M]
  float* logq;            // [B, M]
  float* xtilde;          // [T1, B, M, DX]
  int* sel;               // [T1, B, M]
  int B, M, K, T1;
};

struct FfbsiBwdArgs {
  const float* x_anchor;  // [B, M, DX]
  const float* xtilde;    // [T1, B, M, DX] (K5's)
  const int* sel;         // [T1, B, M] (K5's)
  const float* r;         // [T1, B, DX, K]
  const float* mr;        // [T1, B, DX, K]
  const float* c;         // [T1, B, K]
  const float* lwn;       // [T1, B, K]
  const float* d_x_first; // [B, M, DX] or null
  const float* d_logp;    // [B, M] or null
  const float* d_logq;    // [B, M] or null
  const float* d_xtilde;  // [T1, B, M, DX] or null
  float* d_x_anchor;      // [B, M, DX]
  float* d_xs;            // [T1, B, DX, K]
  float* d_r;             // [T1, B, DX, K] or null
  float* d_mr;            // [T1, B, DX, K] or null
  float* d_c;             // [T1, B, K] or null
  float* d_lwn;           // [T1, B, K] or null
  float* d_lg;            // [T1, B, K] or null
  int B, M, K, T1;
};

// Unfloored pair: (-1/2 * t1 + t2) + c, t1 = sum_d (q_d q_d) r_d, t2 = sum_d
// q_d mr_d, d ascending, each operation rounded on its own. qq = q*q.
template <int DX>
__device__ __forceinline__ float pair_of(const float (&q)[DX], const float (&qq)[DX],
                                         const float* __restrict__ r,
                                         const float* __restrict__ mr, float c, int K, int j) {
  float t1 = __fmul_rn(qq[0], r[j]);
  float t2 = __fmul_rn(q[0], mr[j]);
#pragma unroll
  for (int d = 1; d < DX; ++d) {
    t1 = __fadd_rn(t1, __fmul_rn(qq[d], r[d * K + j]));
    t2 = __fadd_rn(t2, __fmul_rn(q[d], mr[d * K + j]));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(-0.5f, t1), t2), c);
}

// Running (max, sum of exp(x - max)) over one more value.
__device__ __forceinline__ void lse_push(float x, float& mx, float& s) {
  if (x > mx) {
    s = s * expf(mx - x) + 1.0f;  // expf(-inf) = 0 on the first value
    mx = x;
  } else {
    s += expf(x - mx);
  }
}

// Merge two running (max, sum) pairs; an empty one has max -inf and sum 0.
// Symmetric in its two arguments, so butterfly partners agree bit for bit.
__device__ __forceinline__ void lse_merge(float& mx, float& s, float om, float os) {
  const float nm = fmaxf(mx, om);
  const float a = mx == nm ? s : (s == 0.0f ? 0.0f : s * expf(mx - nm));
  const float b = om == nm ? os : (os == 0.0f ? 0.0f : os * expf(om - nm));
  s = a + b;
  mx = nm;
}

// Online (max, sum) of the logits of path q over the row's K particles, by
// one warp; every lane gets the result.
template <int DX>
__device__ __forceinline__ void warp_lse(const float (&q)[DX], const float (&qq)[DX],
                                         const float* __restrict__ r,
                                         const float* __restrict__ mr,
                                         const float* __restrict__ c,
                                         const float* __restrict__ lwn, int K, float& mx,
                                         float& s) {
  const int lane = threadIdx.x & 31;
  mx = __int_as_float(0xff800000);
  s = 0.0f;
  for (int j = lane; j < K; j += 32) {
    const float logit = __fadd_rn(fmaxf(pair_of<DX>(q, qq, r, mr, c[j], K, j), kMinLogp), lwn[j]);
    lse_push(logit, mx, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(kFull, mx, o);
    const float os = __shfl_xor_sync(kFull, s, o);
    lse_merge(mx, s, om, os);
  }
}

template <int DX>
__global__ void __launch_bounds__(kThreads) ffbsi_forward_kernel(const FfbsiFwdArgs a) {
  // per-warp (argmax, index, max, sum) of a step, double-buffered by the
  // step's parity so that one barrier per step suffices
  __shared__ float s_best[2][kWarps], s_mx[2][kWarps], s_sum[2][kWarps];
  __shared__ int s_j[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K, B = a.B, M = a.M;
  const int b = blockIdx.x / M, m = blockIdx.x % M;
  float q[DX];
#pragma unroll
  for (int d = 0; d < DX; ++d) q[d] = a.x_anchor[((size_t)b * M + m) * DX + d];
  float logp = 0.0f, logq = 0.0f;

  for (int t = a.T1 - 1, par = 0; t >= 0; --t, par ^= 1) {
    const size_t row = (size_t)t * B + b;
    const float* r = a.r + row * DX * K;
    const float* mr = a.mr + row * DX * K;
    const float* c = a.c + row * K;
    const float* lwn = a.lwn + row * K;
    const float* gum = a.gum + (row * M + m) * K;
    float qq[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) qq[d] = __fmul_rn(q[d], q[d]);

    float best = __int_as_float(0xff800000), mx = best, s = 0.0f;
    int best_j = K;  // loses every tie against a real index
    for (int j = threadIdx.x; j < K; j += kThreads) {
      const float logit = __fadd_rn(fmaxf(pair_of<DX>(q, qq, r, mr, c[j], K, j), kMinLogp), lwn[j]);
      const float v = __fadd_rn(logit, gum[j]);
      if (v > best) {  // j ascends: the first maximum is kept
        best = v;
        best_j = j;
      }
      lse_push(logit, mx, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, o);
      const int oj = __shfl_xor_sync(kFull, best_j, o);
      if (ov > best || (ov == best && oj < best_j)) {
        best = ov;
        best_j = oj;
      }
      const float om = __shfl_xor_sync(kFull, mx, o);
      const float os = __shfl_xor_sync(kFull, s, o);
      lse_merge(mx, s, om, os);
    }
    if (lane == 0) {
      s_best[par][warp] = best;
      s_j[par][warp] = best_j;
      s_mx[par][warp] = mx;
      s_sum[par][warp] = s;
    }
    __syncthreads();
    // every thread merges the warps in the same order: the same bits everywhere
    best = s_best[par][0];
    best_j = s_j[par][0];
    mx = s_mx[par][0];
    s = s_sum[par][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float ov = s_best[par][w];
      const int oj = s_j[par][w];
      if (ov > best || (ov == best && oj < best_j)) {
        best = ov;
        best_j = oj;
      }
      lse_merge(mx, s, s_mx[par][w], s_sum[par][w]);
    }
    const int j = best_j < K ? best_j : 0;  // torch.argmax of an all -inf row
    const float lse = logf(s) + mx;

    // the selected particle: block-uniform loads
    const float pair_sel = fmaxf(pair_of<DX>(q, qq, r, mr, c[j], K, j), kMinLogp);
    logq = __fsub_rn(__fadd_rn(__fadd_rn(logq, pair_sel), lwn[j]), lse);
    logp = __fadd_rn(__fadd_rn(logp, pair_sel), a.lg[row * K + j]);
#pragma unroll
    for (int d = 0; d < DX; ++d) q[d] = a.xs[(row * DX + d) * K + j];
    if (threadIdx.x == 0) {
      float* xt = a.xtilde + (row * M + m) * DX;
#pragma unroll
      for (int d = 0; d < DX; ++d) xt[d] = q[d];
      a.sel[row * M + m] = j;
    }
  }
  if (threadIdx.x == 0) {
    const size_t p = (size_t)b * M + m;
#pragma unroll
    for (int d = 0; d < DX; ++d) a.x_first[p * DX + d] = q[d];
    a.logp[p] = logp;
    a.logq[p] = logq;
  }
}

// d_xs of trajectory point pt = sum over the paths that selected each
// particle of their cotangent cot [M][DX], in path order; sel_s [M] holds
// point pt's selections. One owning thread per particle.
template <int DX>
__device__ __forceinline__ void scatter_point(const FfbsiBwdArgs& a, int pt, int b,
                                              const float* cot, const int* sel_s) {
  const int K = a.K, M = a.M;
  float* out = a.d_xs + ((size_t)pt * a.B + b) * DX * K;
  for (int j = threadIdx.x; j < K; j += kThreads) {
    float s[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) s[d] = 0.0f;
    for (int mm = 0; mm < M; ++mm) {
      if (sel_s[mm] == j) {
#pragma unroll
        for (int d = 0; d < DX; ++d) s[d] += cot[mm * DX + d];
      }
    }
#pragma unroll
    for (int d = 0; d < DX; ++d) out[d * K + j] = s[d];
  }
}

template <int DX>
__global__ void __launch_bounds__(kThreads) ffbsi_backward_kernel(const FfbsiBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int M = a.M, K = a.K, B = a.B, T1 = a.T1;
  float* qs = reinterpret_cast<float*>(smem);  // [M][DX]: this step's queries x~_{t+1}
  float* dq = qs + M * DX;                     // [M][DX]: their cotangents
  float* cot = dq + M * DX;                    // [M][DX]: a point's cotangents
  float* gp = cot + M * DX;                    // [M]: d logp
  float* gq = gp + M;                          // [M]: d logq
  float* mxs = gq + M;                         // [M]: max of the logits
  float* sums = mxs + M;                       // [M]: sum of exp(logits - max)
  int* sel = reinterpret_cast<int*>(sums + M); // [M]: this step's selections
  int* sel_p = sel + M;                        // [M]: a scattered point's selections

  const size_t row = (size_t)t * B + b;
  const bool pairs = a.d_logp != nullptr || a.d_logq != nullptr;
  for (int i = tid; i < M; i += kThreads) {
    gp[i] = a.d_logp != nullptr ? a.d_logp[(size_t)b * M + i] : 0.0f;
    gq[i] = a.d_logq != nullptr ? a.d_logq[(size_t)b * M + i] : 0.0f;
    sel[i] = a.sel[row * M + i];
  }
  for (int i = tid; i < M * DX; i += kThreads) {
    qs[i] = t == T1 - 1 ? a.x_anchor[(size_t)b * M * DX + i]
                        : a.xtilde[(row + B) * M * DX + i];  // point t+1
    dq[i] = 0.0f;
  }
  __syncthreads();

  const float* r = a.r + row * DX * K;
  const float* mr = a.mr + row * DX * K;
  const float* c = a.c + row * K;
  const float* lwn = a.lwn + row * K;
  if (pairs) {
    // 1. softmax statistics, one warp per path
    for (int mm = warp; mm < M; mm += kWarps) {
      float q[DX], qq[DX], mx, s;
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        q[d] = qs[mm * DX + d];
        qq[d] = __fmul_rn(q[d], q[d]);
      }
      warp_lse<DX>(q, qq, r, mr, c, lwn, K, mx, s);
      if (lane == 0) {
        mxs[mm] = mx;
        sums[mm] = s;
      }
    }
    __syncthreads();
    // 2. per-particle cotangents, the M paths added in order
    for (int j = tid; j < K; j += kThreads) {
      const float cj = c[j], lj = lwn[j];
      float dc = 0.0f, dlwn = 0.0f, dlg = 0.0f, dr[DX], dmr[DX];
#pragma unroll
      for (int d = 0; d < DX; ++d) dr[d] = dmr[d] = 0.0f;
      for (int mm = 0; mm < M; ++mm) {
        float q[DX], qq[DX];
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          q[d] = qs[mm * DX + d];
          qq[d] = __fmul_rn(q[d], q[d]);
        }
        const float raw = pair_of<DX>(q, qq, r, mr, cj, K, j);
        const float logit = __fadd_rn(fmaxf(raw, kMinLogp), lj);
        const float soft = expf(logit - mxs[mm]) / sums[mm];
        const bool oh = sel[mm] == j;
        const float g_q = gq[mm];
        float dp = (oh ? gp[mm] + g_q : 0.0f) - soft * g_q;
        dlwn += (oh ? g_q : 0.0f) - soft * g_q;
        if (oh) dlg += gp[mm];
        if (raw < kMinLogp) dp = 0.0f;  // the floor's cut
        dc += dp;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          dr[d] += -0.5f * qq[d] * dp;
          dmr[d] += q[d] * dp;
        }
      }
      if (a.d_c != nullptr) a.d_c[row * K + j] = dc;
      if (a.d_lwn != nullptr) a.d_lwn[row * K + j] = dlwn;
      if (a.d_lg != nullptr) a.d_lg[row * K + j] = dlg;
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        if (a.d_r != nullptr) a.d_r[(row * DX + d) * K + j] = dr[d];
        if (a.d_mr != nullptr) a.d_mr[(row * DX + d) * K + j] = dmr[d];
      }
    }
    // 3. d_q = sum_j d_pair (mr - q r), one warp per path
    for (int mm = warp; mm < M; mm += kWarps) {
      float q[DX], qq[DX], sa[DX], sb[DX];
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        q[d] = qs[mm * DX + d];
        qq[d] = __fmul_rn(q[d], q[d]);
        sa[d] = sb[d] = 0.0f;
      }
      const float mx = mxs[mm], s = sums[mm], g_q = gq[mm], g_sum = gp[mm] + g_q;
      const int jsel = sel[mm];
      for (int j = lane; j < K; j += 32) {
        const float raw = pair_of<DX>(q, qq, r, mr, c[j], K, j);
        if (raw < kMinLogp) continue;  // the floor's cut
        const float logit = __fadd_rn(raw, lwn[j]);
        const float dp = (j == jsel ? g_sum : 0.0f) - expf(logit - mx) / s * g_q;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          sa[d] = fmaf(dp, mr[d * K + j], sa[d]);
          sb[d] = fmaf(dp, r[d * K + j], sb[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        sa[d] = warp_sum(sa[d]);
        sb[d] = warp_sum(sb[d]);
      }
      if (lane == 0) {
#pragma unroll
        for (int d = 0; d < DX; ++d) dq[mm * DX + d] = sa[d] - q[d] * sb[d];
      }
    }
  } else {
    for (int j = tid; j < K; j += kThreads) {
      if (a.d_c != nullptr) a.d_c[row * K + j] = 0.0f;
      if (a.d_lwn != nullptr) a.d_lwn[row * K + j] = 0.0f;
      if (a.d_lg != nullptr) a.d_lg[row * K + j] = 0.0f;
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        if (a.d_r != nullptr) a.d_r[(row * DX + d) * K + j] = 0.0f;
        if (a.d_mr != nullptr) a.d_mr[(row * DX + d) * K + j] = 0.0f;
      }
    }
  }
  __syncthreads();

  // 4. d_q goes to the query: the anchor at the last step, else point t+1
  if (t == T1 - 1) {
    for (int i = tid; i < M * DX; i += kThreads) a.d_x_anchor[(size_t)b * M * DX + i] = dq[i];
  } else {
    const size_t pt = row + B;  // (t + 1) * B + b
    for (int i = tid; i < M * DX; i += kThreads)
      cot[i] = dq[i] + (a.d_xtilde != nullptr ? a.d_xtilde[pt * M * DX + i] : 0.0f);
    for (int i = tid; i < M; i += kThreads) sel_p[i] = a.sel[pt * M + i];
    __syncthreads();
    scatter_point<DX>(a, t + 1, b, cot, sel_p);
  }
  if (t == 0) {  // point 0 is nobody's query: d_xtilde[0] + d_x_first
    __syncthreads();
    for (int i = tid; i < M * DX; i += kThreads)
      cot[i] = (a.d_xtilde != nullptr ? a.d_xtilde[(size_t)b * M * DX + i] : 0.0f) +
               (a.d_x_first != nullptr ? a.d_x_first[(size_t)b * M * DX + i] : 0.0f);
    for (int i = tid; i < M; i += kThreads) sel_p[i] = sel[i];
    __syncthreads();
    scatter_point<DX>(a, 0, b, cot, sel_p);
  }
}

template <int DX>
cudaError_t launch_ffbsi_forward(const FfbsiFwdArgs& a, cudaStream_t stream) {
  ffbsi_forward_kernel<DX><<<a.B * a.M, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DX>
cudaError_t launch_ffbsi_backward(const FfbsiBwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * a.M * DX + 4 * a.M) + sizeof(int) * 2 * a.M;
  ffbsi_backward_kernel<DX><<<dim3(a.T1, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace psvo

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Each returns a cudaError_t; the launch is checked with cudaGetLastError().
extern "C" int psvo_ffbsi_forward(const float* x_anchor, const float* xs, const float* r,
                                  const float* mr, const float* c, const float* lwn,
                                  const float* lg, const float* gum, float* x_first, float* logp,
                                  float* logq, float* xtilde, int* sel, int B, int M, int K,
                                  int T1, int dx, void* stream) {
  const psvo::FfbsiFwdArgs a{x_anchor, xs,   r,    mr,     c,   lwn, lg, gum, x_first,
                             logp,     logq, xtilde, sel, B, M, K, T1};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 2: return psvo::launch_ffbsi_forward<2>(a, s);
    case 3: return psvo::launch_ffbsi_forward<3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int psvo_ffbsi_backward(const float* x_anchor, const float* xtilde, const int* sel,
                                   const float* r, const float* mr, const float* c,
                                   const float* lwn, const float* d_x_first, const float* d_logp,
                                   const float* d_logq, const float* d_xtilde, float* d_x_anchor,
                                   float* d_xs, float* d_r, float* d_mr, float* d_c, float* d_lwn,
                                   float* d_lg, int B, int M, int K, int T1, int dx,
                                   void* stream) {
  const psvo::FfbsiBwdArgs a{x_anchor, xtilde, sel,   r,     mr,   c,   lwn,  d_x_first,
                             d_logp,   d_logq, d_xtilde, d_x_anchor, d_xs, d_r, d_mr, d_c,
                             d_lwn,    d_lg,   B,     M,     K,    T1};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 2: return psvo::launch_ffbsi_backward<2>(a, s);
    case 3: return psvo::launch_ffbsi_backward<3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
