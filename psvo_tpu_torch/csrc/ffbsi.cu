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
// K5 has two designs; the path runs the staged design. Paths are
// independent: a path depends only on its own carry x~, and none of a step's
// support operands depends on it.
//
// The staged design (ffbsi_staged_kernel) lets a CTA of 256 threads serve
// P paths of one row (B * ceil(M / P) CTAs; P = 4 at the preset, 128 CTAs)
// and copies the row's r, mr, xs, c, lwn, lg and the P paths' Gumbel rows
// into shared memory a chunk ahead with cp.async (a ring of two slots; the
// whole row per chunk where two slots fit, else chunks of a multiple of 256
// particles), so the step's loads leave the critical path, and the row's
// operands are read from device memory once for P paths. The selected
// particle's state, lg and pair come from the copy that its thread made of
// the slot when the particle became its running best: no dependent load
// after the argmax. Thread tid visits the same particles as in the path
// design, so each path's selections and sums are the path design's bit for
// bit.
//
// The path design (ffbsi_forward_kernel, the previous one, kept as its
// yardstick): one CTA of 256 threads walks one path through all T-1 steps
// (the TPU kernel's sequential t grid axis): B*M = 512 CTAs, about four per
// SM, each reading its row's operands from L2 every step. Per step each
// thread visits particles j = tid, tid + 256, ... once and keeps the running
// argmax of logits + gum (ascending j, strict >: the first maximum) and an
// online (max, sum of exp) of the logits; warp butterflies and then one
// merge of the eight warps in a fixed order combine them, ties to the lower
// index, so every thread ends with the same selection and lse. The selected
// particle's pair, lwn, lg and state are then block-uniform loads. One
// barrier per step (the warps' partials are double-buffered by the step's
// parity). One warp per path (four warps per SM) was 3.5x slower on the
// H100: each of its 32 iterations per step waited on its own loads.
//
// Besides the op's outputs K5 writes the selections sel [T-1, B, M] (int32)
// for K6.
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
// alone. The path design is latency-bound: each step's loads, reductions
// and the dependent load of the selected particle lie on the sweep's
// critical path; the staged design takes the loads off it.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "resample.cuh"

namespace psvo {

constexpr float kMinLogp = -1e30f;  // distributions._MIN_LOGP
constexpr int kLseWindow = 32;  // K5 staged: steps whose lse is merged at once

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
__device__ __forceinline__ float pair_vals(const float (&q)[DX], const float (&qq)[DX],
                                           const float (&r)[DX], const float (&mr)[DX], float c) {
  float t1 = __fmul_rn(qq[0], r[0]);
  float t2 = __fmul_rn(q[0], mr[0]);
#pragma unroll
  for (int d = 1; d < DX; ++d) {
    t1 = __fadd_rn(t1, __fmul_rn(qq[d], r[d]));
    t2 = __fadd_rn(t2, __fmul_rn(q[d], mr[d]));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(-0.5f, t1), t2), c);
}

// pair_vals of particle j, with r and mr rows of stride K.
template <int DX>
__device__ __forceinline__ float pair_of(const float (&q)[DX], const float (&qq)[DX],
                                         const float* __restrict__ r,
                                         const float* __restrict__ mr, float c, int K, int j) {
  float rv[DX], mv[DX];
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    rv[d] = r[d * K + j];
    mv[d] = mr[d * K + j];
  }
  return pair_vals<DX>(q, qq, rv, mv, c);
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

// lse_push and lse_merge written with selects instead of branches: the same
// arithmetic, so the same bits, and no divergence, so a thread can run
// several paths' updates interleaved.
__device__ __forceinline__ void lse_push_sel(float x, float& mx, float& s) {
  const bool up = x > mx;
  const float e = expf(up ? mx - x : x - mx);
  s = up ? s * e + 1.0f : s + e;
  mx = up ? x : mx;
}

__device__ __forceinline__ void lse_merge_sel(float& mx, float& s, float om, float os) {
  const float nm = fmaxf(mx, om);
  const float ea = expf(mx - nm), eb = expf(om - nm);
  const float a = mx == nm ? s : (s == 0.0f ? 0.0f : s * ea);
  const float b = om == nm ? os : (os == 0.0f ? 0.0f : os * eb);
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

// The spans of one staged chunk: the row's r, mr, xs (DX rows each), c, lwn,
// lg, then the P paths' Gumbel rows, particles j0 .. j0 + n - 1, each into a
// slot row of KS floats; a path past M is not copied. With vec (K a multiple
// of 4: every span 16-byte aligned) thread 0 issues them as bulk copies that
// complete on bar: for a whole row (n = K = KS) seven, since r's, mr's and
// xs's DX rows and the P Gumbel rows lie back to back in device memory as
// in the slot (one copy a span, sixteen a step at P = 4, K = 1024, made the
// sweep 1.7 times as long on the H100: tools/stage_profile.py); else one a
// span. Without vec every thread issues 4-byte cp.async copies (the caller
// commits and waits).
template <int DX>
__device__ __forceinline__ void stage_chunk(const FfbsiFwdArgs& a, float* slot, int KS, int P,
                                            int b, int m0, int t, int j0, int n, bool vec,
                                            uint64_t* bar) {
  const size_t row = (size_t)t * a.B + b;
  const int K = a.K, live = a.M - m0 < P ? a.M - m0 : P;
  if (vec) {
    if (threadIdx.x != 0) return;
    bulk_fence();  // the block's reads of this slot (ordered by a barrier) come first
    mbar_expect_tx(bar, static_cast<unsigned>((3 * DX + 3 + live) * n * sizeof(float)));
    if (n == K) {
      const unsigned row_bytes = static_cast<unsigned>(n * sizeof(float));
      const float* per_state[3] = {a.r, a.mr, a.xs};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        bulk_copy(slot + q * DX * KS, per_state[q] + row * DX * K, DX * row_bytes, bar);
      }
      const float* per_particle[3] = {a.c, a.lwn, a.lg};
#pragma unroll
      for (int q = 0; q < 3; ++q) bulk_copy(slot + (3 * DX + q) * KS, per_particle[q] + row * K, row_bytes, bar);
      bulk_copy(slot + (3 * DX + 3) * KS, a.gum + (row * a.M + m0) * K, live * row_bytes, bar);
      return;
    }
  }
  for (int sp = 0; sp < 3 * DX + 3 + live; ++sp) {
    const float* src;
    if (sp < 3 * DX) {
      const float* base = sp < DX ? a.r : sp < 2 * DX ? a.mr : a.xs;
      src = base + (row * DX + sp % DX) * K;
    } else if (sp < 3 * DX + 3) {
      const float* base = sp == 3 * DX ? a.c : sp == 3 * DX + 1 ? a.lwn : a.lg;
      src = base + row * K;
    } else {
      src = a.gum + (row * a.M + m0 + sp - 3 * DX - 3) * K;
    }
    src += j0;
    float* dst = slot + sp * KS;
    if (vec) {
      bulk_copy(dst, src, static_cast<unsigned>(n * sizeof(float)), bar);
    } else {
      for (int u = threadIdx.x; u < n; u += kThreads) cp_async4(dst + u, src + u);
    }
  }
}

// K5, design "staged": a CTA serves P paths of one row (P in {1, 2, 4, 8};
// B * ceil(M / P) CTAs). The row's operands of a step do not depend on the
// carry, so they are copied into shared memory ahead while the current chunk
// is computed: a ring of NS slots (3 where they fit, else 2), each chunk
// issued NS - 1 chunks ahead, right after the barrier that shows every
// thread done with the slot's last chunk; chunks of KC particles (the whole
// row where two slots fit, else a multiple of 256), walked t = T-2 .. 0 and
// chunk by chunk. Where K is a multiple of 4 a chunk arrives by bulk copies
// on one mbarrier a slot, else by 4-byte cp.async copies. Thread tid visits
// particles j = tid, tid + 256, ... as the previous design does and computes
// the P paths' logits from one load of each particle's r, mr, c and lwn; per
// path it keeps the running argmax (strict >, j ascending: the first
// maximum) and the online (max, sum of exp), all without a branch. Per path
// the warp's butterfly (xor 16 .. 1) runs as a reduce-scatter over the P
// paths: at each level a lane keeps half the paths it holds and merges its
// partner's partials of those; the merges are symmetric, so a lane ends with
// what every lane of the previous design's butterfly held, for its own path,
// at a third of the shuffles and merges (P = 4). With the merge of the eight
// warps in order (ties to the lower index) the selections, x~, x_first,
// logp and logq are the previous design's bit for bit; every warp merges the
// P paths' argmax over the eight warps as a shuffle tree across its lanes
// (the argmax merge does not depend on the order; every thread needs every
// path's new state). The lse of path p merges its eight warps' partials in
// order too, but off the step's critical path: the steps' partials wait in a
// window of 32 steps, whose lse values are then merged in parallel, and lane
// 0 of warp p adds them to logq in step order. The
// pick's state, lg, lwn and pair (recomputed) come from the slot, where the
// whole row still lies, with no load from device memory; in a chunked row
// (WHOLE false) the pick's chunk may have left the ring, so each thread also
// copies its running best's operands from the slot and the winning lane's
// copy serves.
template <int DX, int P, bool WHOLE>
__global__ void __launch_bounds__(kThreads) ffbsi_staged_kernel(const FfbsiFwdArgs a, int KC,
                                                                int NS) {
  constexpr int NPAY = DX + 3;  // floored pair, lwn, lg, x~
  constexpr int W = kLseWindow;
  extern __shared__ __align__(16) float ring[];
  __shared__ float s_best[kWarps][P];
  // a window of W steps: the warps' (max, sum) of each path, the pick's pair and lwn, the lse
  __shared__ float s_mx[W][kWarps][P], s_sum[W][kWarps][P], s_pl[W][P][2], s_lse[W][P];
  __shared__ float s_pay[kWarps][P][NPAY];
  __shared__ int s_j[kWarps][P];
  __shared__ float s_pay0[P][NPAY];  // particle 0's: the argmax of an all -inf row
  __shared__ __align__(8) uint64_t s_bar[3];  // a slot's bulk copies complete on its barrier
  const int K = a.K, M = a.M, T1 = a.T1;
  const int G = (M + P - 1) / P, b = blockIdx.x / G, m0 = (blockIdx.x % G) * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KS = (KC + 3) & ~3, slot_floats = (3 * DX + 3 + P) * KS;
  const int NCH = (K + KC - 1) / KC, total = T1 * NCH;
  const bool vec = (K & 3) == 0;
  float q[P][DX], qq[P][DX], pay[P][NPAY], best[P], mx[P], ssum[P];
  int best_j[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      q[p][d] = m0 + p < M ? a.x_anchor[((size_t)b * M + m0 + p) * DX + d] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NPAY; ++i) pay[p][i] = 0.0f;
  }
  float logp = 0.0f, logq = 0.0f;  // of path warp, in its lane 0 (warp < P)
  if (vec && tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&s_bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // chunk u: step T1 - 1 - u / NCH, particles (u % NCH) * KC ..., slot u % NS
  auto stage = [&](int u) {
    const int ju = (u % NCH) * KC;
    stage_chunk<DX>(a, ring + (u % NS) * slot_floats, KS, P, b, m0, T1 - 1 - u / NCH, ju,
                    K - ju < KC ? K - ju : KC, vec, &s_bar[u % NS]);
  };
  for (int u = 0; u < NS - 1 && u < total; ++u) {
    stage(u);
    if (!vec) cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    if (vec) {
      mbar_wait(&s_bar[s % NS], (s / NS) & 1);  // the slot's (s / NS)-th fill
    } else if (NS > 2 && s + 1 < total) {  // cp.async: chunk s + 1 may stay in flight
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk s is in its slot; every thread is done with chunk s - 1
    if (s + NS - 1 < total) {  // into chunk s - 1's slot
      stage(s + NS - 1);
      if (!vec) cp_async_commit();
    }
    const int t = T1 - 1 - s / NCH, ch = s % NCH, j0 = ch * KC;
    const int n = K - j0 < KC ? K - j0 : KC;
    const float* sl = ring + (s % NS) * slot_floats;
    const float* c = sl + 3 * DX * KS;
    const float* lwn = c + KS;
    const float* lg = lwn + KS;
    const float* gum = lg + KS;  // [P][KS]
    if (ch == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        best[p] = mx[p] = __int_as_float(0xff800000);
        ssum[p] = 0.0f;
        best_j[p] = K;  // loses every tie against a real index
#pragma unroll
        for (int d = 0; d < DX; ++d) qq[p][d] = __fmul_rn(q[p][d], q[p][d]);
      }
    }
    for (int jl = tid; jl < n; jl += kThreads) {
      // the particle's operands, read once for the P paths
      float cp[NPAY], rv[DX], mv[DX];
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        rv[d] = sl[d * KS + jl];
        mv[d] = sl[(DX + d) * KS + jl];
        cp[3 + d] = sl[(2 * DX + d) * KS + jl];
      }
      const float cj = c[jl];
      cp[1] = lwn[jl];
      cp[2] = lg[jl];
      float pairs[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {  // no branch: the paths' updates interleave
        pairs[p] = fmaxf(pair_vals<DX>(q[p], qq[p], rv, mv, cj), kMinLogp);
        const float logit = __fadd_rn(pairs[p], cp[1]);
        const float v = __fadd_rn(logit, gum[p * KS + jl]);
        const bool up = v > best[p];  // j ascends: the first maximum is kept
        best[p] = up ? v : best[p];
        best_j[p] = up ? j0 + jl : best_j[p];
        if constexpr (!WHOLE) {  // a chunked row: the pick's operands may leave the ring
          pay[p][0] = up ? pairs[p] : pay[p][0];
#pragma unroll
          for (int i = 1; i < NPAY; ++i) pay[p][i] = up ? cp[i] : pay[p][i];
        }
        lse_push_sel(logit, mx[p], ssum[p]);
      }
      if (!WHOLE && j0 + jl == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          s_pay0[p][0] = pairs[p];
#pragma unroll
          for (int i = 1; i < NPAY; ++i) s_pay0[p][i] = cp[i];
        }
      }
    }
    if (ch + 1 < NCH) continue;  // the next chunk of the step
    int my_j[P];
#pragma unroll
    for (int p = 0; p < P; ++p) my_j[p] = best_j[p];
    // the warp's butterfly as a reduce-scatter: position k of a lane holds the
    // k-th path of the set it keeps; after the five levels, position 0 holds
    // path lane / (32 / P)
#pragma unroll
    for (int lvl = 0; lvl < 5; ++lvl) {
      const int o = 16 >> lvl, n = P >> lvl > 1 ? P >> lvl : 1, half = n > 1 ? n / 2 : 1;
      const bool upper = n > 1 && (lane & o) != 0;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const int lo = k, hi = n > 1 ? half + k : k;  // the kept one and the one given away
        const float ov = __shfl_xor_sync(kFull, upper ? best[lo] : best[hi], o);
        const int oj = __shfl_xor_sync(kFull, upper ? best_j[lo] : best_j[hi], o);
        const float om = __shfl_xor_sync(kFull, upper ? mx[lo] : mx[hi], o);
        const float os = __shfl_xor_sync(kFull, upper ? ssum[lo] : ssum[hi], o);
        float b_ = upper ? best[hi] : best[lo], m_ = upper ? mx[hi] : mx[lo];
        float s_ = upper ? ssum[hi] : ssum[lo];
        int j_ = upper ? best_j[hi] : best_j[lo];
        const bool take = ov > b_ || (ov == b_ && oj < j_);
        best[k] = take ? ov : b_;
        best_j[k] = take ? oj : j_;
        lse_merge_sel(m_, s_, om, os);
        mx[k] = m_;
        ssum[k] = s_;
      }
    }
    const int step = s / NCH, wi = step % W;  // the step's place in the lse window
    if ((lane & (32 / P - 1)) == 0) {  // the first lane of each path's group
      const int p = lane / (32 / P);
      s_best[warp][p] = best[0];
      s_j[warp][p] = best_j[0];
      s_mx[wi][warp][p] = mx[0];
      s_sum[wi][warp][p] = ssum[0];
    }
    if constexpr (!WHOLE) {
      __syncwarp();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (my_j[p] < K && my_j[p] == s_j[warp][p]) {  // the lane that saw the warp's pick
#pragma unroll
          for (int i = 0; i < NPAY; ++i) s_pay[warp][p][i] = pay[p][i];
        }
      }
    }
    __syncthreads();
    // the argmax over the eight warps: lane (p % 4) * 8 + w holds path p's
    // warp w, three butterfly levels merge the eight (max value, then the
    // lower index: the same pick in any order), lane (p % 4) * 8 has it
    int win_j[P], win_w[P];
#pragma unroll
    for (int r = 0; r < (P + 3) / 4; ++r) {
      const int p = r * 4 + (lane >> 3), w = lane & 7;
      float bv = p < P ? s_best[w][p] : __int_as_float(0xff800000);
      int bj = p < P ? s_j[w][p] : K, bw = w;
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oj = __shfl_xor_sync(kFull, bj, o);
        const int ow = __shfl_xor_sync(kFull, bw, o);
        const bool take = ov > bv || (ov == bv && oj < bj);
        bv = take ? ov : bv;
        bj = take ? oj : bj;
        bw = take ? ow : bw;
      }
#pragma unroll
      for (int i = 0; i < 4 && r * 4 + i < P; ++i) {
        win_j[r * 4 + i] = __shfl_sync(kFull, bj, i * 8);
        win_w[r * 4 + i] = __shfl_sync(kFull, bw, i * 8);
      }
    }
    const size_t row = (size_t)t * a.B + b;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int bj = win_j[p], j = bj < K ? bj : 0;  // torch.argmax of all -inf: 0
      // the pick's floored pair (from the old state), lwn, lg and state: the
      // whole row is still in its slot (refilled only after the next barrier)
      float ps[NPAY];
      if constexpr (WHOLE) {
        float rv[DX], mv[DX];
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          rv[d] = sl[d * KS + j];
          mv[d] = sl[(DX + d) * KS + j];
          ps[3 + d] = sl[(2 * DX + d) * KS + j];
        }
        ps[0] = fmaxf(pair_vals<DX>(q[p], qq[p], rv, mv, c[j]), kMinLogp);
        ps[1] = lwn[j];
        ps[2] = lg[j];
      } else {
        const float* src = bj < K ? s_pay[win_w[p]][p] : s_pay0[p];
#pragma unroll
        for (int i = 0; i < NPAY; ++i) ps[i] = src[i];
      }
#pragma unroll
      for (int d = 0; d < DX; ++d) q[p][d] = ps[3 + d];
      if (tid == 32 * p && m0 + p < M) {
        s_pl[wi][p][0] = ps[0];
        s_pl[wi][p][1] = ps[1];
        logp = __fadd_rn(__fadd_rn(logp, ps[0]), ps[2]);
        float* xt = a.xtilde + (row * M + m0 + p) * DX;
#pragma unroll
        for (int d = 0; d < DX; ++d) xt[d] = q[p][d];
        a.sel[row * M + m0 + p] = j;
      }
    }
    if (wi == W - 1 || step == T1 - 1) {  // the window's lse, its steps in parallel, then logq
      __syncthreads();
      for (int e = tid; e < (wi + 1) * P; e += kThreads) {
        const int i = e / P, p = e % P;
        float lm = s_mx[i][0][p], ls = s_sum[i][0][p];
        for (int w = 1; w < kWarps; ++w) lse_merge_sel(lm, ls, s_mx[i][w][p], s_sum[i][w][p]);
        s_lse[i][p] = logf(ls) + lm;  // the eight warps merged in order, as one step would
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (tid == 32 * p) {  // the steps in order
          for (int i = 0; i <= wi; ++i) {
            logq = __fsub_rn(__fadd_rn(__fadd_rn(logq, s_pl[i][p][0]), s_pl[i][p][1]), s_lse[i][p]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (tid == 32 * p && m0 + p < M) {
      const size_t pt = (size_t)b * M + m0 + p;
#pragma unroll
      for (int d = 0; d < DX; ++d) a.x_first[pt * DX + d] = q[p][d];
      a.logp[pt] = logp;
      a.logq[pt] = logq;
    }
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

// The staged design's slots (3 where they fit beside the static arrays, else
// 2) and its dynamic shared memory.
constexpr size_t kStagedSmemLimit = 232448 - 24576;  // the static arrays take at most 24 KB
template <int DX>
size_t ffbsi_staged_slot_bytes(int P, int KC) {
  return sizeof(float) * (3 * DX + 3 + P) * ((KC + 3) & ~3);
}
template <int DX>
int ffbsi_staged_slots(int P, int KC) {
  return 3 * ffbsi_staged_slot_bytes<DX>(P, KC) <= kStagedSmemLimit ? 3 : 2;
}

template <int DX, int P>
cudaError_t launch_ffbsi_staged(const FfbsiFwdArgs& a, int KC, cudaStream_t stream) {
  if (KC < 1 || (KC < a.K && KC % kThreads != 0)) return cudaErrorInvalidValue;
  if (KC > a.K) KC = a.K;
  const int NS = ffbsi_staged_slots<DX>(P, KC);
  const size_t smem = NS * ffbsi_staged_slot_bytes<DX>(P, KC);
  auto kernel = KC == a.K ? ffbsi_staged_kernel<DX, P, true> : ffbsi_staged_kernel<DX, P, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.B * ((a.M + P - 1) / P), kThreads, smem, stream>>>(a, KC, NS);
  return cudaGetLastError();
}

template <int DX>
cudaError_t launch_ffbsi_staged(const FfbsiFwdArgs& a, int P, int KC, cudaStream_t stream) {
  switch (P) {
    case 1: return launch_ffbsi_staged<DX, 1>(a, KC, stream);
    case 2: return launch_ffbsi_staged<DX, 2>(a, KC, stream);
    case 4: return launch_ffbsi_staged<DX, 4>(a, KC, stream);
    case 8: return launch_ffbsi_staged<DX, 8>(a, KC, stream);
    default: return cudaErrorInvalidValue;
  }
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
                                  int T1, int dx, int design, int paths, int chunk,
                                  void* stream) {
  const psvo::FfbsiFwdArgs a{x_anchor, xs,   r,    mr,     c,   lwn, lg, gum, x_first,
                             logp,     logq, xtilde, sel, B, M, K, T1};
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {  // staged: paths a CTA, chunk particles a stage
    switch (dx) {
      case 2: return psvo::launch_ffbsi_staged<2>(a, paths, chunk, s);
      case 3: return psvo::launch_ffbsi_staged<3>(a, paths, chunk, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (design != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dx) {  // path: one CTA a path (paths and chunk unread)
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
