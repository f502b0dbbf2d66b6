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
// K6 has two designs; the path runs the staged design (see "K6, design
// staged" below). Both read K5's selections where the TPU kernel recomputes
// each step's argmax from gum: the same function without gum's bytes (the
// largest operand), and teacher-forced as K4 is on K1's ancestors. d_q, the
// cotangent of step t's query, depends only on step t's own inputs (the TPU
// kernel's dq_c scratch only hands it on to step t+1's output), so every
// step runs at once. The row design (ffbsi_backward_kernel, the previous
// one, kept as design "row", its yardstick) runs one CTA per (t, b):
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
#include <limits>
#include <type_traits>

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

// ---- K6, design "staged" ----
//
// Replaces the row design above (ffbsi_backward_kernel, kept as design "row",
// its yardstick). It computes what pallas_ffbsi._bwd_kernel computes, on K5's
// selections, in two kernels, one per branch:
//
// Paths only (no d_logp, no d_logq: PSVO training under the forward bound).
// No pair carries a cotangent, so d_q = 0 and the op is a scatter: d_xs of
// point t is zero but at the at most M selected particles. Bytes bound it (at
// the preset the 38.9 MB of d_xs it writes: 0.0119 ms); the row design spent
// its time on dependent loads before its first store. ffbsi_bwd_paths_kernel
// runs a persistent grid, as many CTAs an SM as fit, each owning batches of
// kK6PathRows whole (t, b) rows of d_xs: per batch it streams zeros with
// 16-byte stores that wait on no load while the batch's selections and
// cotangents arrive (cp.async, issued a batch ahead into the other of two
// buffers); after one barrier it patches the selected particles
// (patch_point). Nothing of the pair is loaded.
//
// All cotangents (ffbsi_bwd_staged_kernel). The row design evaluated each
// (m, j) pair three times (one warp per path twice, 32 dependent loads deep,
// and once per particle with an IEEE division per (m, j)), each pass
// reloading r, mr, c and lwn from device memory. Here a persistent grid (as
// many CTAs as the card holds: two an SM at 128 registers) walks the (t, b)
// rows; each row's r, mr, c and lwn (32 KB at Dx = 3, K = 1024) and its
// paths' queries, cotangents and selections are copied into one of two
// shared-memory buffers while the CTA works on the previous row (bulk copies
// on an mbarrier where K is a multiple of 4, else cp.async), and the d_xs
// rows it will patch are zeroed then too. Thread tid owns the kK6Per
// consecutive particles tid*4 .. tid*4 + 3 and evaluates each (m, j) pair
// once, for G = kK6Group paths at a time, in the plain version's order of
// rounded operations (pair_vals: Lorenz-63's expanded pair cancels, so a
// fused product would move the logits), the logits held in registers. Per
// path the CTA takes the exact max (warp reduce-scatter, then the eight
// warps), then e_j = exp(logit_j - max) and, in one more reduce-scatter and
// merge of the eight warps in order, sum e, sum e*mr_d and sum e*r_d; 1/sum
// is taken once per path. d_pair = oh*(gp + gq) - s with s = e*gq/sum: each
// thread adds s, -1/2 q^2 s and q s per particle over the paths in path
// order, and after the last group the picks' oh*(gp + gq) terms, and writes
// d_c, d_r, d_mr, d_lwn and d_lg with 16-byte stores. The floor's cut (d_pair
// = 0 where the unfloored pair < -1e30) costs nothing per pair: a floored
// logit lies 1e30 below any unfloored one, so its e is exactly 0 and a path
// never picks it, unless the path's own max is floored (below -1e29); only
// such a group recomputes its pairs and cuts them one by one. d_q needs no
// pass of its own:
//   d_q_d = [pick not cut]*(gp + gq)*(mr_d[pick] - q_d*r_d[pick])
//           - gq/sum * (sum e*mr_d - q_d * sum e*r_d)   (cut pairs left out).
// Then d_xs is patched as above, with cot = d_q + d_xtilde. Bytes bound it
// (0.0779 ms at the preset); the stage marks of tools/stage_profile.py show
// where the time goes (PERF.md).
//
// Rows past kK6Chunk = 1024 particles (ONE false) do not fit the registers
// (nor, past K ~ 7,000, shared memory): one CTA per (t, b) stages them in
// chunks of 1024, twice. A first pass merges each chunk's per-path max and
// sums into running ones (rescaled, chunk order) in shared memory; a second
// pass recomputes the logits chunk by chunk, forms d_pair from the final max
// and sum and writes the chunk's cotangents. Both designs are deterministic:
// no atomics.
constexpr int kK6Per = 4;                      // consecutive particles a thread owns
constexpr int kK6Chunk = kThreads * kK6Per;    // particles a pass covers
constexpr int kK6Group = 8;                    // G: paths whose logits a thread holds
constexpr int kK6PathRows = 1;                 // paths only: rows of d_xs a CTA zeroes at once
constexpr int kK6MaxM = 256;                   // ops/ffbsi.py MAX_M
constexpr float kNegInf = -std::numeric_limits<float>::infinity();

inline bool k6_aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// n floats from p zeroed by the block (16-byte stores where vec: p 16-byte
// aligned, n a multiple of 4).
__device__ __forceinline__ void zero_span(float* p, int n, bool vec) {
  if (vec) {
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.0f;
  }
}

// d_xs of one point (out: [DX][K], already zeroed and ordered before by a
// barrier): each selected particle gets the sum over the paths that selected
// it of their cotangents cot(e, d), in path order from 0.0f, written by the
// thread of the first path that selected it: the row design's sums bit for
// bit. Paths m0 + tid, m0 + tid + step, ... of the point are this thread's.
template <int DX, class Cot>
__device__ __forceinline__ void patch_point(float* out, int K, int M, Cot cot, const int* sel,
                                            int first, int step) {
  for (int m = first; m < M; m += step) {
    const int j = sel[m];
    bool owner = true;
#pragma unroll 4
    for (int e = 0; e < m; ++e) owner = owner && sel[e] != j;
    if (!owner) continue;
    float s[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) s[d] = 0.0f;
#pragma unroll 4
    for (int e = m; e < M; ++e) {
      if (sel[e] == j) {
#pragma unroll
        for (int d = 0; d < DX; ++d) s[d] += cot(e, d);
      }
    }
#pragma unroll
    for (int d = 0; d < DX; ++d) out[d * K + j] = s[d];
  }
}

// Shared memory of the paths-only kernel, in floats: two buffers of R rows'
// selections [M] (ints), d_xtilde [M][DX] and (point 0) d_x_first [M][DX].
__host__ __device__ inline int k6_paths_floats(int M, int DX, int R) {
  return 2 * R * (M + 2 * M * DX);
}

template <int DX>
__global__ void __launch_bounds__(kThreads) ffbsi_bwd_paths_kernel(const FfbsiBwdArgs a, int vec,
                                                                    int R) {
  extern __shared__ __align__(16) float sp[];
  const int M = a.M, K = a.K, B = a.B, T1 = a.T1, rows = T1 * B, tid = threadIdx.x;
  const int per_row = M + 2 * M * DX, batches = (rows + R - 1) / R;
  // batch `batch`'s selections and cotangents into buffer bf (4-byte
  // cp.async; zeros where a cotangent is absent), committed
  auto issue = [&](int batch, float* bf) {
    for (int e = tid; e < R * M; e += kThreads) {
      const int r = e / M, m = e % M, row = batch * R + r;
      if (row < rows) cp_async4(bf + r * per_row + m, a.sel + (size_t)row * M + m);
    }
    for (int e = tid; e < R * M * DX; e += kThreads) {
      const int r = e / (M * DX), i = e % (M * DX), row = batch * R + r;
      if (row >= rows) continue;
      float* dst = bf + r * per_row + M;
      if (a.d_xtilde != nullptr) cp_async4(dst + i, a.d_xtilde + (size_t)row * M * DX + i);
      else dst[i] = 0.0f;
      if (row < B) {  // point 0
        if (a.d_x_first != nullptr) cp_async4(dst + M * DX + i, a.d_x_first + (size_t)row * M * DX + i);
        else dst[M * DX + i] = 0.0f;
      }
    }
    cp_async_commit();
  };
  int batch = blockIdx.x;
  if (batch < batches) issue(batch, sp);
  for (int it = 0; batch < batches; batch += gridDim.x, ++it) {
    float* bf = sp + (it & 1) * R * per_row;
    for (int r = 0; r < R; ++r) {  // stores that wait on no load
      const int row = batch * R + r;
      if (row >= rows) break;
      zero_span(a.d_xs + (size_t)row * DX * K, DX * K, vec);
      // no pair cotangent: the support terms' cotangents are zero, and so is the anchor's
      if (a.d_r != nullptr) zero_span(a.d_r + (size_t)row * DX * K, DX * K, vec);
      if (a.d_mr != nullptr) zero_span(a.d_mr + (size_t)row * DX * K, DX * K, vec);
      if (a.d_c != nullptr) zero_span(a.d_c + (size_t)row * K, K, vec);
      if (a.d_lwn != nullptr) zero_span(a.d_lwn + (size_t)row * K, K, vec);
      if (a.d_lg != nullptr) zero_span(a.d_lg + (size_t)row * K, K, vec);
      if (row / B == T1 - 1) zero_span(a.d_x_anchor + (size_t)(row % B) * M * DX, M * DX, false);
    }
    cp_async_wait<0>();
    __syncthreads();  // the batch's operands in, the zeros before the patch, the other buffer free
    if (batch + (int)gridDim.x < batches) issue(batch + gridDim.x, sp + ((it + 1) & 1) * R * per_row);
    for (int r = 0; r < R; ++r) {
      const int row = batch * R + r;
      if (row >= rows) break;
      const float* xt = bf + r * per_row + M;
      const float* xf = xt + M * DX;
      const bool zero_pt = row < B;  // point 0: d_xtilde[0] + d_x_first; else 0 + d_xtilde[t]
      // the paths of the R rows are spread over the threads: row r takes
      // thread (tid - r * M) mod 256's turn
      const int first = (tid - r * M % kThreads + kThreads) % kThreads;
      patch_point<DX>(a.d_xs + (size_t)row * DX * K, K, M,
                      [&](int e, int d) {
                        return zero_pt ? xt[e * DX + d] + xf[e * DX + d] : 0.0f + xt[e * DX + d];
                      },
                      reinterpret_cast<const int*>(bf + r * per_row), first, kThreads);
    }
  }
}

// Reduce-scatter of G per-path partials v[0..G) across a warp (+, or max):
// at each level (xor O, H paths kept) a lane keeps half the paths it holds
// and adds its partner's partials of those, then plain butterflies. Returns
// the warp's total of path lane / (32 / G), the same bits in each of that
// path's lanes. The levels are template steps, so every index is static and
// v stays in registers.
template <bool MAX, int H, int O, int G>
__device__ __forceinline__ void scatter_level(float (&v)[G], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      const float got = __shfl_xor_sync(kFull, send, O);
      v[i] = MAX ? fmaxf(keep, got) : keep + got;
    }
    scatter_level<MAX, H / 2, O / 2>(v, lane);
  }
}

template <int G, bool MAX>
__device__ __forceinline__ float warp_scatter(float (&v)[G]) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two up to 32");
  scatter_level<MAX, G / 2, 16>(v, threadIdx.x & 31);
  float r = v[0];
#pragma unroll
  for (int o = 16 / G; o >= 1; o >>= 1) {
    const float got = __shfl_xor_sync(kFull, r, o);
    r = MAX ? fmaxf(r, got) : r + got;
  }
  return r;
}

// Shared memory of the all-cotangents kernel, in floats; ops/ffbsi.py::
// k6_smem_bytes mirrors it. A row buffer holds what one (t, b) reads: a
// chunk's r, mr, c and lwn (rows of KC floats), the queries, d_xtilde of
// point t + 1 and, for step 0, d_xtilde[0] and d_x_first, the paths' d logp
// and d logq, the selections of step t and of point t + 1. Whole rows (ONE)
// keep two buffers: the next row's copies land in one while the CTA works
// on the other.
struct K6Layout {
  int KC, st, pq, pxn, px0, pxf, pgp, pgq, psel, nsel, buf;  // inside a buffer; buf its floats
  int pst, dq, cot, csel, red, redm, total;                 // from the start
};

__host__ __device__ inline int k6_up4(int n) { return (n + 3) & ~3; }

template <int DX, int G, bool ONE>
__host__ __device__ inline K6Layout k6_layout(int M, int K) {
  K6Layout l;
  l.KC = ONE ? k6_up4(K) : kK6Chunk;
  int o = 0;
  l.st = o;   o += (2 * DX + 2) * l.KC;
  l.pq = o;   o += k6_up4(M * DX);
  l.pxn = o;  o += k6_up4(M * DX);
  l.px0 = o;  o += k6_up4(M * DX);
  l.pxf = o;  o += k6_up4(M * DX);
  l.pgp = o;  o += k6_up4(M);
  l.pgq = o;  o += k6_up4(M);
  l.psel = o; o += k6_up4(M);                                  // ints
  l.nsel = o; o += k6_up4(M);                                  // ints
  l.buf = o;
  o *= ONE ? 2 : 1;
  l.pst = o;  o += k6_up4(M * (2 + 2 * DX));                   // max, sum, sum e*mr, sum e*r
  l.dq = o;   o += k6_up4(M * DX);
  l.cot = o;  o += k6_up4(M * DX);
  l.csel = o; o += k6_up4(M);                                  // ints: the pick's pair is floored
  l.red = o;  o += (1 + 2 * DX) * G * kWarps;                  // [quantity][path][warp]
  l.redm = o; o += G * kWarps;                                 // [path][warp]
  l.total = o;
  return l;
}

// The r, mr, c and lwn of particles j0 .. j0 + n - 1 of row `row` into the
// stage (rows of KC floats): 16-byte cp.async where vec, else 4-byte.
template <int DX>
__device__ __forceinline__ void k6_stage(const FfbsiBwdArgs& a, float* st, int KC, size_t row,
                                         int j0, int n, bool vec) {
  const int K = a.K;
  for (int sp = 0; sp < 2 * DX + 2; ++sp) {
    const float* src = sp < DX       ? a.r + (row * DX + sp) * K
                       : sp < 2 * DX ? a.mr + (row * DX + sp - DX) * K
                       : sp == 2 * DX ? a.c + row * K
                                      : a.lwn + row * K;
    src += j0;
    float* dst = st + sp * KC;
    if (vec) {
      for (int u = threadIdx.x; u < n / 4; u += kThreads) cp_async16(dst + 4 * u, src + 4 * u);
    } else {
      for (int u = threadIdx.x; u < n; u += kThreads) cp_async4(dst + u, src + u);
    }
  }
}

// Whole rows with vec: thread 0 copies row `row`'s r and mr (DX rows each,
// back to back in device memory as in the stage), c and lwn as four bulk
// copies that complete on bar.
template <int DX>
__device__ __forceinline__ void k6_stage_bulk(const FfbsiBwdArgs& a, float* st, size_t row,
                                              uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const int K = a.K;
  const unsigned bytes = static_cast<unsigned>(K * sizeof(float));
  bulk_fence();  // the block's reads of this buffer (ordered by a barrier) come first
  mbar_expect_tx(bar, (2 * DX + 2) * bytes);
  bulk_copy(st, a.r + row * DX * K, DX * bytes, bar);
  bulk_copy(st + DX * K, a.mr + row * DX * K, DX * bytes, bar);
  bulk_copy(st + 2 * DX * K, a.c + row * K, bytes, bar);
  bulk_copy(st + (2 * DX + 1) * K, a.lwn + row * K, bytes, bar);
}

// Row (t, b)'s paths into buffer bf: queries, cotangents and selections
// by 4-byte cp.async, zeros where a cotangent is absent.
template <int DX>
__device__ __forceinline__ void k6_paths(const FfbsiBwdArgs& a, float* bf, const K6Layout& L,
                                         int t, int b) {
  const int M = a.M, B = a.B, T1 = a.T1, MD = M * DX;
  const size_t row = (size_t)t * B + b;
  const float* q = t == T1 - 1 ? a.x_anchor + (size_t)b * MD : a.xtilde + (row + B) * MD;
  for (int i = threadIdx.x; i < MD; i += kThreads) {
    cp_async4(bf + L.pq + i, q + i);
    if (t + 1 < T1 && a.d_xtilde != nullptr) {
      cp_async4(bf + L.pxn + i, a.d_xtilde + (row + B) * MD + i);
    } else {
      bf[L.pxn + i] = 0.0f;
    }
    if (t == 0) {
      if (a.d_xtilde != nullptr) cp_async4(bf + L.px0 + i, a.d_xtilde + (size_t)b * MD + i);
      else bf[L.px0 + i] = 0.0f;
      if (a.d_x_first != nullptr) cp_async4(bf + L.pxf + i, a.d_x_first + (size_t)b * MD + i);
      else bf[L.pxf + i] = 0.0f;
    }
  }
  int* psel = reinterpret_cast<int*>(bf + L.psel);
  int* nsel = reinterpret_cast<int*>(bf + L.nsel);
  for (int i = threadIdx.x; i < M; i += kThreads) {
    if (a.d_logp != nullptr) cp_async4(bf + L.pgp + i, a.d_logp + (size_t)b * M + i);
    else bf[L.pgp + i] = 0.0f;
    if (a.d_logq != nullptr) cp_async4(bf + L.pgq + i, a.d_logq + (size_t)b * M + i);
    else bf[L.pgq + i] = 0.0f;
    cp_async4(psel + i, a.sel + row * M + i);
    if (t + 1 < T1) cp_async4(nsel + i, a.sel + (row + B) * M + i);
    else nsel[i] = 0;
  }
}

// The d_xs points that step t's CTA patches, zeroed: t + 1 (none at the last
// step) and, at step 0, point 0.
template <int DX>
__device__ __forceinline__ void k6_zero_points(const FfbsiBwdArgs& a, int t, int b, bool vec) {
  const size_t row = (size_t)t * a.B + b, n = (size_t)DX * a.K;
  if (t + 1 < a.T1) zero_span(a.d_xs + (row + a.B) * n, DX * a.K, vec);
  if (t == 0) zero_span(a.d_xs + (size_t)b * n, DX * a.K, vec);
}

template <int DX, int G, bool ONE>
__global__ void __launch_bounds__(kThreads, 2) ffbsi_bwd_staged_kernel(const FfbsiBwdArgs a,
                                                                        int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr int PT = kK6Per, NQ = 1 + 2 * DX, S = 2 + 2 * DX;
  constexpr float kCareful = -1e29f;  // a path max below it: its floored pairs may weigh
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M, K = a.K, B = a.B, T1 = a.T1;
  const K6Layout L = k6_layout<DX, G, ONE>(M, K);
  const int KC = L.KC, NG = (M + G - 1) / G;
  float* pst = sm + L.pst;
  float* dq = sm + L.dq;
  float* cot = sm + L.cot;
  int* csel = reinterpret_cast<int*>(sm + L.csel);
  float* red = sm + L.red;
  float* redm = sm + L.redm;
  const int jt = tid * PT;  // this thread's first particle in a chunk

  float E[G][PT];  // logits, then e = exp(logit - max)
  // per particle: sum of s = e*gq/sum over the pairs not cut, over the cut
  // ones, and of -1/2 q^2 s and q s (d_pair = oh*(gp + gq) - s)
  float A[PT], X[PT], DR[DX][PT], DMR[DX][PT];

  // the pair of path m and this thread's particle i of the staged chunk
  auto raw_of = [&](const float* bf, int m, int i) {
    const float* st = bf + L.st;
    float q[DX], qq[DX], rr[DX], mm[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      q[d] = bf[L.pq + m * DX + d];
      qq[d] = __fmul_rn(q[d], q[d]);
      rr[d] = st[d * KC + jt + i];
      mm[d] = st[(DX + d) * KC + jt + i];
    }
    return pair_vals<DX>(q, qq, rr, mm, st[2 * DX * KC + jt + i]);
  };

  // logits of paths g0 .. g0 + G - 1 on this thread's particles of the staged
  // chunk (n particles); -inf past the end
  auto logits = [&](const float* bf, int g0, int n) {
    if (jt >= n) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < PT; ++i) E[g][i] = kNegInf;
      }
      return;
    }
    const float* st = bf + L.st;
    float rv[DX][PT], mv[DX][PT], cv[PT], lv[PT];
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      const float4 r4 = *reinterpret_cast<const float4*>(st + d * KC + jt);
      const float4 m4 = *reinterpret_cast<const float4*>(st + (DX + d) * KC + jt);
      rv[d][0] = r4.x; rv[d][1] = r4.y; rv[d][2] = r4.z; rv[d][3] = r4.w;
      mv[d][0] = m4.x; mv[d][1] = m4.y; mv[d][2] = m4.z; mv[d][3] = m4.w;
    }
    const float4 c4 = *reinterpret_cast<const float4*>(st + 2 * DX * KC + jt);
    const float4 l4 = *reinterpret_cast<const float4*>(st + (2 * DX + 1) * KC + jt);
    cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
    lv[0] = l4.x; lv[1] = l4.y; lv[2] = l4.z; lv[3] = l4.w;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = g0 + g < M ? g0 + g : M - 1;
      float q[DX], qq[DX];
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        q[d] = bf[L.pq + m * DX + d];
        qq[d] = __fmul_rn(q[d], q[d]);
      }
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        float rr[DX], mm[DX];
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          rr[d] = rv[d][i];
          mm[d] = mv[d][i];
        }
        const float raw = pair_vals<DX>(q, qq, rr, mm, cv[i]);
        E[g][i] = g0 + g < M && jt + i < n ? __fadd_rn(fmaxf(raw, kMinLogp), lv[i]) : kNegInf;
      }
    }
  };

  // e = exp(logit - mx) in place
  auto exps = [&](const float (&mx)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < PT; ++i) E[g][i] = __expf(E[g][i] - mx[g]);
    }
  };

  // per path of the group: the exact max (mx; a path past M gets 0, so its
  // e are exp(-inf) = 0), e in E, and the CTA's sum e, sum e*mr_d and
  // sum e*r_d over the particles not cut by the floor, merged over the
  // eight warps in order; every thread gets mx and sum e, threads tid < G
  // path g0 + tid's max in mx_own and its sums in q_out. careful: some
  // path's max is floored, so its floored pairs weigh and are cut one by one.
  auto stats = [&](const float* bf, int g0, int n, float (&mx)[G], float (&sum)[G],
                   float (&q_out)[NQ], float& mx_own, bool& careful) {
    float v[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[g] = E[g][0];
#pragma unroll
      for (int i = 1; i < PT; ++i) v[g] = fmaxf(v[g], E[g][i]);
    }
    const float wm = warp_scatter<G, true>(v);
    if (lane % (32 / G) == 0) redm[(lane / (32 / G)) * kWarps + warp] = wm;
    __syncthreads();
    careful = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 w0 = *reinterpret_cast<const float4*>(redm + g * kWarps);
      const float4 w1 = *reinterpret_cast<const float4*>(redm + g * kWarps + 4);
      const float x = fmaxf(fmaxf(fmaxf(w0.x, w0.y), fmaxf(w0.z, w0.w)),
                            fmaxf(fmaxf(w1.x, w1.y), fmaxf(w1.z, w1.w)));
      mx[g] = g0 + g < M ? x : 0.0f;
      careful = careful || mx[g] < kCareful;
      if (tid == g) mx_own = mx[g];
    }
    exps(mx);
    const float* st = bf + L.st;
    // sum e over every pair; sum e*mr_d, sum e*r_d over the pairs not cut
    // (a floored pair's e is exactly 0 unless its path's max is floored
    // too: only then, CUT, is each pair tested)
    auto sums = [&](auto CUT) {
#pragma unroll
      for (int qn = 0; qn < NQ; ++qn) {
        const int d = qn <= DX ? qn - 1 : qn - 1 - DX;
        const float* src = st + (qn <= DX ? DX + d : d) * KC + jt;  // mr_d, then r_d
        float x[PT];
#pragma unroll
        for (int i = 0; i < PT; ++i) x[i] = qn > 0 && jt + i < n ? src[i] : 0.0f;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            if (qn == 0) {
              s += E[g][i];
            } else {
              if constexpr (decltype(CUT)::value) {
                if (jt + i < n && g0 + g < M && raw_of(bf, g0 + g, i) < kMinLogp) continue;
              }
              s = fmaf(E[g][i], x[i], s);
            }
          }
          v[g] = s;
        }
        const float ws = warp_scatter<G, false>(v);
        if (lane % (32 / G) == 0) red[(qn * G + lane / (32 / G)) * kWarps + warp] = ws;
      }
    };
    if (careful) {
      sums(std::true_type{});
    } else {
      sums(std::false_type{});
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 w0 = *reinterpret_cast<const float4*>(red + g * kWarps);
      const float4 w1 = *reinterpret_cast<const float4*>(red + g * kWarps + 4);
      sum[g] = ((((((w0.x + w0.y) + w0.z) + w0.w) + w1.x) + w1.y) + w1.z) + w1.w;
    }
    if (tid < G) {
#pragma unroll
      for (int qn = 0; qn < NQ; ++qn) {
        const float* w = red + (qn * G + tid) * kWarps;
        float s = w[0];
        for (int u = 1; u < kWarps; ++u) s += w[u];
        q_out[qn] = s;
      }
    }
  };

  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      A[i] = X[i] = 0.0f;
#pragma unroll
      for (int d = 0; d < DX; ++d) DR[d][i] = DMR[d][i] = 0.0f;
    }
  };

  // the soft part of d_pair, s = e*gq/sum, added per particle over paths
  // g0 .. in path order; where careful, a floored pair's s goes to X alone
  // (the floor's cut)
  auto accumulate = [&](const float* bf, int g0, int n, const float (&inv)[G], bool careful) {
    auto body = [&](auto CUT) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int m = g0 + g;
        if (m >= M) break;
        const float w = bf[L.pgq + m] * inv[g];
        float q[DX], nh[DX];
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          q[d] = bf[L.pq + m * DX + d];
          nh[d] = -0.5f * __fmul_rn(q[d], q[d]);
        }
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          const float s = E[g][i] * w;
          if constexpr (decltype(CUT)::value) {
            if (jt + i < n && raw_of(bf, m, i) < kMinLogp) {
              X[i] += s;
              continue;
            }
          }
          A[i] += s;
#pragma unroll
          for (int d = 0; d < DX; ++d) {
            DR[d][i] = fmaf(nh[d], s, DR[d][i]);
            DMR[d][i] = fmaf(q[d], s, DMR[d][i]);
          }
        }
      }
    };
    if (careful) {
      body(std::true_type{});
    } else {
      body(std::false_type{});
    }
  };

  // the picks' part of d_pair (oh*(gp + gq), none where the pick's pair is
  // floored) added to this thread's particles of the chunk at j0, paths in
  // order; then the cotangents, 16-byte stores where vec
  auto finish = [&](const float* bf, size_t row, int j0, int n) {
    if (jt >= n) return;
    float dc[PT], dlwn[PT], dlg[PT], dr[DX][PT], dmr[DX][PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) dc[i] = dlwn[i] = dlg[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < DX; ++d) {
#pragma unroll
      for (int i = 0; i < PT; ++i) dr[d][i] = dmr[d][i] = 0.0f;
    }
    const int* psel = reinterpret_cast<const int*>(bf + L.psel);
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      const int u = psel[m] - j0 - jt;
      if (u < 0 || u >= PT) continue;
      const float gp = bf[L.pgp + m], gq = bf[L.pgq + m], gsum = gp + gq;
      const bool cut = csel[m] != 0;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        if (i != u) continue;
        dlwn[i] += gq;
        dlg[i] += gp;
        if (cut) continue;
        dc[i] += gsum;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          const float q = bf[L.pq + m * DX + d];
          dr[d][i] += -0.5f * __fmul_rn(q, q) * gsum;
          dmr[d][i] += q * gsum;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      dlwn[i] -= A[i] + X[i];
      dc[i] -= A[i];
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        dr[d][i] -= DR[d][i];
        dmr[d][i] -= DMR[d][i];
      }
    }
    const int j = j0 + jt;
    auto put = [&](float* base, const float (&x)[PT]) {
      if (vec && jt + PT <= n) {
        *reinterpret_cast<float4*>(base + j) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          if (jt + i < n) base[j + i] = x[i];
        }
      }
    };
    if (a.d_c != nullptr) put(a.d_c + row * K, dc);
    if (a.d_lwn != nullptr) put(a.d_lwn + row * K, dlwn);
    if (a.d_lg != nullptr) put(a.d_lg + row * K, dlg);
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      if (a.d_r != nullptr) put(a.d_r + (row * DX + d) * K, dr[d]);
      if (a.d_mr != nullptr) put(a.d_mr + (row * DX + d) * K, dmr[d]);
    }
  };

  // d_q of every (path, dimension) from the sums in pst, and whether each
  // pick's pair is floored; r, mr, c at the pick from the stage (whole row)
  // or device memory
  auto dq_pass = [&](const float* bf, size_t row) {
    const int* psel = reinterpret_cast<const int*>(bf + L.psel);
    for (int i = tid; i < M * DX; i += kThreads) {
      const int m = i / DX, d = i % DX, js = psel[m];
      const float* p = pst + m * S;
      float q[DX], qq[DX], rs[DX], ms[DX];
#pragma unroll
      for (int e = 0; e < DX; ++e) {
        q[e] = bf[L.pq + m * DX + e];
        qq[e] = __fmul_rn(q[e], q[e]);
        rs[e] = ONE ? bf[L.st + e * KC + js] : a.r[(row * DX + e) * K + js];
        ms[e] = ONE ? bf[L.st + (DX + e) * KC + js] : a.mr[(row * DX + e) * K + js];
      }
      const float c_s = ONE ? bf[L.st + 2 * DX * KC + js] : a.c[row * K + js];
      const bool cut_s = pair_vals<DX>(q, qq, rs, ms, c_s) < kMinLogp;
      if (d == 0) csel[m] = cut_s;
      const float gq = bf[L.pgq + m], gsum = bf[L.pgp + m] + gq, w = gq * (1.0f / p[1]);
      const float sa = (cut_s ? 0.0f : gsum * ms[d]) - w * p[2 + d];
      const float sb = (cut_s ? 0.0f : gsum * rs[d]) - w * p[2 + DX + d];
      dq[i] = sa - q[d] * sb;
    }
  };

  // d_q to the query: the anchor at the last step, else point t + 1's
  // patch; step 0 also patches point 0 (d_xtilde[0] + d_x_first)
  auto patch_row = [&](const float* bf, int t, int b) {
    const size_t row = (size_t)t * B + b;
    if (t == T1 - 1) {
      for (int i = tid; i < M * DX; i += kThreads) a.d_x_anchor[(size_t)b * M * DX + i] = dq[i];
    } else {
      for (int i = tid; i < M * DX; i += kThreads) cot[i] = dq[i] + bf[L.pxn + i];
      __syncthreads();
      patch_point<DX>(a.d_xs + (row + B) * DX * K, K, M,
                      [&](int e, int d) { return cot[e * DX + d]; },
                      reinterpret_cast<const int*>(bf + L.nsel), tid, kThreads);
    }
    if (t == 0) {
      __syncthreads();
      for (int i = tid; i < M * DX; i += kThreads) cot[i] = bf[L.px0 + i] + bf[L.pxf + i];
      __syncthreads();
      patch_point<DX>(a.d_xs + (size_t)b * DX * K, K, M,
                      [&](int e, int d) { return cot[e * DX + d]; },
                      reinterpret_cast<const int*>(bf + L.psel), tid, kThreads);
    }
  };

  float mx[G], sum[G], inv[G], q_out[NQ], mx_own = 0.0f;
  bool careful;
  if constexpr (ONE) {
    // a persistent CTA walks rows (t, b); the next row's copies are in
    // flight while it works on this one
    // (with vec the stage comes by bulk copies on one mbarrier a buffer)
    __shared__ __align__(8) uint64_t s_bar[2];
    if (vec && tid == 0) {
      mbar_init(&s_bar[0], 1);
      mbar_init(&s_bar[1], 1);
      mbar_init_fence();
    }
    __syncthreads();
    const int rows = T1 * B;
    int row = blockIdx.x;
    auto stage_row = [&](float* buffer, int r, uint64_t* bar) {
      if (vec) {
        k6_stage_bulk<DX>(a, buffer + L.st, r, bar);
      } else {
        k6_stage<DX>(a, buffer + L.st, KC, r, 0, K, false);
      }
    };
    if (row < rows) {
      stage_row(sm, row, &s_bar[0]);
      k6_paths<DX>(a, sm, L, row / B, row % B);
      cp_async_commit();
      k6_zero_points<DX>(a, row / B, row % B, vec);
    }
    for (int it = 0; row < rows; row += gridDim.x, ++it) {
      float* bf = sm + (it & 1) * L.buf;
      const int t = row / B, b = row % B;
      cp_async_wait<0>();
      if (vec) mbar_wait(&s_bar[it & 1], (it >> 1) & 1);  // the buffer's (it / 2)-th fill
      __syncthreads();  // this row's buffer is in; every thread is done with the other one
      const int nx = row + gridDim.x;
      if (nx < rows) {
        float* nb = sm + ((it + 1) & 1) * L.buf;
        stage_row(nb, nx, &s_bar[(it + 1) & 1]);
        k6_paths<DX>(a, nb, L, nx / B, nx % B);
        cp_async_commit();
        k6_zero_points<DX>(a, nx / B, nx % B, vec);
      }
      clear();
      for (int g0 = 0; g0 < M; g0 += G) {
        logits(bf, g0, K);
        stats(bf, g0, K, mx, sum, q_out, mx_own, careful);
        if (tid < G && g0 + tid < M) {
          float* p = pst + (g0 + tid) * S;
          p[0] = mx_own;
#pragma unroll
          for (int qn = 0; qn < NQ; ++qn) p[1 + qn] = q_out[qn];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) inv[g] = 1.0f / sum[g];
        accumulate(bf, g0, K, inv, careful);
      }
      __syncthreads();  // every path's sums in pst
      dq_pass(bf, row);
      __syncthreads();  // d_q and the picks' floors
      finish(bf, row, 0, K);
      patch_row(bf, t, b);
    }
  } else {
    // a row past kK6Chunk particles: one CTA per (t, b), chunks staged twice
    const int t = blockIdx.x, b = blockIdx.y, NCH = (K + kK6Chunk - 1) / kK6Chunk;
    const size_t row = (size_t)t * B + b;
    float* bf = sm;
    for (int i = tid; i < M; i += kThreads) {
      pst[i * S] = kNegInf;
#pragma unroll
      for (int u = 1; u < S; ++u) pst[i * S + u] = 0.0f;
    }
    k6_stage<DX>(a, bf + L.st, KC, row, 0, kK6Chunk, vec);
    k6_paths<DX>(a, bf, L, t, b);
    cp_async_commit();
    k6_zero_points<DX>(a, t, b, vec);
    cp_async_wait<0>();
    __syncthreads();
    // pass 1: the per-path max and sums over every chunk, merged in chunk order
    for (int ch = 0; ch < NCH; ++ch) {
      const int j0 = ch * kK6Chunk, n = K - j0 < kK6Chunk ? K - j0 : kK6Chunk;
      if (ch > 0) {
        __syncthreads();  // every thread is done with the previous chunk
        k6_stage<DX>(a, bf + L.st, KC, row, j0, n, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      for (int g0 = 0; g0 < M; g0 += G) {
        logits(bf, g0, n);
        stats(bf, g0, n, mx, sum, q_out, mx_own, careful);
        if (tid < G && g0 + tid < M) {  // the path's owner merges the chunk into its running sums
          float* p = pst + (g0 + tid) * S;
          const float cm = mx_own, nm = fmaxf(p[0], cm);
          const float fa = expf(p[0] - nm), fb = expf(cm - nm);
          p[0] = nm;
#pragma unroll
          for (int qn = 0; qn < NQ; ++qn) p[1 + qn] = p[1 + qn] * fa + q_out[qn] * fb;
        }
      }
    }
    __syncthreads();  // the running sums are final
    dq_pass(bf, row);
    // pass 2: the logits again, d_pair from the final max and sum, chunk by chunk
    for (int ch = 0; ch < NCH; ++ch) {
      const int j0 = ch * kK6Chunk, n = K - j0 < kK6Chunk ? K - j0 : kK6Chunk;
      __syncthreads();  // d_q and the picks' floors; every thread is done with the stage
      k6_stage<DX>(a, bf + L.st, KC, row, j0, n, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      clear();
      for (int g0 = 0; g0 < M; g0 += G) {
        logits(bf, g0, n);
        careful = false;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int m = g0 + g < M ? g0 + g : M - 1;
          mx[g] = g0 + g < M ? pst[m * S] : 0.0f;
          inv[g] = 1.0f / pst[m * S + 1];
          careful = careful || mx[g] < kCareful;
        }
        exps(mx);
        accumulate(bf, g0, n, inv, careful);
      }
      finish(bf, row, j0, n);
    }
    __syncthreads();
    patch_row(bf, t, b);
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

// K6 staged: the paths-only kernel on a persistent grid, or the
// all-cotangents kernel, one CTA per (t, b), whole row (K <= kK6Chunk) or
// chunked. 16-byte copies and stores where K is a multiple of 4 and every
// row operand and output is 16-byte aligned.
template <int DX>
cudaError_t launch_ffbsi_bwd_staged(const FfbsiBwdArgs& a, cudaStream_t stream) {
  if (a.M < 1 || a.M > kK6MaxM) return cudaErrorInvalidValue;
  const void* spans[] = {a.r, a.mr, a.c, a.lwn, a.d_xs, a.d_r, a.d_mr, a.d_c, a.d_lwn, a.d_lg};
  int vec = a.K % 4 == 0;
  for (const void* p : spans) vec = vec && k6_aligned(p);
  cudaError_t err;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  if (a.d_logp == nullptr && a.d_logq == nullptr) {  // paths only: batches of kK6PathRows rows
    constexpr int R = kK6PathRows;
    const size_t smem = sizeof(float) * k6_paths_floats(a.M, DX, R);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ffbsi_bwd_paths_kernel<DX>,
                                                             kThreads, smem)) != cudaSuccess) {
      return err;
    }
    const int batches = (a.T1 * a.B + R - 1) / R;
    const int ctas = batches < sms * per_sm ? batches : sms * per_sm;
    ffbsi_bwd_paths_kernel<DX><<<ctas, kThreads, smem, stream>>>(a, vec, R);
    return cudaGetLastError();
  }
  constexpr int G = kK6Group;
  const bool one = a.K <= kK6Chunk;
  const size_t smem = sizeof(float) * (one ? k6_layout<DX, G, true>(a.M, a.K).total
                                           : k6_layout<DX, G, false>(a.M, a.K).total);
  auto kernel = one ? ffbsi_bwd_staged_kernel<DX, G, true> : ffbsi_bwd_staged_kernel<DX, G, false>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess) {
    return err;
  }
  if (!one) {
    kernel<<<dim3(a.T1, a.B), kThreads, smem, stream>>>(a, vec);
    return cudaGetLastError();
  }
  // whole rows: as many persistent CTAs as the card holds at once
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess) {
    return err;
  }
  const int rows = a.T1 * a.B, ctas = rows < sms * per_sm ? rows : sms * per_sm;
  kernel<<<ctas, kThreads, smem, stream>>>(a, vec);
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
                                   int design, void* stream) {
  const psvo::FfbsiBwdArgs a{x_anchor, xtilde, sel,   r,     mr,   c,   lwn,  d_x_first,
                             d_logp,   d_logq, d_xtilde, d_x_anchor, d_xs, d_r, d_mr, d_c,
                             d_lwn,    d_lg,   B,     M,     K,    T1};
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {  // staged
    switch (dx) {
      case 2: return psvo::launch_ffbsi_bwd_staged<2>(a, s);
      case 3: return psvo::launch_ffbsi_bwd_staged<3>(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (design != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dx) {  // row: one CTA per (t, b), three passes of the pair
    case 2: return psvo::launch_ffbsi_backward<2>(a, s);
    case 3: return psvo::launch_ffbsi_backward<3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
