// K4 scan_backward: the backward of the whole forward FIVO filter (K1),
// t = T-1 .. 1 in one launch, plus sum_rows_kernel, which sums the per-row
// parameter gradients; and K15 step_backward (at the end): the backward of
// one K14 step per launch, through the same step code. The templates:
// scan_backward.cu instantiates K4 and holds its C entry point,
// step_backward.cu K15's, so that nvcc builds the two in parallel.
//
// Replaces psvo_tpu/ops/pallas_step.py::_scan_bwd (kernel body
// _scan_bwd_kernel), which inlines _bwd_core, _propose_weight_bwd_core,
// _trunk / _trunk_bwd, _factored_scatter, _write_dsm, _accum_param_grads and
// the in-kernel regeneration of ε (_rng_seed / _rng_eps).
//
// Contract (fused_step.scan_backward_reference computes the same function
// with PyTorch autograd). From K1's residuals, x_new of every step (x_all)
// and the ancestor indices (idx), and the cotangents of ℓ (stats column 0),
// x_last, alpha_last and, under cache, x_all / alpha_all, it returns d_x0,
// d_coef in pack_coef's layout (per (t, b): Σ_k d x_new for aq,
// Σ_k d x_new·m1 for cq, Σ_k d x_new·ε for sq, zero for y, Σ_k dα for ab),
// the weight gradients in prepare()'s packed layout and d_sconst. The
// cotangents of ESS and of the filtered mean are dropped, as
// _propose_weight_bwd_core reads only the ℓ lane; α0, ε, the positions and
// the seed get none; the α cotangent is cut where the unfloored α < −3e30.
//
// Design. Each trajectory row b runs on a thread-block cluster of C CTAs
// (grid = B·C, cluster.cuh; the host picks C, fused_step.cluster_size),
// which walks t in reverse. CTA rank r owns particles [r·K/C, (r+1)·K/C)
// and carries their cotangent of x_new, [DX][K/C], in shared memory (the
// TPU kernel's dxc scratch). Per step, over tiles of P particles of the own
// slice (P = kP = 64 but at the widest nets, below; K/C is a multiple of 64,
// so the tiles are those of C = 1):
//   1. regather x_res = x_{t-1}[idx_t] (x_{-1} = x0), read x_new, and read ε
//      or regenerate it from K1's Philox counters (b, t, i);
//   2. recompute the f trunk on x_res and the g trunk on x_new in K1's fmaf
//      order (bias first, inputs ascending), so m_f, m_g and α
//      (step_math.cuh) are K1's own bits and the floor cut matches;
//   3. dα = d_alpha_in + d_ℓ·softmax(α), the softmax as exp(α − ℓ − log K)
//      from the ℓ that K1 wrote, so no extra pass over K is needed;
//   4. backprop g and f, then recompute q1 on x_res (its m1 feeds the cq
//      sum) and backprop it, accumulating the weight and sconst gradients,
//      and write d x_res of the slice into dxres[t & 1];
// then the slice's d_coef sums (block reductions), one cluster barrier, and
// the scatter: for each own ancestor j, d x_{t-1}[j] = Σ_{i: idx_i = j}
// d x_res_i, over the run [lo, hi) of idx (full row in every CTA) in
// particle order, reading the slices of ranks i / (K/C) through DSMEM, into
// the CTA's own carry (step t−1 reads d x_new only of its own particles, so
// the carry never crosses CTAs); rank 0 adds the C d_coef partials in rank
// order. dxres and the partials are double-buffered by t's parity: a CTA
// rewrites them at t−2, after step t−1's barrier, which every reader of
// step t's reaches only after its scatter.
//
// What bounds it. About 78 kFLOP per particle-step at hidden (64, 64): the
// three trunk recomputes, their input-side backward and the weight-gradient
// products, ~26 kFLOP each. That is 2.5e11 FLOP at B=32, K=1024, T=100,
// against ~40 MB of residual reads, so the fp32 CUDA cores bound it. Each
// trunk stage is a small GEMM over the tile. Its operands sit in shared
// memory in [unit][particle] layout, with rows padded to P + 4 floats so
// that float4 rows land on distinct banks. Each thread owns a 4x4 output
// block and issues two 16-byte loads per 16 FMAs. Shared memory at H=64
// holds the weights (53.8 KB at Dx=Dy=2, 55.3 KB at 3), their gradient
// accumulators (as much again), four [64][68] activation buffers (69.6 KB),
// the tile arrays (7 or 9 KB), idx [K] (4.1 KB at K=1024), the carry and
// d x_res [DX][K/C] (at C > 1 d x_res twice): 199 KB at Dx=2 and 213 KB at
// Dx=3 at C = 1, 189 and 198 KB at C = 4 (K=1024), of the 227 KB a CTA may
// use (fused_step.k4_smem_bytes; at Dx=3 K up to 1536 fits at C = 1, 3072
// at C = 4). One CTA per SM: one CTA per row used B = 32 of the 132 SMs.
// The H100 holds 66 clusters of 2 at once but only 30 of 4 (a cluster's
// CTAs share one GPC), so at B = 32 the host picks C = 2: 64 SMs, at one
// cluster barrier per step. Tensor cores (TF32/bf16 change the numerics)
// are later work.
//
// The class (fused_step.usable): any Dx, Dy <= 7, any hidden width that is
// a multiple of 8, any depth (NMID, a template parameter: each net's NMID + 1
// layers recompute into and backpropagate through NMID + 1 tiles), as far as
// the plans hold it. Where the weights, their gradient sums and 2·(NMID + 1)
// tiles exceed the 227 KB a CTA may use (three layers of 48-64, wide states
// at K = 2048, every width above 64), a plan (step_math.cuh::BwdPlan, chosen
// by fused_step.k4_plan for the shape and K) moves them out one at a time:
// the gradient sums to the CTA's row of `partial` in device memory, whose
// owning thread adds into it as into shared memory (kBwdGlobal); then one
// net's tiles at a time, g recomputed for its backward after f's (kBwdSplit,
// one more forward of g a tile); then the weights, read through L1
// (kBwdStream). The adds, their order and their owners do not change, so
// every plan gives the same bits. Under kBwdStream, where two layers of a
// wide net (above width 64) do not fit beside the rest at some K, the tiles
// take fewer particles (P = 32 or 16, fused_step.k4_tile: at K = 1920 a row
// takes one or two CTAs): each gradient entry still has one owner adding
// its tiles' sums in particle order, in more, smaller tiles, so a shape and
// K has one set of bits for every plan, C and S.
//
// Controls (ctrl = 1, data.di > 0; scan_forward.cuh says how K1 takes them):
// each step copies b1 + c of q1 and f into shared memory (cb) for the
// recompute of their first layers, so the recompute has K1's bits, and the
// thread that owns b1[o] in the weight-gradient sums also adds the tile's
// Σ_p of that unit's pre-activation cotangent to the step's sum csum[o], in
// fp64. The row's d_coef gets those 2H sums after ab (rank 0 adds the C
// slices' sums in rank order, in fp64, K15's last CTA the S slices' in slice
// order): the VJP of c, from which autograd through fused_step.control_term
// gives W_u's gradient. The tiles are those of C = 1 at every C, so the fp64
// sums of their float32 tile sums round to the same float32 at every C but
// for a tie within the last bit.
//
// Determinism. Every gradient entry has one owning thread, which adds its
// tile sums in a fixed order; the per-step sums go through fixed block
// reductions and rank 0 adds the C slice sums in rank order; the scatter is
// a segmented sum over each run of equal ancestors, in particle order, which
// needs idx nondecreasing along K (K1's indices from sorted positions are;
// chip_smoke.py asserts it on the residuals); sum_rows_kernel adds the B·C
// CTA partials in order, in fp64. There are no atomics: every run gives the
// same bits. d x_res of a particle does not depend on C, nor does the
// scatter's order, so d_x0 is bit-equal for every C; d_coef and the weight
// and sconst gradients are summed per slice first, within float32 rounding
// of C = 1 (the sconst sums, which cancel, in fp64).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "philox.cuh"
#include "resample.cuh"
#include "step_math.cuh"
#include "step_slices.cuh"
#include "step_tiles.cuh"

namespace psvo {

struct BwdArgs {
  const float* x0;           // [B, DX, K]
  const float* x_all;        // [T1, B, DX, K]: x_new of every step (K1 residual)
  const int* idx;            // [T1, B, K]: ancestors (K1 residual), nondecreasing in K
  const float* stats;        // [T1, B, 2 + DX]: ℓ in column 0
  const float* coef;         // [T1, B, 3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f)
  const float* eps;          // [T1, B, DX, K]; stream mode only
  const float* weights;      // q1 | f | g, fused_step.prepare's layout
  const float* sconst;       // [DX + DY]: 1/s_f, 1/s_g
  const float* d_stats;      // [T1, B, 2 + DX]: column 0 is read
  const float* d_x_last;     // [B, DX, K] or null
  const float* d_alpha_last; // [B, K] or null
  const float* d_x_all;      // [T1, B, DX, K] or null
  const float* d_alpha_all;  // [T1, B, K] or null
  float* d_x0;               // [B, DX, K]
  float* d_coef;             // [T1, B, 3*DX + DY + 1 (+ 2H)]
  float* partial;            // [B*C, n_weights + DX + DY]: per-CTA weight and sconst grads
  uint32_t seed0, seed1;
  int use_rng, B, K, T1, n_weights, off_f, off_g;
  int ctrl;                  // 1: coef rows end in the controls' q1 and f first-layer terms [2H]
  int cluster;               // C: CTAs per row, K/C a multiple of kP = 64 when C > 1
};

// Backward stage 1: dW3[o][d] += Σ_p h2[o][p]·dm[d][p], db3[d] += Σ_p dm[d][p].
// g3 points at the net's dW3 (db3 follows); one owning thread per entry.
template <int H, int DOUT, int P>
__device__ __forceinline__ void bwd_head_grads(const float* __restrict__ h2,
                                               const float* __restrict__ dm, float* g3) {
  constexpr int PS = P + 4;
  for (int e = threadIdx.x; e < H * DOUT + DOUT; e += kThreads) {
    const bool is_w = e < H * DOUT;
    const float* dr = dm + (is_w ? e % DOUT : e - H * DOUT) * PS;
    const float* hr = h2 + (is_w ? e / DOUT : 0) * PS;
    float s = 0.0f;
    for (int p = 0; p < P; p += 4) {
      float dv[4], hv[4];
      ld4(dr + p, dv);
      ld4(hr + p, hv);
#pragma unroll
      for (int c = 0; c < 4; ++c) s = is_w ? fmaf(hv[c], dv[c], s) : s + dv[c];
    }
    g3[e] += s;  // b3 follows W3 in the segment
  }
}

// Backward stage 2, in place: h2[o][p] <- (Σ_d W3[o][d]·dm[d][p]) · [h2[o][p] > 0].
template <int H, int DOUT, int P>
__device__ __forceinline__ void bwd_pre2(const float* __restrict__ w3,
                                         const float* __restrict__ dm, float* h2) {
  constexpr int PS = P + 4, PB = P / 4;
  for (int e = threadIdx.x; e < H * PB; e += kThreads) {
    const int o = e / PB, p0 = (e % PB) * 4;
    float hv[4], dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    ld4(h2 + o * PS + p0, hv);
#pragma unroll
    for (int d = 0; d < DOUT; ++d) {
      float dv[4];
      ld4(dm + d * PS + p0, dv);
      const float wv = w3[o * DOUT + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) dh[c] = fmaf(dv[c], wv, dh[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) hv[c] = hv[c] > 0.0f ? dh[c] : 0.0f;
    st4(h2 + o * PS + p0, hv);
  }
}

// Backward stage 3, for a middle layer (W2, b2) between h1 and h2:
// dW2[i][o] += Σ_p h1[i][p]·dpre2[o][p] into gw, db2[o] += Σ_p dpre2[o][p]
// into gb. A thread owns rows i0 + S·a and columns o0 + S·c (S = H/4):
// neighbouring lanes read neighbouring rows, which the padded stride puts
// on other banks.
template <int H, int P>
__device__ __forceinline__ void bwd_mid_grads(const float* __restrict__ h1,
                                              const float* __restrict__ dpre2, float* gw,
                                              float* gb) {
  constexpr int PS = P + 4;
  constexpr int S = H / 4;
  for (int blk = threadIdx.x; blk < S * S; blk += kThreads) {
    const int i0 = blk / S, o0 = blk % S;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    }
    for (int p = 0; p < P; p += 4) {
      float hv[4][4], dv[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ld4(h1 + (i0 + S * a) * PS + p, hv[a]);
#pragma unroll
      for (int c = 0; c < 4; ++c) ld4(dpre2 + (o0 + S * c) * PS + p, dv[c]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(hv[a][q], dv[c][q], acc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) gw[(i0 + S * a) * H + o0 + S * c] += acc[a][c];
    }
  }
  for (int o = threadIdx.x; o < H; o += kThreads) {
    float s = 0.0f;
    for (int p = 0; p < P; p += 4) {
      float dv[4];
      ld4(dpre2 + o * PS + p, dv);
#pragma unroll
      for (int c = 0; c < 4; ++c) s += dv[c];
    }
    gb[o] += s;
  }
}

// Backward stage 4, in place: h1[i][p] <- (Σ_o W2[i][o]·dpre2[o][p]) · [h1[i][p] > 0].
template <int H, int P>
__device__ __forceinline__ void bwd_pre1(const float* __restrict__ w2,
                                         const float* __restrict__ dpre2, float* h1) {
  constexpr int PS = P + 4, PB = P / 4;
  for (int blk = threadIdx.x; blk < (H / 4) * PB; blk += kThreads) {
    const int i0 = (blk / PB) * 4, p0 = (blk % PB) * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    }
    for (int o = 0; o < H; o += 4) {
      float wv[4][4], dv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ld4(w2 + (i0 + r) * H + o, wv[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) ld4(dpre2 + (o + q) * PS + p0, dv[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(wv[r][q], dv[q][c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hv[4];
      ld4(h1 + (i0 + r) * PS + p0, hv);
#pragma unroll
      for (int c = 0; c < 4; ++c) hv[c] = hv[c] > 0.0f ? acc[r][c] : 0.0f;
      st4(h1 + (i0 + r) * PS + p0, hv);
    }
  }
}

// Backward stage 5: dW1[d][i] += Σ_p x[d][p]·dpre1[i][p], db1[i] += Σ_p dpre1[i][p],
// and the input cotangent dx[d][p] (= or +=) Σ_i W1[d][i]·dpre1[i][p]. With
// csum (controls), the owner of db1[i] also adds the tile's sum to csum[i].
template <int DIN, int H, bool kAdd, int P>
__device__ __forceinline__ void bwd_input(const float* __restrict__ w1,
                                          const float* __restrict__ x,
                                          const float* __restrict__ dpre1, float* g,
                                          float* __restrict__ dx, double* csum = nullptr) {
  constexpr int PS = P + 4;
  constexpr int NG = DIN * H + H;  // W1 then b1 in the segment
  for (int e = threadIdx.x; e < NG + DIN * P; e += kThreads) {
    if (e < NG) {
      const bool is_w = e < DIN * H;
      const float* dr = dpre1 + (is_w ? e % H : e - DIN * H) * PS;
      const float* xr = x + (is_w ? e / H : 0) * PS;
      float s = 0.0f;
      for (int p = 0; p < P; p += 4) {
        float dv[4], xv[4];
        ld4(dr + p, dv);
        ld4(xr + p, xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) s = is_w ? fmaf(xv[c], dv[c], s) : s + dv[c];
      }
      g[e] += s;
      if (!is_w && csum != nullptr) csum[e - DIN * H] += static_cast<double>(s);
    } else {
      const int f = e - NG, d = f / P, p = f % P;
      float s = 0.0f;
#pragma unroll 8
      for (int i = 0; i < H; ++i) s = fmaf(dpre1[i * PS + p], w1[d * H + i], s);
      dx[d * PS + p] = kAdd ? dx[d * PS + p] + s : s;
    }
  }
}

// First position in the nondecreasing a[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound_idx(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The particles [lo, lo + n) that a K4 CTA owns: rank `rank` of its row's
// cluster of C CTAs (C = 1: the whole row).
struct Slice {
  int lo, n, rank, C;
};

// The d_coef entries a slice sums: aq, cq, sq per state dimension, then ab.
template <int DX>
constexpr int kCoefSums = 3 * DX + 1;

// Where plan BWD (step_math.cuh) keeps a CTA's weights, gradient sums and
// activation tiles: kTiles [H][P + 4] tiles, f's NMID + 1 layers then g's
// (then q1's), or under a split plan one net's layers at a time.
template <int H, int NMID, int BWD, int P = kP>
struct BwdLayout {
  static constexpr bool kSplit = BWD == kBwdSplit || BWD == kBwdStream;
  static constexpr bool kWtsSmem = BWD != kBwdStream;  // else the weights stay in device memory
  static constexpr bool kGradSmem = BWD == kBwdSmem;   // else the CTA's row of `partial`
  static constexpr int kTiles = (kSplit ? 1 : 2) * (NMID + 1);
  static constexpr int kTileFloats = kTiles * H * (P + 4);
};

// A CTA's shared memory in K4 and K15: the weights and their gradient sums
// (as the plan keeps them), the activation tiles, the [D][P + 4] tile arrays,
// K4's carry of the slice, d x_res of the slice (twice at C > 1, by t's
// parity), with controls the step's first-layer biases of q1 and f and their
// cotangent sums (twice, by t's parity), the slice's d_coef sums (C > 1, by
// t's parity), the reduction scratch and the int32 ancestors of the whole
// row [K]. K15 keeps neither d x_res nor the ancestors here (n = K = 0): its
// shared memory does not depend on K, but where the row's K ancestors do not
// fit its idle tiles, where its last CTA stages them (K > kTileFloats), it
// carves them as K4 does.
struct BwdSmem {
  float *wts, *gacc;               // [n_weights] each: shared or device memory
  float* act;                      // [kTiles][H][P + 4]: f's layers, then g's (then q1's)
  float *xr, *xn, *ep;             // [DX][P + 4]: x_res, x_new, ε
  float *mf, *mg, *mq;             // trunk means
  float *dmf, *dmg, *dmq;          // cotangents of the trunk means
  float *dxn, *dxr;                // d x_new, d x_res of the tile
  float* carry;                    // [DX][n] (K4 only)
  float* dxres;                    // [C > 1 ? 2 : 1][DX][n]: d x_res of the slice
  float* cb;                       // [2H]: b1 + c of q1, then of f (ctrl only)
  double* csum;                    // [2][2H]: Σ of their pre-activation cotangents (ctrl only)
  float* part;                     // [2][kCoefSums] (C > 1 only)
  float* red;                      // [kWarps]
  int* idx_s;                      // [K]
};

// weights: the packed weights in device memory, partial: the CTA's row of
// the partial gradients; the plan reads them where they stay.
template <int DX, int DY, int H, int NMID, int BWD, int P>
__device__ __forceinline__ BwdSmem carve_bwd(unsigned char* smem, const float* weights,
                                             float* partial, int n_weights, int K, int n,
                                             bool carry, int C, bool ctrl) {
  using L = BwdLayout<H, NMID, BWD, P>;
  constexpr int PS = P + 4;
  BwdSmem s;
  float* p = reinterpret_cast<float*>(smem);
  s.wts = L::kWtsSmem ? p : const_cast<float*>(weights);
  p += L::kWtsSmem ? n_weights : 0;
  s.gacc = L::kGradSmem ? p : partial;
  p += L::kGradSmem ? n_weights : 0;
  s.act = p;
  s.xr = s.act + L::kTileFloats;
  s.xn = s.xr + DX * PS;
  s.ep = s.xn + DX * PS;
  s.mf = s.ep + DX * PS;
  s.mg = s.mf + DX * PS;
  s.mq = s.mg + DY * PS;
  s.dmf = s.mq + DX * PS;
  s.dmg = s.dmf + DX * PS;
  s.dmq = s.dmg + DY * PS;
  s.dxn = s.dmq + DX * PS;
  s.dxr = s.dxn + DX * PS;
  s.carry = s.dxr + DX * PS;
  s.dxres = s.carry + (carry ? DX * n : 0);
  s.cb = s.dxres + (C > 1 ? 2 : 1) * DX * n;  // 16-byte aligned, as every extent before it
  s.csum = reinterpret_cast<double*>(s.cb + (ctrl ? 2 * H : 0));  // 8-byte aligned: H % 4 == 0
  s.part = reinterpret_cast<float*>(s.csum + (ctrl ? 4 * H : 0));
  s.red = s.part + (C > 1 ? 2 * kCoefSums<DX> : 0);
  s.idx_s = reinterpret_cast<int*>(s.red + kWarps);
  return s;
}

template <int DX, int DY, int H, int NMID, int BWD, int P>
size_t bwd_smem_bytes(int n_weights, int K, int n, bool carry, int C, bool ctrl) {
  using L = BwdLayout<H, NMID, BWD, P>;
  return sizeof(float) * ((L::kWtsSmem ? n_weights : 0) + (L::kGradSmem ? n_weights : 0) +
                          L::kTileFloats + (9 * DX + 2 * DY) * (P + 4) + (carry ? DX * n : 0) +
                          (C > 1 ? 2 : 1) * DX * n + (ctrl ? 2 * H : 0) +
                          (C > 1 ? 2 * kCoefSums<DX> : 0) + kWarps) +
         sizeof(double) * (ctrl ? 4 * H : 0) + sizeof(int) * K;
}

// The forward recompute of net a (with TWO also net b, stage by stage beside
// it) over the tile: its NMID + 1 hidden layers into its tiles t[j] = t +
// j·H·(P + 4) from input x [DIN][P + 4] (first-layer bias b1), then its mean head
// into m; K1's fmaf order. Ends on a barrier.
template <int DIN, int H, int NMID, int DA, int DB, bool TWO, int P>
__device__ __forceinline__ void forward_tiles(const float* wa, const float* ba, const float* xa,
                                              float* ta, float* ma, const float* wb,
                                              const float* bb, const float* xb, float* tb,
                                              float* mb) {
  using NA = Net<DIN, H, DA, NMID>;
  using NB = Net<DIN, H, DB, NMID>;
  constexpr int T = H * (P + 4);
  dense_relu_tile<DIN, H, P>(wa + NA::W1, ba, xa, ta);
  if constexpr (TWO) dense_relu_tile<DIN, H, P>(wb + NB::W1, bb, xb, tb);
  __syncthreads();
#pragma unroll
  for (int j = 1; j <= NMID; ++j) {
    dense_relu_tile<H, H, P>(wa + NA::W(j), wa + NA::B(j), ta + (j - 1) * T, ta + j * T);
    if constexpr (TWO)
      dense_relu_tile<H, H, P>(wb + NB::W(j), wb + NB::B(j), tb + (j - 1) * T, tb + j * T);
    __syncthreads();
  }
  dense_out_tile<H, DA, P>(wa + NA::W3, wa + NA::B3, ta + NMID * T, ma);
  if constexpr (TWO) dense_out_tile<H, DB, P>(wb + NB::W3, wb + NB::B3, tb + NMID * T, mb);
  __syncthreads();
}

// The backward of net a (with TWO also net b, beside it) over the tile from
// its mean's cotangent dm [DOUT][P + 4], on the tiles forward_tiles left: the
// gradient sums into its segment g, the pre-activation cotangents in place
// in its tiles, and the input cotangent into dx (=, or += with ADD); with
// cs (controls), the first layer's bias cotangent sums. Ends on a barrier.
template <int DIN, int H, int NMID, int DA, int DB, bool TWO, bool ADD_A, bool ADD_B, int P>
__device__ __forceinline__ void backward_net_tiles(const float* wa, float* ga, const float* xa,
                                                   float* ta, const float* dma, float* dxa,
                                                   double* csa, const float* wb, float* gb,
                                                   const float* xb, float* tb, const float* dmb,
                                                   float* dxb, double* csb) {
  using NA = Net<DIN, H, DA, NMID>;
  using NB = Net<DIN, H, DB, NMID>;
  constexpr int T = H * (P + 4);
  bwd_head_grads<H, DA, P>(ta + NMID * T, dma, ga + NA::W3);
  if constexpr (TWO) bwd_head_grads<H, DB, P>(tb + NMID * T, dmb, gb + NB::W3);
  __syncthreads();
  bwd_pre2<H, DA, P>(wa + NA::W3, dma, ta + NMID * T);
  if constexpr (TWO) bwd_pre2<H, DB, P>(wb + NB::W3, dmb, tb + NMID * T);
  __syncthreads();
#pragma unroll
  for (int j = NMID; j >= 1; --j) {
    bwd_mid_grads<H, P>(ta + (j - 1) * T, ta + j * T, ga + NA::W(j), ga + NA::B(j));
    if constexpr (TWO) bwd_mid_grads<H, P>(tb + (j - 1) * T, tb + j * T, gb + NB::W(j), gb + NB::B(j));
    __syncthreads();
    bwd_pre1<H, P>(wa + NA::W(j), ta + j * T, ta + (j - 1) * T);
    if constexpr (TWO) bwd_pre1<H, P>(wb + NB::W(j), tb + j * T, tb + (j - 1) * T);
    __syncthreads();
  }
  bwd_input<DIN, H, ADD_A, P>(wa + NA::W1, xa, ta, ga + NA::W1, dxa, csa);
  if constexpr (TWO) bwd_input<DIN, H, ADD_B, P>(wb + NB::W1, xb, tb, gb + NB::W1, dxb, csb);
  __syncthreads();
}

// With controls, before a step's tiles: cb = b1 + c of q1 and f, the same
// float adds as K1's (scan_forward.cuh::filter_step), and csum zeroed. The
// weights must be in s.wts; the tiles' first barrier publishes both.
template <int DX, int DY, int H>
__device__ __forceinline__ void load_control_bias(const BwdSmem& s, const float* coef, int off_f,
                                                  double* csum) {
  const float* cu = coef + 3 * DX + DY + 1;
  for (int o = threadIdx.x; o < 2 * H; o += kThreads) {
    s.cb[o] = s.wts[(o < H ? 0 : off_f) + DX * H + o % H] + cu[o];
    csum[o] = 0.0;
  }
}

// One trajectory row's operands of one backward step, in device or shared
// memory: K4 reads d x_new from its carry and scatters d x_{t-1} back into
// it, K15 reads device memory (its scatter writes d_x there).
struct BwdRow {
  const float* x_prev;   // [DX][K]: the step's incoming particles (x_res = x_prev[idx])
  const float* x_cur;    // [DX][K]: x_new
  const int* idx;        // [K]: ancestors, nondecreasing
  const float* eps;      // [DX][K]; stream mode only
  const float* coef;     // [3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f)
  const float* stats;    // [2 + DX]: ℓ in column 0
  const float* d_stats;  // [2 + DX]: column 0 is read
  const float* d_xn;     // [DX][ld] from particle `off`, or null: the cotangent of x_new
  const float* d_xn2;    // [DX][K] or null: a second one, added (K4's d_x_all)
  const float* d_al;     // [K] or null: the cotangent of α
  const float* d_al2;    // [K] or null: a second one, added
  float* d_x;            // [DX][ld] from particle `off`: d x_prev, written by K4's scatter
  float* d_coef;         // [3*DX + DY + 1 (+ 2H)]; written by K4's rank 0
  int ld, off;           // layout of d_xn and d_x: K4's carry of the slice, K15's rows
};

// The d_coef row from the row's sums (aq, cq, sq per dimension, then ab).
template <int DX, int DY>
__device__ __forceinline__ void write_coef_row(float* dc, const float (&sums)[kCoefSums<DX>]) {
#pragma unroll
  for (int e = 0; e < 3 * DX; ++e) dc[e] = sums[e];
#pragma unroll
  for (int q = 0; q < DY; ++q) dc[3 * DX + q] = 0.0f;  // y is data
  dc[3 * DX + DY] = sums[3 * DX];
}

// The backward of one filter step of row b, t on the particles [lo, hi)
// (module comment, 1.-4. and 8.): accumulates the weight gradients into
// s.gacc and the sconst ones into dsf/dsg, writes d x_res of particle i to
// dxres[d·ld + i − lo] and leaves the slice's d_coef sums (aq, cq, sq per
// dimension, then ab) in `sums`, in every thread. The ancestors come from
// idx: K4's copy in shared memory, K15's row in device memory. K4 runs it
// once per t on each CTA of a row's cluster, K15 once per launch on each
// slice of the row. With controls (csum not null) q1's and f's first layers
// read their biases from s.cb and their pre-activation cotangents are summed
// into csum [2H] (load_control_bias set both up). Under a split plan g is
// recomputed on x_new before f, and again for its backward after f's (its
// tiles are f's): the same values, one more forward of g. Ends on a barrier.
template <int DX, int DY, int H, int NMID, int BWD, int P>
__device__ __forceinline__ void backward_tiles(const BwdRow& r, const BwdSmem& s, const int* idx,
                                               int lo, int hi, float* dxres, int ld, int K,
                                               int off_f, int off_g, const float (&sfi)[DX],
                                               const float (&sgi)[DY], double (&dsf)[DX],
                                               double (&dsg)[DY], bool use_rng, uint32_t seed0,
                                               uint32_t seed1, int b, int t,
                                               float (&sums)[kCoefSums<DX>], double* csum) {
  constexpr int PS = P + 4;
  using NQ = Net<DX, H, DX, NMID>;  // q1 and f
  using NG = Net<DX, H, DY, NMID>;  // g
  constexpr bool kSplit = BwdLayout<H, NMID, BWD, P>::kSplit;
  const int tid = threadIdx.x;
  const float* wq = s.wts;
  const float* wf = s.wts + off_f;
  const float* wg = s.wts + off_g;
  float* gq = s.gacc;
  float* gf = s.gacc + off_f;
  float* gg = s.gacc + off_g;
  const float log_k = logf(static_cast<float>(K));
  const int p = tid;  // this thread's particle slot in a tile (tid < P)
  float* tf = s.act;                                           // f's tiles
  float* tg = s.act + (kSplit ? 0 : (NMID + 1) * H * PS);  // g's, then q1's
  float *xr = s.xr, *xn = s.xn, *ep = s.ep;
  float *mf = s.mf, *mg = s.mg, *mq = s.mq, *dmf = s.dmf, *dmg = s.dmg, *dmq = s.dmq;
  float *dxn = s.dxn, *dxr = s.dxr;
  const bool ctrl = csum != nullptr;
  const float* bq = ctrl ? s.cb : wq + NQ::B1;      // q1's first-layer bias
  const float* bf = ctrl ? s.cb + H : wf + NQ::B1;  // f's
  double* csum_f = ctrl ? csum + H : nullptr;

  const float* c = r.coef;
  float cq[DX], y[DY];
#pragma unroll
  for (int d = 0; d < DX; ++d) cq[d] = c[DX + d];
#pragma unroll
  for (int q = 0; q < DY; ++q) y[q] = c[3 * DX + q];
  const float ab = c[3 * DX + DY];
  const float ell = r.stats[0];
  const float d_ell = r.d_stats[0];
  float s_aq[DX], s_cq[DX], s_sq[DX], s_ab = 0.0f;
#pragma unroll
  for (int d = 0; d < DX; ++d) s_aq[d] = s_cq[d] = s_sq[d] = 0.0f;

  for (int i0 = lo; i0 < hi; i0 += P) {
    const int i = i0 + p;
    const bool mine = p < P && i < hi;  // a live particle of this tile
    // 1. operands of the tile
    if (p < P) {
      float e[DX];
      if (mine && use_rng) draw_eps<DX>(seed0, seed1, b, t, i, K, e);
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        xr[d * PS + p] = mine ? r.x_prev[d * K + idx[i]] : 0.0f;
        xn[d * PS + p] = mine ? r.x_cur[d * K + i] : 0.0f;
        ep[d * PS + p] = !mine ? 0.0f : (use_rng ? e[d] : r.eps[d * K + i]);
      }
    }
    __syncthreads();
    // 2. recompute f on x_res and g on x_new
    if constexpr (kSplit) {
      forward_tiles<DX, H, NMID, DY, DY, false, P>(wg, wg + NG::B1, xn, tg, mg, nullptr, nullptr,
                                                nullptr, nullptr, nullptr);
      forward_tiles<DX, H, NMID, DX, DX, false, P>(wf, bf, xr, tf, mf, nullptr, nullptr, nullptr,
                                                nullptr, nullptr);
    } else {
      forward_tiles<DX, H, NMID, DX, DY, true, P>(wf, bf, xr, tf, mf, wg, wg + NG::B1, xn, tg, mg);
    }
    // 3. α, its cotangent, and the cotangents of m_f, m_g and x_new
    if (p < P) {
      float xv[DX], mfv[DX], ev[DX], mgv[DY], da = 0.0f;
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        xv[d] = xn[d * PS + p];
        mfv[d] = mf[d * PS + p];
        ev[d] = ep[d * PS + p];
      }
#pragma unroll
      for (int q = 0; q < DY; ++q) mgv[q] = mg[q * PS + p];
      if (mine) {
        const float al = alpha_unfloored<DX, DY>(xv, mfv, ev, y, mgv, sfi, sgi, ab);
        if (al >= -3e30f) {  // no cotangent where the forward's floor clamped
          float d_in = 0.0f;
          if (r.d_al != nullptr) d_in += r.d_al[i];
          if (r.d_al2 != nullptr) d_in += r.d_al2[i];
          da = d_in + d_ell * expf(al - ell - log_k);
        }
        s_ab += da;
      }
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        const float rf = xv[d] - mfv[d];
        const float zf = rf * sfi[d];
        float dx = 0.0f;
        if (mine) {
          if (r.d_xn != nullptr) dx = r.d_xn[d * r.ld + i - r.off];
          if (r.d_xn2 != nullptr) dx += r.d_xn2[d * K + i];
          dsf[d] -= static_cast<double>(da * zf * rf);
        }
        dmf[d * PS + p] = da * zf * sfi[d];
        dxn[d * PS + p] = dx - da * zf * sfi[d];
      }
#pragma unroll
      for (int q = 0; q < DY; ++q) {
        const float rg = y[q] - mgv[q];
        const float zg = rg * sgi[q];
        if (mine) dsg[q] -= static_cast<double>(da * zg * rg);
        dmg[q * PS + p] = da * zg * sgi[q];
      }
    }
    __syncthreads();
    // 4. backprop g (adds d x_new) and f (writes d x_res)
    if constexpr (kSplit) {
      backward_net_tiles<DX, H, NMID, DX, DX, false, false, false, P>(
          wf, gf, xr, tf, dmf, dxr, csum_f, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr);
      forward_tiles<DX, H, NMID, DY, DY, false, P>(wg, wg + NG::B1, xn, tg, mg, nullptr, nullptr,
                                                nullptr, nullptr, nullptr);
      backward_net_tiles<DX, H, NMID, DY, DY, false, true, false, P>(
          wg, gg, xn, tg, dmg, dxn, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr);
    } else {
      backward_net_tiles<DX, H, NMID, DX, DY, true, false, true, P>(
          wf, gf, xr, tf, dmf, dxr, csum_f, wg, gg, xn, tg, dmg, dxn, nullptr);
    }
    // 5. recompute q1 on x_res, in g's tiles
    forward_tiles<DX, H, NMID, DX, DX, false, P>(wq, bq, xr, tg, mq, nullptr, nullptr, nullptr,
                                              nullptr, nullptr);
    // 6. the draw x_new = cq·m1 + aq + sq·ε: d m1 and the per-step sums
    if (p < P) {
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        const float dv = dxn[d * PS + p];
        dmq[d * PS + p] = cq[d] * dv;
        if (mine) {
          s_aq[d] += dv;
          s_cq[d] += dv * mq[d * PS + p];
          s_sq[d] += dv * ep[d * PS + p];
        }
      }
    }
    __syncthreads();
    // 7. backprop q1 (adds to d x_res)
    backward_net_tiles<DX, H, NMID, DX, DX, false, true, false, P>(
        wq, gq, xr, tg, dmq, dxr, csum, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr);
    if (mine) {
#pragma unroll
      for (int d = 0; d < DX; ++d) dxres[d * ld + i - lo] = dxr[d * PS + p];
    }
  }

  // 8. the slice's d_coef sums (the reductions' barriers end the tile loop)
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    sums[d] = block_reduce<false>(s_aq[d], s.red);
    sums[DX + d] = block_reduce<false>(s_cq[d], s.red);
    sums[2 * DX + d] = block_reduce<false>(s_sq[d], s.red);
  }
  sums[3 * DX] = block_reduce<false>(s_ab, s.red);
}

// K4's backward of one filter step of row b, t on the slice `sl`: the tiles
// (backward_tiles) on the slice, then the cluster's exchange (9.) and the
// scatter (10.): d x_prev of the slice into the carry and (rank 0) the
// d_coef row. Runs once per t on each CTA of a row's cluster. Ends on a
// barrier.
template <int DX, int DY, int H, int NMID, int BWD, int P>
__device__ __forceinline__ void backward_step(const BwdRow& r, const BwdSmem& s, const Slice& sl,
                                              int K, int off_f, int off_g,
                                              const float (&sfi)[DX], const float (&sgi)[DY],
                                              double (&dsf)[DX], double (&dsg)[DY], bool use_rng,
                                              uint32_t seed0, uint32_t seed1, int b, int t,
                                              bool ctrl) {
  const int tid = threadIdx.x;
  const int hi = sl.lo + sl.n;
  float* dxres = s.dxres + (sl.C > 1 ? (t & 1) * DX * sl.n : 0);  // [DX][n]
  for (int i = tid; i < K; i += kThreads) s.idx_s[i] = r.idx[i];
  __syncthreads();
  // csum by t's parity, as the partials: rank 0 reads a neighbour's before
  // step t−1's cluster barrier, after which that neighbour rezeroes it at t−2
  double* csum = ctrl ? s.csum + (t & 1) * 2 * H : nullptr;
  if (ctrl) load_control_bias<DX, DY, H>(s, r.coef, off_f, csum);
  float sums[kCoefSums<DX>];
  backward_tiles<DX, DY, H, NMID, BWD, P>(r, s, s.idx_s, sl.lo, hi, dxres, sl.n, K, off_f, off_g,
                                       sfi, sgi, dsf, dsg, use_rng, seed0, seed1, b, t, sums,
                                       csum);
  // a cluster's CTAs leave their sums for rank 0, which writes the row
  float* part = s.part + (t & 1) * kCoefSums<DX>;
  if (tid == 0 && sl.C > 1) {
#pragma unroll
    for (int e = 0; e < kCoefSums<DX>; ++e) part[e] = sums[e];
  }
  // 9. publish d x_res and the sums to the cluster
  if (sl.C > 1) {
    cg::this_cluster().sync();
    if (sl.rank == 0 && tid == 0) {  // add the slices' sums in rank order
      for (int q = 1; q < sl.C; ++q) {
        const float* pq = cg::this_cluster().map_shared_rank(part, q);
#pragma unroll
        for (int e = 0; e < kCoefSums<DX>; ++e) sums[e] += pq[e];
      }
    }
  }
  if (sl.rank == 0 && tid == 0) write_coef_row<DX, DY>(r.d_coef, sums);
  if (ctrl && sl.rank == 0) {  // the controls' columns: the slices' sums in rank order
    for (int o = tid; o < 2 * H; o += kThreads) {
      double v = csum[o];
      for (int q = 1; q < sl.C; ++q) v += cg::this_cluster().map_shared_rank(csum, q)[o];
      r.d_coef[3 * DX + DY + 1 + o] = static_cast<float>(v);
    }
  }

  // 10. scatter d x_res to the own ancestors j: a segmented sum over each run
  // of equal ancestors, in particle order, the run's particles read from the
  // slices of the ranks that own them
  for (int j = sl.lo + tid; j < hi; j += kThreads) {
    const int i_lo = lower_bound_idx(s.idx_s, K, j);
    const int i_hi = lower_bound_idx(s.idx_s, K, j + 1);
    float sum[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) sum[d] = 0.0f;
    for (int i = i_lo; i < i_hi;) {
      const int q = i / sl.n, end = min(i_hi, (q + 1) * sl.n);
      const float* src = q == sl.rank ? dxres : cg::this_cluster().map_shared_rank(dxres, q);
      for (; i < end; ++i) {
#pragma unroll
        for (int d = 0; d < DX; ++d) sum[d] += src[d * sl.n + i - q * sl.n];
      }
    }
#pragma unroll
    for (int d = 0; d < DX; ++d) r.d_x[d * r.ld + j - r.off] = sum[d];
  }
  __syncthreads();  // the scatter's writes before the next step reads them
}

// Load the weights (where the plan keeps them in shared memory), zero their
// gradient sums and read sconst.
template <int DX, int DY, bool kWtsSmem>
__device__ __forceinline__ void bwd_prologue(const BwdSmem& s, const float* weights,
                                             const float* sconst, int n_weights,
                                             float (&sfi)[DX], float (&sgi)[DY],
                                             double (&dsf)[DX], double (&dsg)[DY]) {
  for (int i = threadIdx.x; i < n_weights; i += kThreads) {
    if (kWtsSmem) s.wts[i] = weights[i];
    s.gacc[i] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    sfi[d] = sconst[d];
    dsf[d] = 0.0;
  }
#pragma unroll
  for (int q = 0; q < DY; ++q) {
    sgi[q] = sconst[DX + q];
    dsg[q] = 0.0;
  }
}

// Block-wide fp64 sum; every thread gets it. `dred` holds kWarps doubles.
__device__ __forceinline__ double block_sum_d(double v, double* dred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (lane == 0) dred[warp] = v;
  __syncthreads();
  double r = dred[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r += dred[w];
  __syncthreads();
  return r;
}

// The CTA's partial gradients: the weight sums, then d_sconst. The sconst
// sums cancel over B·K·T terms, so they are kept in fp64 (the tile arrays,
// idle after the last step, hold the reduction scratch): float32 sums in
// another order differed by 3.5e-6–6.5e-6 relative between C = 1 and C > 1
// at the FHN shape (PERF.md §6). Where the plan keeps the gradient sums in
// `part` itself, they are there already.
template <int DX, int DY, bool kGradSmem>
__device__ __forceinline__ void write_partial(const BwdSmem& s, int n_weights,
                                              const double (&dsf)[DX], const double (&dsg)[DY],
                                              float* part) {
  const int tid = threadIdx.x;
  double* dred = reinterpret_cast<double*>(s.xr);  // [DX][P + 4] floats, P >= 16: room for kWarps
  if (kGradSmem) {
    for (int i = tid; i < n_weights; i += kThreads) part[i] = s.gacc[i];
  }
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    const double v = block_sum_d(dsf[d], dred);
    if (tid == 0) part[n_weights + d] = static_cast<float>(v);
  }
#pragma unroll
  for (int q = 0; q < DY; ++q) {
    const double v = block_sum_d(dsg[q], dred);
    if (tid == 0) part[n_weights + DX + q] = static_cast<float>(v);
  }
}

template <int DX, int DY, int H, int NMID, int BWD, int P>
__global__ void __launch_bounds__(kThreads, 1) scan_backward_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = BwdLayout<H, NMID, BWD, P>;
  const int C = a.cluster, rank = static_cast<int>(cg::this_cluster().block_rank());
  const int K = a.K, B = a.B, b = blockIdx.x / C, tid = threadIdx.x;
  const Slice sl{rank * (K / C), K / C, rank, C};
  const bool ctrl = a.ctrl != 0;
  float* part = a.partial + ((size_t)b * C + rank) * (a.n_weights + DX + DY);
  const BwdSmem s = carve_bwd<DX, DY, H, NMID, BWD, P>(smem, a.weights, part, a.n_weights, K,
                                                       sl.n, true, C, ctrl);
  float sfi[DX], sgi[DY];
  double dsf[DX], dsg[DY];
  bwd_prologue<DX, DY, L::kWtsSmem>(s, a.weights, a.sconst, a.n_weights, sfi, sgi, dsf, dsg);
  for (int e = tid; e < DX * sl.n; e += kThreads) {  // the carry of the slice, [DX][n]
    const int d = e / sl.n, i = sl.lo + e % sl.n;
    s.carry[e] = a.d_x_last != nullptr ? a.d_x_last[((size_t)b * DX + d) * K + i] : 0.0f;
  }
  const int NC = 3 * DX + DY + 1 + (ctrl ? 2 * H : 0);

  for (int t = a.T1 - 1; t >= 0; --t) {
    const size_t row = (size_t)t * B + b;
    const BwdRow r{
        t == 0 ? a.x0 + (size_t)b * DX * K : a.x_all + ((size_t)(t - 1) * B + b) * DX * K,
        a.x_all + row * DX * K,
        a.idx + row * K,
        a.use_rng ? nullptr : a.eps + row * DX * K,
        a.coef + row * NC,
        a.stats + row * (2 + DX),
        a.d_stats + row * (2 + DX),
        s.carry,
        a.d_x_all != nullptr ? a.d_x_all + row * DX * K : nullptr,
        t == a.T1 - 1 && a.d_alpha_last != nullptr ? a.d_alpha_last + (size_t)b * K : nullptr,
        a.d_alpha_all != nullptr ? a.d_alpha_all + row * K : nullptr,
        s.carry,
        a.d_coef + row * NC,
        sl.n,
        sl.lo};
    backward_step<DX, DY, H, NMID, BWD, P>(r, s, sl, K, a.off_f, a.off_g, sfi, sgi, dsf, dsg,
                                        a.use_rng, a.seed0, a.seed1, b, t, ctrl);
  }

  for (int e = tid; e < DX * sl.n; e += kThreads) {
    const int d = e / sl.n, i = sl.lo + e % sl.n;
    a.d_x0[((size_t)b * DX + d) * K + i] = s.carry[e];
  }
  write_partial<DX, DY, L::kGradSmem>(s, a.n_weights, dsf, dsg, part);
  if (C > 1) cg::this_cluster().sync();  // no CTA leaves while another reads its d x_res
}

// out[e] = Σ_r partial[r][e], rows added in order in fp64: the per-CTA
// partial gradients of scan_backward_kernel (B·C rows) and
// step_backward_kernel (B·S) (the TPU kernels accumulated them in their own
// body, _accum_param_grads).
// (Static: each translation unit that includes this header has its own.)
static __global__ void sum_rows_kernel(const float* __restrict__ partial, int rows, int n,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  double s = 0.0;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * n + e];
  out[e] = static_cast<float>(s);
}

// sum_rows_kernel over `rows` partial gradient rows of n entries into grads.
inline cudaError_t sum_rows(const float* partial, int rows, int n, float* grads,
                            cudaStream_t stream) {
  sum_rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, rows, n,
                                                                         grads);
  return cudaGetLastError();
}

// K15 step_backward: the VJP of ONE K14 step per launch.
//
// Replaces psvo_tpu/ops/pallas_step.py::_step_bwd (kernel body _bwd_kernel,
// which runs _bwd_core and accumulates the parameter gradients over its row
// blocks): the backward of the per-step path of SCAN_FUSED = False, one call
// per step in lax.scan's reverse loop.
//
// Design. K4's tiles (backward_tiles) on one step's residuals from device
// memory: x (regathered as x_res = x[idx]), x_new, idx, the stats and ε; the
// cotangents d x_new and d α come from autograd (the next step's d x and the
// cache's cotangents, already summed). Each row runs on S CTAs with no
// cluster (step_slices.cuh; the host picks S, fused_step.step_slices): CTA
// (b, r) runs the P-particle tiles of its slice, writes the slice's d x_res
// to the scratch dxres [B, DX, K], its d_coef sums to coef_part [B, S, 3·DX
// + 1 (+ 2H with controls)] and its weight and sconst partials to row b·S + r
// of `partial`. The
// row's last CTA to arrive scatters d x[j] = Σ_{i: idx_i = j} d x_res_i over
// the whole row, reading d x_res from L2 in particle order with K4's
// sequential adds, so d x is bit-equal for every S and to K4's d_x0 chain;
// it adds the S d_coef sums in slice order. sum_rows_kernel then adds the
// B·S partial rows in fp64. Neither d x_res nor the ancestors stay in shared
// memory (the last CTA stages the row's ancestors in its idle activation
// tiles), so the shared memory does not depend on K: every K ≤ MAX_K fits at
// hidden 64 (fused_step.k15_smem_bytes). Deterministic: one owning thread per
// gradient entry, fixed reductions, the one atomic only counts arrivals.
//
// What bounds it. One step of K4's work (~26 kFLOP per particle and trunk)
// on B·S CTAs: the fp32 CUDA cores, as K4 (one CTA per SM: 183 KB of shared
// memory at Dx = 2, hidden 64). Each CTA also loads the weights, zeroes their
// gradient sums and writes a partial row (55 KB each), and the launch itself
// is paid per step.
struct StepBwdArgs {
  const float* x;        // [B, DX, K]: the step's incoming particles
  const float* x_new;    // [B, DX, K]
  const int* idx;        // [B, K]: ancestors, nondecreasing in K
  const float* stats;    // [B, 2 + DX]: ℓ in column 0
  const float* coef;     // [B, 3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f)
  const float* eps;      // [B, DX, K]
  const float* weights;  // q1 | f | g, fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  const float* d_stats;  // [B, 2 + DX]: column 0 is read
  const float* d_x_new;  // [B, DX, K] or null
  const float* d_alpha;  // [B, K] or null
  float* d_x;            // [B, DX, K]
  float* d_coef;         // [B, 3*DX + DY + 1 (+ 2H)]
  float* dxres;          // [B, DX, K] scratch: d x_res of every particle
  float* coef_part;      // [B, S, 3*DX + 1 (+ 2H)] scratch: the slices' d_coef sums
  float* partial;        // [B*S, n_weights + DX + DY]: per-CTA weight and sconst grads
  int* counter;          // [B]: arrivals per row, 0 between launches
  int B, K, n_weights, off_f, off_g;
  int ctrl;              // 1: coef rows end in the controls' q1 and f first-layer terms [2H]
  int slices;            // S: CTAs per row, K % S == 0
};

template <int DX, int DY, int H, int NMID, int BWD, int P>
__global__ void __launch_bounds__(kThreads, 1) step_backward_kernel(const StepBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = BwdLayout<H, NMID, BWD, P>;
  const int S = a.slices, K = a.K, b = blockIdx.x / S, tid = threadIdx.x;
  const int n = K / S, lo = (blockIdx.x % S) * n;  // this CTA's particles [lo, lo + n)
  const bool ctrl = a.ctrl != 0;
  const bool own_idx = K > L::kTileFloats;  // the ancestors need shared memory of their own
  float* part = a.partial + (size_t)blockIdx.x * (a.n_weights + DX + DY);
  const BwdSmem s = carve_bwd<DX, DY, H, NMID, BWD, P>(smem, a.weights, part, a.n_weights,
                                                       own_idx ? K : 0, 0, false, 1, ctrl);
  float sfi[DX], sgi[DY];
  double dsf[DX], dsg[DY];
  bwd_prologue<DX, DY, L::kWtsSmem>(s, a.weights, a.sconst, a.n_weights, sfi, sgi, dsf, dsg);
  const int NC = 3 * DX + DY + 1 + (ctrl ? 2 * H : 0);
  const int CS = kCoefSums<DX> + (ctrl ? 2 * H : 0);  // a slice's d_coef sums
  const size_t bx = (size_t)b * DX * K;
  const BwdRow r{a.x + bx,
                 a.x_new + bx,
                 a.idx + (size_t)b * K,
                 a.eps + bx,
                 a.coef + (size_t)b * NC,
                 a.stats + (size_t)b * (2 + DX),
                 a.d_stats + (size_t)b * (2 + DX),
                 a.d_x_new != nullptr ? a.d_x_new + bx : nullptr,
                 nullptr,
                 a.d_alpha != nullptr ? a.d_alpha + (size_t)b * K : nullptr,
                 nullptr,
                 a.d_x + bx,
                 a.d_coef + (size_t)b * NC,
                 K,
                 0};
  float* dxres = a.dxres + bx;  // [DX][K]
  float sums[kCoefSums<DX>];
  __syncthreads();  // the weights are loaded
  double* csum = ctrl ? s.csum : nullptr;
  if (ctrl) load_control_bias<DX, DY, H>(s, r.coef, a.off_f, csum);
  backward_tiles<DX, DY, H, NMID, BWD, P>(r, s, r.idx, lo, lo + n, dxres + lo, K, K, a.off_f,
                                       a.off_g, sfi, sgi, dsf, dsg, false, 0u, 0u, b, 0, sums,
                                       csum);
  write_partial<DX, DY, L::kGradSmem>(s, a.n_weights, dsf, dsg, part);
  const float* parts = a.coef_part + (size_t)b * S * CS;  // [S][CS]
  if (tid == 0) {
#pragma unroll
    for (int e = 0; e < kCoefSums<DX>; ++e)
      a.coef_part[(size_t)blockIdx.x * CS + e] = sums[e];
  }
  if (ctrl) {  // write_partial's barriers ordered the tiles' csum sums before this
    for (int o = tid; o < 2 * H; o += kThreads)
      a.coef_part[(size_t)blockIdx.x * CS + kCoefSums<DX> + o] = static_cast<float>(csum[o]);
  }
  if (!last_to_arrive(a.counter + b, S)) return;

  // the row's last CTA: the scatter over the whole row, a segmented sum over
  // each run of equal ancestors in particle order (K4's order), with the
  // row's ancestors staged in the idle activation tiles (or their own
  // shared memory where the tiles hold fewer than K ints)
  int* idx_s = own_idx ? s.idx_s : reinterpret_cast<int*>(s.act);
  for (int i = tid; i < K; i += kThreads) idx_s[i] = r.idx[i];
  __syncthreads();
  for (int j = tid; j < K; j += kThreads) {
    const int i_lo = lower_bound_idx(idx_s, K, j);
    const int i_hi = lower_bound_idx(idx_s, K, j + 1);
    float sum[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) sum[d] = 0.0f;
    for (int i = i_lo; i < i_hi; ++i) {
#pragma unroll
      for (int d = 0; d < DX; ++d) sum[d] += __ldcg(dxres + d * K + i);
    }
#pragma unroll
    for (int d = 0; d < DX; ++d) r.d_x[d * K + j] = sum[d];
  }
  if (tid == 0) {  // the slices' d_coef sums, added in slice order
#pragma unroll
    for (int e = 0; e < kCoefSums<DX>; ++e) sums[e] = __ldcg(parts + e);
    for (int q = 1; q < S; ++q) {
#pragma unroll
      for (int e = 0; e < kCoefSums<DX>; ++e) sums[e] += __ldcg(parts + q * CS + e);
    }
    write_coef_row<DX, DY>(r.d_coef, sums);
  }
  if (ctrl) {  // the controls' columns, likewise
    for (int o = tid; o < 2 * H; o += kThreads) {
      float v = __ldcg(parts + kCoefSums<DX> + o);
      for (int q = 1; q < S; ++q) v += __ldcg(parts + q * CS + kCoefSums<DX> + o);
      r.d_coef[3 * DX + DY + 1 + o] = v;
    }
  }
}

}  // namespace psvo
