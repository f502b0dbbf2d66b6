// K1 scan_forward: the whole forward FIVO filter, t = 1 .. T-1, in one launch;
// and K14 step_forward (at the end): one step of the same code per launch.
//
// Replaces psvo_tpu/ops/pallas_step.py::_scan_fwd (kernel body
// _scan_fwd_kernel), which inlines _fwd_core, pallas_resample's
// _two_level_indices, _gather_particles/_lane_gather, _trunk,
// _propose_weight_core and the in-kernel RNG _rng_eps/_rng_sys_u.
//
// Design. Each trajectory row b runs on a thread-block cluster of C CTAs
// (grid = B·C, cluster.cuh; the host picks C, fused_step.cluster_size), and
// the cluster walks the time loop that was the TPU kernel's sequential t
// grid axis. Every CTA keeps the whole row's carry in shared memory for the
// whole scan — particles x [Dx][K] and log-weights [K], both double-buffered
// by t's parity — with the q1/f/g weights (about 53 KB in fp32 at hidden
// (64, 64), hence dynamic shared memory above 48 KB) and the fp64 CDF [K]:
// 84.6 KB per CTA at Dx = 2, K = 1024, 94.1 KB at Dx = 3, 214 KB at Dx = 3,
// K = MAX_K = 4096. CTA rank r owns particles [r·K/C, (r+1)·K/C). Per step:
//   1. every CTA: the ESS of the incoming weights and their fp64 inclusive
//      CDF over the whole row (resample.cuh::block_cdf), redundantly, so
//      every CTA holds the same CDF and total and draws the same ancestors;
//   2. per particle i of the own slice: the ancestor a_i by binary search,
//      x_res = x[:, a_i] (from the CTA's own copy of the row), the q1 and f
//      trunks on x_res, the fused draw x_new = cq·m1 + aq + sq·ε, the g trunk
//      on x_new, and α = −½Σ(z_f² − ε² + z_g²) + ab floored at −3e30; x_new
//      and α go into the other parity's buffers of all C CTAs (DSMEM stores);
//   3. one cluster barrier: every CTA holds the new row;
//   4. rank 0: ℓ = lse(α) − log K and the filtered mean over the whole row,
//      by block reductions in K1's order, into stats (row_stats).
// With x and α double-buffered, one barrier per step is race-free: a CTA at
// step t+1 writes the buffers that its neighbours last read before step t's
// barrier. The particle arithmetic, the CDF and the reductions do not depend
// on C, so every output is bit-equal for every C.
// ε and the positions are either streamed operands or drawn in the kernel
// (philox.cuh, indexed by the particle's row index), which then reads no
// noise from device memory at all. Residual mode (fused_step.ScanForward,
// the train step) also writes every step's x_new into x_all and its ancestor
// indices into idx: what _scan_fwd keeps for its backward (scan_backward.cu),
// which regathers the resampled particles as x_{t-1}[idx_t] instead of
// storing them.
//
// What bounds it. At B=32, K=1024, hidden (64, 64) one step is ~0.9 GFLOP
// of fp32 FMAs on the CUDA cores (three trunks per particle, the 64x64
// middle layer dominating) against ~0.5 MB of noise traffic, so it is
// arithmetic-bound. One CTA per row ran B = 32 CTAs on 32 of the card's 132
// SMs; a cluster of C runs B·C CTAs, each with K/C of the trunk work, at the
// price of one cluster barrier per step and the O(K) CDF, which every CTA
// repeats. At 242 registers a thread (Dx = 2, hidden 64) one CTA fits an
// SM, and the H100 holds 66 clusters of 2 but only 30 of 4 at once, so at
// B = 32 the host picks C = 2 (64 SMs). The trunk keeps a particle's first
// hidden layer in registers and streams the middle layer straight into the
// output layer, so no activation touches shared or device memory; every
// weight read is a warp-uniform shared-memory broadcast (float4 where rows
// allow).
//
// The class (fused_step.usable): any Dx, Dy >= 1 with max(Dx + Di, Dy) <= 7,
// any depth, any hidden width that is a multiple of 8 (the float4 weight
// reads need H % 4 == 0). Where Dy != Dx, g runs a trunk of its own (DY
// outputs). At the largest shapes of widths up to 64 (Dx 6-7, K >= 1792,
// three layers of 56-64) the weights and the double-buffered row do not fit
// together: there the plan kFwdStream (step_math.cuh) leaves the weights in
// device memory, where the trunk's warp-uniform reads hit L1. Above 64 the
// register trunk would spill (2H floats a thread): the plan kFwdTile runs the
// trunks over tiles of FP particles in shared memory instead
// (filter_tiles), one layer a step, with the weights in device memory and
// K1's bits.
//
// The ones-channel bias folding and the PD=8 / HA=H+8 padding of the TPU
// kernel existed for the MXU and Mosaic and are not carried over: the
// kernel reads plain weights and biases (fused_step.prepare's layout).
//
// Controls (ctrl = 1, data.di > 0). The TPU kernel carried u_t as extra
// rows of every particle's state, the tile's free sublanes. u_t is the same
// for all K particles of a row, so here it enters as a first-layer bias of
// q1 and f instead: the coef row of (t, b) ends in c = u_t·W_u for q1 and f
// (2H floats, fused_step.control_term, one product outside the kernel), and
// each step copies b1 + c of both nets into shared memory (cb) once, where
// the trunk's first layer starts its accumulator. The particle state stays
// [DX][K] and its registers as they were; the extra work per (t, row) is
// 2H adds and a 2H-float read. The mode is a template flag (CTRL) of K1 and
// K14, each built both ways: ctrl = 0 runs the code as before, with its
// registers and its time (a run-time flag cost K14 11 registers and half its
// speed), and the same bits.
//
// This header holds the kernels; scan_forward.cu (the entry points and the
// builds without controls) and scan_forward_ctrl.cu (the control builds)
// instantiate them.
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

struct ScanArgs {
  const float* x0;       // [B, DX, K]
  const float* alpha0;   // [B, K]
  const float* coef;     // [T1, B, 3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f)
  const float* eps;      // [T1, B, DX, K]; stream mode only
  const float* pos;      // [T1, B, K] sorted positions; stream mode only
  const float* weights;  // q1 | f | g, each fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  float* x_last;         // [B, DX, K]
  float* alpha_last;     // [B, K]
  float* stats;          // [T1, B, 2 + DX]: ell, ess, filtered mean
  float* x_all;          // [T1, B, DX, K] or null (neither cache nor residuals)
  float* alpha_all;      // [T1, B, K] or null (no cache)
  int* idx;              // [T1, B, K] ancestor indices or null (no residuals)
  uint32_t seed0, seed1;
  int use_rng, B, K, T1, n_mid, n_weights, off_f, off_g;
  int cluster;           // C: CTAs per row, K % C == 0
};

// relu(x W + b) for one particle: W [DIN, H] row-major, b [H] (the net's
// own bias, which follows W, or the step's b + c with controls).
template <int DIN, int H>
__device__ __forceinline__ void dense_relu_in(const float* __restrict__ w,
                                              const float* __restrict__ b,
                                              const float (&x)[DIN], float (&h)[H]) {
#pragma unroll
  for (int o = 0; o < H; o += 4) {
    float4 acc = *reinterpret_cast<const float4*>(b + o);
#pragma unroll
    for (int i = 0; i < DIN; ++i) {
      const float4 c = *reinterpret_cast<const float4*>(w + i * H + o);
      acc.x = fmaf(x[i], c.x, acc.x);
      acc.y = fmaf(x[i], c.y, acc.y);
      acc.z = fmaf(x[i], c.z, acc.z);
      acc.w = fmaf(x[i], c.w, acc.w);
    }
    h[o] = fmaxf(acc.x, 0.0f);
    h[o + 1] = fmaxf(acc.y, 0.0f);
    h[o + 2] = fmaxf(acc.z, 0.0f);
    h[o + 3] = fmaxf(acc.w, 0.0f);
  }
}

// Pre-activations of four consecutive units o..o+3 of an [H, H] layer.
template <int H>
__device__ __forceinline__ float4 dense4(const float* __restrict__ w,
                                         const float* __restrict__ b, int o,
                                         const float (&h)[H]) {
  float4 acc = *reinterpret_cast<const float4*>(b + o);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float4 c = *reinterpret_cast<const float4*>(w + i * H + o);
    acc.x = fmaf(h[i], c.x, acc.x);
    acc.y = fmaf(h[i], c.y, acc.y);
    acc.z = fmaf(h[i], c.z, acc.z);
    acc.w = fmaf(h[i], c.w, acc.w);
  }
  return acc;
}

// One relu MLP head on one particle: layers [DIN -> H], n_mid x [H -> H],
// mean [H -> DOUT], the first layer's bias read from b1. The last hidden
// layer is never stored: each group of four units feeds the output layer as
// soon as it is computed.
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void trunk(const float* __restrict__ w, const float* __restrict__ b1,
                                      int n_mid, const float (&x)[DIN], float (&out)[DOUT]) {
  float h[H];
  dense_relu_in<DIN, H>(w, b1, x, h);
  const float* p = w + DIN * H + H;
  for (int j = 0; j + 1 < n_mid; ++j) {
    float g[H];
#pragma unroll
    for (int o = 0; o < H; o += 4) {
      const float4 a = dense4<H>(p, p + H * H, o, h);
      g[o] = fmaxf(a.x, 0.0f);
      g[o + 1] = fmaxf(a.y, 0.0f);
      g[o + 2] = fmaxf(a.z, 0.0f);
      g[o + 3] = fmaxf(a.w, 0.0f);
    }
#pragma unroll
    for (int o = 0; o < H; ++o) h[o] = g[o];
    p += H * H + H;
  }
  if (n_mid > 0) {
    const float* w3 = p + H * H + H;
    const float* b3 = w3 + H * DOUT;
#pragma unroll
    for (int d = 0; d < DOUT; ++d) out[d] = b3[d];
#pragma unroll
    for (int o = 0; o < H; o += 4) {
      const float4 a = dense4<H>(p, p + H * H, o, h);
      const float r[4] = {fmaxf(a.x, 0.0f), fmaxf(a.y, 0.0f), fmaxf(a.z, 0.0f),
                          fmaxf(a.w, 0.0f)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int d = 0; d < DOUT; ++d) out[d] = fmaf(r[q], w3[(o + q) * DOUT + d], out[d]);
      }
    }
  } else {
    const float* b3 = p + H * DOUT;
#pragma unroll
    for (int d = 0; d < DOUT; ++d) out[d] = b3[d];
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int d = 0; d < DOUT; ++d) out[d] = fmaf(h[i], p[i * DOUT + d], out[d]);
    }
  }
}

// One trajectory row's operands and outputs of one filtering step, in device
// memory. The carry (particles and log-weights) is in shared memory.
struct StepRow {
  const float* coef;  // [3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f)
  const float* eps;   // [DX][K]; stream mode only
  const float* pos;   // [K] sorted positions; stream mode only
  float* x_out;       // [DX][K]: x_new, or null
  float* alpha_out;   // [K]: α, or null
  int* idx;           // [K]: ancestor indices, or null
};

// A CTA's shared memory in K1 and K14: the fp64 CDF, the weights, the
// particles and log-weights double-buffered by t's parity (K14 reads one
// buffer and writes the other), the reduction scratch, under the tiled plan
// the tiles of its trunks and, with controls, the step's first-layer biases
// of q1 and f.
struct FwdSmem {
  double* cdf;  // [K]
  double* dred; // [kWarps]
  float* wts;   // [n_weights]
  float* xbuf;  // [2][DX][K]
  float* lw;    // [2][K]
  float* red;   // [kWarps]
  float* act;   // [2][H][FP + 4]: the hidden layers of one trunk (kFwdTile only)
  float *txr, *tep, *tm1, *tmf, *txn;  // [DX][FP + 4] each: x_res, ε, m1, m_f, x_new
  float* tmg;   // [DY][FP + 4]: m_g
  float* cb;    // [2H]: b1 + c of q1, then of f (ctrl only)
};

// The floats of the tiled plan's tiles (kFwdTile), 0 under the other plans.
template <int DX, int DY, int H, int FWD, int FP>
constexpr int kFwdTileFloats = FWD == kFwdTile ? (2 * H + 5 * DX + DY) * (FP + 4) : 0;

// FWD = kFwdStream or kFwdTile: the weights stay in device memory
// (`weights`) and take no shared memory.
template <int DX, int DY, int H, int FWD, int FP>
__device__ __forceinline__ FwdSmem carve_fwd(unsigned char* smem, const float* weights,
                                             int n_weights, int K) {
  constexpr int PS = FP + 4;
  FwdSmem s;
  s.cdf = reinterpret_cast<double*>(smem);
  s.dred = s.cdf + K;
  float* after = reinterpret_cast<float*>(s.dred + kWarps);
  s.wts = FWD != kFwdSmem ? const_cast<float*>(weights) : after;
  s.xbuf = after + (FWD != kFwdSmem ? 0 : n_weights);
  s.lw = s.xbuf + 2 * DX * K;
  s.red = s.lw + 2 * K;
  // 16-byte aligned from here on: every earlier extent is a multiple of 4 floats
  s.act = s.red + kWarps;
  s.txr = s.act + 2 * H * PS;
  s.tep = s.txr + DX * PS;
  s.tm1 = s.tep + DX * PS;
  s.tmf = s.tm1 + DX * PS;
  s.txn = s.tmf + DX * PS;
  s.tmg = s.txn + DX * PS;
  s.cb = s.red + kWarps + kFwdTileFloats<DX, DY, H, FWD, FP>;
  return s;
}

// cb_floats: 2H with controls, else 0.
template <int DX, int DY, int H, int FWD, int FP>
size_t fwd_smem_bytes(int n_weights, int K, int cb_floats) {
  return sizeof(double) * (K + kWarps) +
         sizeof(float) * ((FWD != kFwdSmem ? 0 : n_weights) + 2 * DX * K + 2 * K + kWarps +
                          kFwdTileFloats<DX, DY, H, FWD, FP> + cb_floats);
}

// Where a step's x_new [DX][K] and α [K] go. K14: the CTA's own buffers,
// published by a block barrier.
struct CtaOut {
  float *xn, *lw;
  template <int DX>
  __device__ __forceinline__ void put(int i, int K, const float (&x)[DX], float a) const {
#pragma unroll
    for (int d = 0; d < DX; ++d) xn[d * K + i] = x[d];
    lw[i] = a;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// K1: the same buffers in each of the cluster's C CTAs (DSMEM stores; the
// carve is the same in every CTA), published by a cluster barrier, which
// also orders the stores before any CTA reads the row. A cluster of one
// (C = 1, as at the SVO preset's K = 256) stores and syncs as K14 does.
struct ClusterOut {
  float *xn, *lw;
  int ranks;
  template <int DX>
  __device__ __forceinline__ void put(int i, int K, const float (&x)[DX], float a) const {
    if (ranks == 1) {
      CtaOut{xn, lw}.template put<DX>(i, K, x, a);
      return;
    }
    const cg::cluster_group cluster = cg::this_cluster();
    for (int q = 0; q < ranks; ++q) {
      float* xq = cluster.map_shared_rank(xn, q);
#pragma unroll
      for (int d = 0; d < DX; ++d) xq[d * K + i] = x[d];
      cluster.map_shared_rank(lw, q)[i] = a;
    }
  }
  __device__ __forceinline__ void sync() const {
    if (ranks == 1)
      __syncthreads();
    else
      cg::this_cluster().sync();
  }
};

// Step 2 of filter_step under the tiled plan (kFwdTile): the particles of
// [lo, hi) in tiles of FP. Per tile, thread p < FP resamples particle lo + p
// into the tile's x_res and stages its ε; q1 and f run over the tile
// (step_tiles.cuh::tile_net), thread p draws x_new from m1; g runs over the
// tile; thread p weights its particle and hands it to `out`. Every output of
// every layer has one owning thread adding in K1's order (bias first, inputs
// ascending), so m1, m_f, m_g, x_new and α are the register trunk's bits and
// the same for every FP. The weights stay in device memory.
template <int DX, int DY, int H, int FP, bool CTRL, class Out>
__device__ __forceinline__ void filter_tiles(const StepRow& r, const FwdSmem& s, const float* xc,
                                             const Out& out, int lo, int hi, int K, int n_mid,
                                             int off_f, int off_g, const float (&sfi)[DX],
                                             const float (&sgi)[DY], const float (&aq)[DX],
                                             const float (&cq)[DX], const float (&sq)[DX],
                                             const float (&y)[DY], float ab, double total,
                                             float u0, bool use_rng, uint32_t seed0,
                                             uint32_t seed1, int b, int t) {
  constexpr int PS = FP + 4;
  const int tid = threadIdx.x;
  const float* wq = s.wts;
  const float* wf = s.wts + off_f;
  const float* wg = s.wts + off_g;
  const float* bq = CTRL ? s.cb : wq + DX * H;
  const float* bf = CTRL ? s.cb + H : wf + DX * H;
  for (int i0 = lo; i0 < hi; i0 += FP) {
    const int i = i0 + tid;
    const bool mine = tid < FP && i < hi;  // a live particle of this tile
    int anc = 0;
    if (tid < FP) {
      float e[DX];
#pragma unroll
      for (int d = 0; d < DX; ++d) e[d] = 0.0f;
      if (mine) {
        const float pos = use_rng ? systematic_position(i, u0, K) : r.pos[i];
        anc = ancestor(s.cdf, K, static_cast<double>(pos) * total);
        if (use_rng) {
          draw_eps<DX>(seed0, seed1, b, t, i, K, e);
        } else {
#pragma unroll
          for (int d = 0; d < DX; ++d) e[d] = r.eps[d * K + i];
        }
      }
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        s.txr[d * PS + tid] = mine ? xc[d * K + anc] : 0.0f;
        s.tep[d * PS + tid] = e[d];
      }
    }
    __syncthreads();
    tile_net<DX, H, DX, FP>(wq, bq, n_mid, s.txr, s.act, s.tm1);
    tile_net<DX, H, DX, FP>(wf, bf, n_mid, s.txr, s.act, s.tmf);
    if (tid < FP) {
#pragma unroll
      for (int d = 0; d < DX; ++d)
        s.txn[d * PS + tid] =
            fused_draw(cq[d], s.tm1[d * PS + tid], aq[d], sq[d], s.tep[d * PS + tid]);
    }
    __syncthreads();
    tile_net<DX, H, DY, FP>(wg, wg + DX * H, n_mid, s.txn, s.act, s.tmg);
    if (mine) {
      float xn[DX], mf[DX], e[DX], mg[DY];
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        xn[d] = s.txn[d * PS + tid];
        mf[d] = s.tmf[d * PS + tid];
        e[d] = s.tep[d * PS + tid];
      }
#pragma unroll
      for (int q = 0; q < DY; ++q) mg[q] = s.tmg[q * PS + tid];
      // finiteness floor: a diverged mean gives a finite, hopeless weight
      const float alpha =
          fmaxf(alpha_unfloored<DX, DY>(xn, mf, e, y, mg, sfi, sgi, ab), -3e30f);
      out.template put<DX>(i, K, xn, alpha);
      if (r.x_out != nullptr) {
#pragma unroll
        for (int d = 0; d < DX; ++d) r.x_out[d * K + i] = xn[d];
      }
      if (r.alpha_out != nullptr) r.alpha_out[i] = alpha;
      if (r.idx != nullptr) r.idx[i] = anc;
    }
    // the next tile's staging writes only this thread's own columns, and every
    // other read of the tiles ended on tile_net's closing barriers
  }
}

// One filtering step of row b, t, on the carry xc [DX][K] and lwc [K]: the
// ESS and CDF of the incoming weights over the whole row; per particle i of
// [lo, hi) the ancestor, the q1 and f trunks on the resampled particle, the
// fused draw, the g trunk and α, handed to `out`; then out.sync(). Returns
// the ESS. K1 runs it once per t on each CTA of a row's cluster, K14 once
// per launch on each slice of the row: the same code, so the same bits.
// With CTRL, q1's and f's first layers start from b1 + c (cb), written here
// before the first barrier. Under the tiled plan (FWD = kFwdTile) the
// particles go through in tiles of FP (filter_tiles), with the same bits.
// Ends on a barrier.
template <int DX, int DY, int H, int FWD, int FP, bool CTRL, class Out>
__device__ __forceinline__ float filter_step(const StepRow& r, const FwdSmem& s, const float* xc,
                                            const float* lwc, const Out& out, int lo, int hi,
                                            int K, int n_mid, int off_f, int off_g,
                                            const float (&sfi)[DX], const float (&sgi)[DY],
                                            bool use_rng, uint32_t seed0, uint32_t seed1, int b,
                                            int t) {
  const int tid = threadIdx.x;
  const float* c = r.coef;
  if (CTRL) {  // the previous step's reads of cb ended at its closing barrier
    const float* cu = c + 3 * DX + DY + 1;
    for (int o = tid; o < 2 * H; o += kThreads)
      s.cb[o] = s.wts[(o < H ? 0 : off_f) + DX * H + o % H] + cu[o];
  }
  float aq[DX], cq[DX], sq[DX], y[DY];
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    aq[d] = c[d];
    cq[d] = c[DX + d];
    sq[d] = c[2 * DX + d];
  }
#pragma unroll
  for (int e = 0; e < DY; ++e) y[e] = c[3 * DX + e];
  const float ab = c[3 * DX + DY];

  // 1. ESS and the CDF of the incoming weights
  const float m = block_max_of(lwc, K, s.red);
  float s1, s2;
  const double total = block_cdf(lwc, K, m, s.cdf, s.dred, s.red, &s1, &s2);
  const float ess = s1 * s1 / fmaxf(s2, 1e-30f);
  const float u0 = use_rng ? draw_u0(seed0, seed1, b, t) : 0.0f;

  if constexpr (FWD == kFwdTile) {
    filter_tiles<DX, DY, H, FP, CTRL>(r, s, xc, out, lo, hi, K, n_mid, off_f, off_g, sfi, sgi,
                                      aq, cq, sq, y, ab, total, u0, use_rng, seed0, seed1, b, t);
  } else {
    // 2. resample, propose and weight each particle of [lo, hi)
    for (int i = lo + tid; i < hi; i += kThreads) {
      const float pos = use_rng ? systematic_position(i, u0, K) : r.pos[i];
      const int anc = ancestor(s.cdf, K, static_cast<double>(pos) * total);
      float e[DX];
      if (use_rng) {
        draw_eps<DX>(seed0, seed1, b, t, i, K, e);
      } else {
#pragma unroll
        for (int d = 0; d < DX; ++d) e[d] = r.eps[d * K + i];
      }
      // The three heads run through ONE copy of the (fully unrolled) trunk:
      // q1 and f on the resampled particle, then g on the drawn one. Where
      // Dy != Dx, g's output width differs, and g has a trunk of its own.
      float xn[DX], m1[DX], mf[DX], mg[DY];
#pragma unroll
      for (int d = 0; d < DX; ++d) xn[d] = xc[d * K + anc];
      if constexpr (DX == DY) {
#pragma unroll 1
        for (int n = 0; n < 3; ++n) {
          if (n == 2) {
#pragma unroll
            for (int d = 0; d < DX; ++d) xn[d] = fused_draw(cq[d], m1[d], aq[d], sq[d], e[d]);
          }
          const int off = n == 0 ? 0 : (n == 1 ? off_f : off_g);
          const float* b1 = CTRL && n < 2 ? s.cb + n * H : s.wts + off + DX * H;
          trunk<DX, H, DY>(s.wts + off, b1, n_mid, xn, mg);
#pragma unroll
          for (int d = 0; d < DX; ++d) {
            if (n == 0) m1[d] = mg[d];
            if (n == 1) mf[d] = mg[d];
          }
        }
      } else {
#pragma unroll 1
        for (int n = 0; n < 2; ++n) {
          const int off = n == 0 ? 0 : off_f;
          const float* b1 = CTRL ? s.cb + n * H : s.wts + off + DX * H;
          float m[DX];
          trunk<DX, H, DX>(s.wts + off, b1, n_mid, xn, m);
#pragma unroll
          for (int d = 0; d < DX; ++d) {
            if (n == 0) m1[d] = m[d];
            if (n == 1) mf[d] = m[d];
          }
        }
#pragma unroll
        for (int d = 0; d < DX; ++d) xn[d] = fused_draw(cq[d], m1[d], aq[d], sq[d], e[d]);
        trunk<DX, H, DY>(s.wts + off_g, s.wts + off_g + DX * H, n_mid, xn, mg);
      }
      // finiteness floor: a diverged mean gives a finite, hopeless weight
      const float alpha =
          fmaxf(alpha_unfloored<DX, DY>(xn, mf, e, y, mg, sfi, sgi, ab), -3e30f);
      out.template put<DX>(i, K, xn, alpha);
      if (r.x_out != nullptr) {
#pragma unroll
        for (int d = 0; d < DX; ++d) r.x_out[d * K + i] = xn[d];
      }
      if (r.alpha_out != nullptr) r.alpha_out[i] = alpha;
      if (r.idx != nullptr) r.idx[i] = anc;
    }
  }
  out.sync();
  return ess;
}

// 3. The logZ increment ℓ = log mean exp(α) and the filtered mean under the
// new weights of the whole row (x_new xn [DX][K], α lw [K]), with the ESS of
// the incoming ones, into stats [2 + DX], by block reductions in K1's order:
// one CTA of the row runs it, whatever the row's CTA count, so the bits do
// not depend on it.
template <int DX>
__device__ __forceinline__ void row_stats(const float* xn, const float* lw, int K, float ess,
                                          float* red, float* stats) {
  const int tid = threadIdx.x;
  const float amax = block_max_of(lw, K, red);
  float sw = 0.0f, sx[DX];
#pragma unroll
  for (int d = 0; d < DX; ++d) sx[d] = 0.0f;
  for (int i = tid; i < K; i += kThreads) {
    const float w = expf(lw[i] - amax);
    sw += w;
#pragma unroll
    for (int d = 0; d < DX; ++d) sx[d] = fmaf(w, xn[d * K + i], sx[d]);
  }
  sw = block_reduce<false>(sw, red);
#pragma unroll
  for (int d = 0; d < DX; ++d) sx[d] = block_reduce<false>(sx[d], red);
  if (tid == 0) {
    stats[0] = logf(sw) + amax - logf(static_cast<float>(K));
    stats[1] = ess;
#pragma unroll
    for (int d = 0; d < DX; ++d) stats[2 + d] = sx[d] / sw;
  }
}

template <int DX, int DY, int H, int FWD, int FP, bool CTRL>
__global__ void __launch_bounds__(kThreads) scan_forward_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = static_cast<int>(cluster.block_rank());
  const int K = a.K, B = a.B, b = blockIdx.x / C, tid = threadIdx.x;
  const int n = K / C, lo = rank * n;  // this CTA's particles [lo, lo + n)
  const FwdSmem s = carve_fwd<DX, DY, H, FWD, FP>(smem, a.weights, a.n_weights, K);
  if (FWD == kFwdSmem) {
    for (int i = tid; i < a.n_weights; i += kThreads) s.wts[i] = a.weights[i];
  }
  for (int i = tid; i < DX * K; i += kThreads) s.xbuf[i] = a.x0[(size_t)b * DX * K + i];
  for (int i = tid; i < K; i += kThreads) s.lw[i] = a.alpha0[(size_t)b * K + i];
  float sfi[DX], sgi[DY];
#pragma unroll
  for (int d = 0; d < DX; ++d) sfi[d] = a.sconst[d];
#pragma unroll
  for (int e = 0; e < DY; ++e) sgi[e] = a.sconst[DX + e];
  cluster.sync();  // every CTA of the row has started before the first DSMEM store

  constexpr int NC = 3 * DX + DY + 1 + (CTRL ? 2 * H : 0);
  int cur = 0;
  for (int t = 0; t < a.T1; ++t) {
    const size_t row = (size_t)t * B + b;
    const StepRow r{a.coef + row * NC,
                    a.use_rng ? nullptr : a.eps + row * DX * K,
                    a.use_rng ? nullptr : a.pos + row * K,
                    a.x_all != nullptr ? a.x_all + row * DX * K : nullptr,
                    a.alpha_all != nullptr ? a.alpha_all + row * K : nullptr,
                    a.idx != nullptr ? a.idx + row * K : nullptr};
    const ClusterOut out{s.xbuf + (cur ^ 1) * DX * K, s.lw + (cur ^ 1) * K, C};
    const float ess =
        filter_step<DX, DY, H, FWD, FP, CTRL>(r, s, s.xbuf + cur * DX * K, s.lw + cur * K, out,
                                              lo, lo + n, K, a.n_mid, a.off_f, a.off_g, sfi,
                                              sgi, a.use_rng, a.seed0, a.seed1, b, t);
    if (rank == 0) row_stats<DX>(out.xn, out.lw, K, ess, s.red, a.stats + row * (2 + DX));
    cur ^= 1;
  }

  // the last step's barrier left the whole row in every CTA: each writes its slice
  const float* xc = s.xbuf + cur * DX * K;
  const float* lc = s.lw + cur * K;
  for (int e = tid; e < DX * n; e += kThreads) {
    const int i = lo + e % n, d = e / n;
    a.x_last[((size_t)b * DX + d) * K + i] = xc[d * K + i];
  }
  for (int i = lo + tid; i < lo + n; i += kThreads) a.alpha_last[(size_t)b * K + i] = lc[i];
}

// K14 step_forward: ONE filtering step, t-1 -> t, per launch.
//
// Replaces psvo_tpu/ops/pallas_step.py::_step_fwd (kernel body _fwd_kernel,
// which runs _fwd_core: the per-step path of SCAN_FUSED = False, one
// pallas_call per step under lax.scan). Its step is K1's filter_step on the
// carry that K1 keeps in shared memory: here x and logw come from device
// memory and x_new, α, the stats and the ancestor indices go back to it, the
// residuals of K15 (scan_backward.cu), which regathers x_res = x[idx]
// instead of storing it. Stream noise only, as the reference's per-step path.
//
// Design. Each row runs on S CTAs with no cluster (step_slices.cuh; the host
// picks S, fused_step.step_slices). Every CTA loads the weights and the
// whole row's x and logw, and computes the ESS and the fp64 CDF over the
// whole row, redundantly, as K1's CTAs do at C > 1, so every slice draws the
// same ancestors; it then runs filter_step's particle loop on its own slice
// and writes that slice's x_new, α and ancestors. The row's last CTA to
// arrive reads the other slices' x_new and α back from L2 into its buffers
// and computes ℓ, the ESS and the filtered mean over the whole row in K1's
// order (row_stats). So every output is bit-equal for every S, and a chain
// of K14 launches gives one K1 launch's bits.
//
// What bounds it. One step of K1's work (~9 MFLOP per row at K=1024 and
// hidden (64, 64)) on B·S CTAs, arithmetic-bound as K1; every CTA also
// copies the weights (54 KB at hidden 64) into shared memory and repeats
// the O(K) CDF, and the launch itself is paid per step. At 220 registers a
// thread (Dx = 2, hidden 64) one CTA fits an SM: B = 32 rows on 32 of the
// card's 132 SMs at S = 1, 128 at S = 4.
struct StepArgs {
  const float* x;        // [B, DX, K]: particles of step t-1
  const float* logw;     // [B, K]: their log-weights
  const float* coef;     // [B, 3*DX + DY + 1 (+ 2H)]: aq, cq, sq, y, ab (, c_q1, c_f) of step t
  const float* eps;      // [B, DX, K]
  const float* pos;      // [B, K] sorted positions
  const float* weights;  // q1 | f | g, fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  float* x_new;          // [B, DX, K]
  float* alpha;          // [B, K]
  float* stats;          // [B, 2 + DX]: ell, ess, filtered mean
  int* idx;              // [B, K]
  int* counter;          // [B]: arrivals per row, 0 between launches
  int B, K, n_mid, n_weights, off_f, off_g;
  int slices;            // S: CTAs per row, K % S == 0
};

template <int DX, int DY, int H, int FWD, int FP, bool CTRL>
__global__ void __launch_bounds__(kThreads) step_forward_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.slices, K = a.K, b = blockIdx.x / S, tid = threadIdx.x;
  const int n = K / S, lo = (blockIdx.x % S) * n;  // this CTA's particles [lo, lo + n)
  const FwdSmem s = carve_fwd<DX, DY, H, FWD, FP>(smem, a.weights, a.n_weights, K);
  const size_t bx = (size_t)b * DX * K, bk = (size_t)b * K;
  if (FWD == kFwdSmem) {
    for (int i = tid; i < a.n_weights; i += kThreads) s.wts[i] = a.weights[i];
  }
  for (int i = tid; i < DX * K; i += kThreads) s.xbuf[i] = a.x[bx + i];
  for (int i = tid; i < K; i += kThreads) s.lw[i] = a.logw[bk + i];
  float sfi[DX], sgi[DY];
#pragma unroll
  for (int d = 0; d < DX; ++d) sfi[d] = a.sconst[d];
#pragma unroll
  for (int e = 0; e < DY; ++e) sgi[e] = a.sconst[DX + e];
  __syncthreads();

  constexpr int NC = 3 * DX + DY + 1 + (CTRL ? 2 * H : 0);
  const StepRow r{a.coef + (size_t)b * NC, a.eps + bx,    a.pos + bk,
                  a.x_new + bx,            a.alpha + bk, a.idx + bk};
  float* xn = s.xbuf + DX * K;
  float* lwn = s.lw + K;
  const float ess = filter_step<DX, DY, H, FWD, FP, CTRL>(r, s, s.xbuf, s.lw, CtaOut{xn, lwn},
                                                          lo, lo + n, K, a.n_mid, a.off_f,
                                                          a.off_g, sfi, sgi, false, 0u, 0u, b, 0);
  if (!last_to_arrive(a.counter + b, S)) return;
  // the row's last CTA: the other slices' x_new and α, then the row's statistics
  for (int i = tid; i < K; i += kThreads) {
    if (i >= lo && i < lo + n) continue;
    lwn[i] = __ldcg(r.alpha_out + i);
#pragma unroll
    for (int d = 0; d < DX; ++d) xn[d * K + i] = __ldcg(r.x_out + d * K + i);
  }
  __syncthreads();
  row_stats<DX>(xn, lwn, K, ess, s.red, a.stats + (size_t)b * (2 + DX));
}

// The launches and occupancy queries of one mode of K1 and K14 (CTRL) at
// an instantiated shape: scan_forward.cu builds K1 with CTRL = false and
// scan_forward_ctrl.cu with CTRL = true, step_forward.cu and
// step_forward_ctrl.cu K14's, so that nvcc compiles the four in parallel.
// Each returns a cudaError_t as an int.
template <bool CTRL>
int scan_forward_launch(const ScanArgs& a, int dx, int dy, int hidden, cudaStream_t s) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return launch_clusters(scan_forward_kernel<D::DX, D::DY, D::H, D::FWD, D::FP, CTRL>, a, a.B,
                           a.cluster,
                           fwd_smem_bytes<D::DX, D::DY, D::H, D::FWD, D::FP>(
                               a.n_weights, a.K, CTRL ? 2 * D::H : 0),
                           s);
  });
}

template <bool CTRL>
int scan_forward_max_active(int dx, int dy, int hidden, int cluster, size_t smem, int* out) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return max_active_clusters(scan_forward_kernel<D::DX, D::DY, D::H, D::FWD, D::FP, CTRL>,
                               cluster, smem, out);
  });
}

template <bool CTRL>
int step_forward_launch(const StepArgs& a, int dx, int dy, int hidden, cudaStream_t s) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return launch_slices(step_forward_kernel<D::DX, D::DY, D::H, D::FWD, D::FP, CTRL>, a, a.B,
                         a.slices,
                         fwd_smem_bytes<D::DX, D::DY, D::H, D::FWD, D::FP>(
                             a.n_weights, a.K, CTRL ? 2 * D::H : 0),
                         s);
  });
}

template <bool CTRL>
int step_forward_resident(int dx, int dy, int hidden, size_t smem, int* out) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return max_resident(step_forward_kernel<D::DX, D::DY, D::H, D::FWD, D::FP, CTRL>, smem, out);
  });
}

// The control builds (CTRL = true), defined in scan_forward_ctrl.cu (K1) and
// step_forward_ctrl.cu (K14).
int scan_forward_launch_ctrl(const ScanArgs& a, int dx, int dy, int hidden, cudaStream_t s);
int scan_forward_max_active_ctrl(int dx, int dy, int hidden, int cluster, size_t smem, int* out);
int step_forward_launch_ctrl(const StepArgs& a, int dx, int dy, int hidden, cudaStream_t s);
int step_forward_resident_ctrl(int dx, int dy, int hidden, size_t smem, int* out);

}  // namespace psvo
