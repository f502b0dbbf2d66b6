// K12 svo_sweep_forward: SVO's backward simulation, t = T-2 .. 0, in one launch.
// K13 svo_sweep_backward: its VJP, t = 0 .. T-2, in one launch, plus a small
// kernel that adds the CTAs' gradient rows in order.
//
// K12 replaces psvo_tpu/ops/pallas_svo.py::_scan_fwd (pallas_call at
// pallas_svo.py:446, kernel body _fwd_kernel); K13 replaces ::_scan_bwd
// (pallas_call at pallas_svo.py:521, body _bwd_kernel). ops/svo.py holds their
// wrappers and plain versions.
//
// The step (per smoothed path; x_next = x~_{t+1}, the anchor at t = T-2):
//   m_b  = qb([x_next; y_t]);   x~_t = m_b + s_b * eps_t
//   lq  += max(-1/2 sum eps_t^2 + c_b, -1e30)
//   lp  += max(-1/2 sum z_f^2 + c_f, -1e30) + max(-1/2 sum z_g^2 + c_g, -1e30)
//   z_f  = (x_next - f(x~_t)) * (1/s_f),   z_g = (y_t - g(x~_t)) * (1/s_g)
// qb, f and g are relu MLPs of one hidden width H (fused_step.prepare's packed
// layout: W1 [din][H], b1, per middle layer Wm [H][H], bm, then W3 [H][dout],
// b3). sc = (1/s_f, 1/s_g, s_b, c_f, c_g, c_b) is computed outside, so that
// autograd there carries its cotangent to the three scales (the TPU kernel's
// sconst operand and d_sm stream).
//
// K12 and K13 each have two designs; the paths run the split designs.
//
// K12's split design (svo_forward_split_kernel) keeps only what is serial on
// the chain: x~_t = qb([x~_{t+1}; y_t]) + s_b*eps_t depends on the step
// before, while f, g and the three density terms read x~_t and x~_{t+1}
// only. A CTA holds P paths (enough CTAs to fill the SMs once), each on H
// threads of its own (two warps at H = 64) that synchronise only among
// themselves: qb's first layer and first middle layer run from weight
// columns held in registers, one hidden unit a thread, the head's four
// partial sums on four lanes. eps and y of a chunk of steps are copied in
// before its chain
// starts. Then f, g and the terms run over the chunk's (t, path) rows as
// register-blocked tile products (K13's split_forward / split_head), and each
// path adds its rows' terms t descending: the chain design's order for every
// value, so its bits.
//
// K12's chain design (svo_forward_kernel, the previous one, kept as its
// yardstick) does the whole step on the chain: a CTA of 256 threads holds
// P = 256/H paths, thread (p, j) owns hidden unit j of path p in every layer
// of qb, f and g, a net's mean is summed by thread o < dout over the H hidden
// units, with a barrier of the CTA after each of eight phases a step.
//
// The split design (svo_backward_split_kernel) takes the VJP apart. Nearly
// all of it is parallel over the (t, path) rows: K12 saved every x~_t, so
// qb's input [x~_{t+1}; y_t] and f's and g's input x~_t are known for every
// row at once, and so are f's and g's density cotangents, their backprop
// into x~_t and the z_f part dxz_t of x~_{t+1}'s cotangent. The only serial
// part is linear: with J_t = d m_b / d x~_{t+1} (Dx x Dx at the row's relu
// masks) and u_t = d_xtilde_t + dfx_t + dgx_t, carry_0 = d_x_first,
// dmb_t = u_t + carry_t, carry_{t+1} = dxz_t + J_t^T dmb_t, d_x_anchor =
// carry_{T-1}. A persistent CTA takes a group of P paths (enough groups to
// fill the SMs once) and walks t ascending in tiles of rows / P steps: per
// tile it recomputes the three trunks with K12's per-unit arithmetic (the
// same relu masks and floor cuts), runs f's and g's VJP, J_t by Dx cotangent
// passes through qb, the recurrence (one thread per path, on the tile's rows
// in shared memory), then qb's VJP from dmb_t; every layer a register-
// blocked product over the tile's rows (4 rows x 4 units a thread, weight
// rows padded to H + 4 floats), the weight sums outer products over the rows
// into the CTA's sums. Nothing is written to device memory between the
// passes.
//
// The chain design (svo_backward_kernel, the previous one, kept as its
// yardstick) keeps the TPU kernel's shape: it walks t ascending from K12's
// saved x~ and carries d x~_{t+1} from step to step (the TPU kernel's dq_c):
// per step it recomputes the three trunks (the same device functions as
// K12), backprops f and g into x~_t, then the draw and qb into x~_{t+1}.
//
// In both the weight gradients need no atomics: each CTA keeps one sum per
// weight in shared memory, owned by one thread, which adds its rows' (chain:
// the step's P paths') outer products in a fixed order; the CTAs write their
// rows to a [CTAs, n_weights + 2*DX + DY + 3] buffer that svo_sum_ctas_kernel
// adds row by row in order: the same bits every launch. The chain design's
// transposed copies of the first and middle layers let thread i read row i of
// a weight matrix without bank conflicts.
//
// What bounds them. Per path-step the forward is 13,632 MACs at Dx = Dy = 3,
// hidden (64, 64): 1.38e9 FLOP per launch at the preset, 0.021 ms at 67
// TFLOP/s; its bytes (eps and x~, 0.6 MB each) take 0.0004 ms. K13's bound
// counts three times that work, 0.062 ms. K12's chain design and K13's are
// latency-bound: each step is eight (K12) or about fourteen (K13) dependent
// phases with a barrier after each, 99 steps long. K12's split design is a
// chain of about 4.6k MACs a step on H threads a path (its length set by
// latency, 99 steps), then 9k MACs a row of f and g from shared memory, its
// products bounding that pass. K13's split design does
// about 53.6k MACs a row (5.4e9 FLOP a launch, the recompute, J_t and the
// weight sums included) in phases as wide as a tile's 64 rows, about 40 a
// tile with a barrier after each: its products from shared memory bound it.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "named_barrier.cuh"

namespace psvo {
namespace svo {

constexpr int kThreads = 256;
constexpr float kMinLogp = -1e30f;  // distributions._MIN_LOGP

struct FwdArgs {
  const float* x_anchor;  // [NP, DX]; NP = B*M paths, path b*M + m
  const float* eps;       // [T1, NP, DX]
  const float* y;         // [T1, B, DY]: y_t of t = 0 .. T-2
  const float* weights;   // qb | f | g
  const float* sc;        // [2*DX + DY + 3]
  float* x_first;         // [NP, DX]: x~_0
  float* lp;              // [NP]
  float* lq;              // [NP]
  float* xtilde;          // [T1, NP, DX]
  int B, M, T1, n_mid, n_weights, off_f, off_g;
};

struct BwdArgs {
  const float* x_anchor;   // [NP, DX]
  const float* eps;        // [T1, NP, DX]
  const float* y;          // [T1, B, DY]
  const float* weights;    // qb | f | g
  const float* sc;         // [2*DX + DY + 3]
  const float* xtilde;     // [T1, NP, DX]: K12's
  const float* d_x_first;  // [NP, DX] or null
  const float* d_lp;       // [NP] or null
  const float* d_lq;       // [NP] or null
  const float* d_xtilde;   // [T1, NP, DX] or null
  float* d_x_anchor;       // [NP, DX]
  float* partial;          // [CTAs, n_weights + 2*DX + DY + 3]
  int B, M, T1, n_mid, n_weights, off_f, off_g;
};

// Offsets inside one net's packed segment (din inputs, width H, dout outputs).
__host__ __device__ constexpr int mid_off(int din, int h, int l) {  // layer l >= 1
  return din * h + h + (l - 1) * (h * h + h);
}
__host__ __device__ constexpr int head_off(int din, int h, int n_mid) {
  return din * h + h + n_mid * (h * h + h);
}

// Hidden unit j of a relu layer: relu(b[j] + sum_{i<RI} w[i][j] in[i]), w [RI][H]
// row-major and b right after it; four partial sums in a fixed order.
template <int RI, int H>
__device__ __forceinline__ float hidden_unit(const float* __restrict__ w,
                                             const float* __restrict__ in, int j) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < RI; ++i) s[i & 3] = fmaf(w[i * H + j], in[i], s[i & 3]);
  const float v = w[RI * H + j] + ((s[0] + s[1]) + (s[2] + s[3]));
  return v < 0.0f ? 0.0f : v;
}

// Output o of a net's mean: b3[o] + sum_j h[j] W3[j][o].
template <int H, int DOUT>
__device__ __forceinline__ float head_unit(const float* __restrict__ w3,
                                           const float* __restrict__ h, int o) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < H; ++j) s[j & 3] = fmaf(h[j], w3[j * DOUT + o], s[j & 3]);
  return w3[H * DOUT + o] + ((s[0] + s[1]) + (s[2] + s[3]));
}

// sum_o wt[o][i] c[o] over RO (wt [RO][RI], a transposed weight matrix).
template <int RI, int RO>
__device__ __forceinline__ float back_unit(const float* __restrict__ wt,
                                           const float* __restrict__ c, int i) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int o = 0; o < RO; ++o) s[o & 3] = fmaf(wt[o * RI + i], c[o], s[o & 3]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The cotangent of the last hidden unit j from the mean's cotangent dm.
template <int H, int DOUT>
__device__ __forceinline__ float head_back(const float* __restrict__ w3,
                                           const float* __restrict__ dm, int j) {
  float s = 0.0f;
#pragma unroll
  for (int o = 0; o < DOUT; ++o) s = fmaf(w3[j * DOUT + o], dm[o], s);
  return s;
}

__device__ __forceinline__ float relu_cut(float h, float c) { return h <= 0.0f ? 0.0f : c; }
__device__ __forceinline__ float floor_logp(float v) { return v < kMinLogp ? kMinLogp : v; }

// The three unfloored density terms of a step, each rounded step by step in
// d order: tf = -1/2 sum z_f^2 + c_f, tg likewise, tb = -1/2 sum eps^2 + c_b.
// z_f and z_g are written out. K12 and K13 share it, so K13 cuts exactly
// the terms K12 floored.
template <int DX, int DY>
__device__ __forceinline__ void step_terms(const float* xn, const float* mf, const float* y,
                                           const float* mg, const float* e, const float* sc,
                                           float* zf, float* zg, float& tf, float& tg,
                                           float& tb) {
  float sf = 0.0f, sg = 0.0f, se = 0.0f;
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    zf[d] = __fmul_rn(__fsub_rn(xn[d], mf[d]), sc[d]);
    sf = __fadd_rn(sf, __fmul_rn(zf[d], zf[d]));
    se = __fadd_rn(se, __fmul_rn(e[d], e[d]));
  }
#pragma unroll
  for (int q = 0; q < DY; ++q) {
    zg[q] = __fmul_rn(__fsub_rn(y[q], mg[q]), sc[DX + q]);
    sg = __fadd_rn(sg, __fmul_rn(zg[q], zg[q]));
  }
  const int c0 = 2 * DX + DY;
  tf = __fadd_rn(__fmul_rn(-0.5f, sf), sc[c0]);
  tg = __fadd_rn(__fmul_rn(-0.5f, sg), sc[c0 + 1]);
  tb = __fadd_rn(__fmul_rn(-0.5f, se), sc[c0 + 2]);
}

// Per-path shared-memory slots of K12 (floats from the path's base; small
// vectors get 8 floats).
constexpr int kFQin = 0, kFXt = 8, kFEp = 16, kFMf = 24, kFMg = 32, kFHid = 40;

template <int DX, int DY, int H>
__global__ void __launch_bounds__(kThreads) svo_forward_kernel(const FwdArgs a) {
  constexpr int P = kThreads / H;
  constexpr int DQ = DX + DY;
  extern __shared__ __align__(16) float smem[];
  const int n_mid = a.n_mid, L = (n_mid + 1) * H, S = kFHid + 3 * L;
  const int tid = threadIdx.x, p = tid / H, j = tid % H;
  float* w = smem;
  float* buf = w + a.n_weights + p * S;
  float *qin = buf + kFQin, *xt = buf + kFXt, *ep = buf + kFEp, *mf = buf + kFMf,
        *mg = buf + kFMg;
  float *hq = buf + kFHid, *hf = hq + L, *hg = hf + L;
  const float* wq = w;
  const float* wf = w + a.off_f;
  const float* wg = w + a.off_g;
  const int NP = a.B * a.M;
  const int path = blockIdx.x * P + p;
  const bool live = path < NP;
  const int b = live ? path / a.M : 0;

  for (int i = tid; i < a.n_weights / 4; i += kThreads) {
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(a.weights)[i];
  }
  if (j < DX) qin[j] = live ? a.x_anchor[(size_t)path * DX + j] : 0.0f;
  float lp = 0.0f, lq = 0.0f;  // thread j == 0 of each path

  for (int t = a.T1 - 1; t >= 0; --t) {
    if (j < DY) qin[DX + j] = a.y[((size_t)t * a.B + b) * DY + j];
    if (j < DX) ep[j] = live ? a.eps[((size_t)t * NP + path) * DX + j] : 0.0f;
    __syncthreads();
    // q_b on [x_next; y_t], then the draw
    hq[j] = hidden_unit<DQ, H>(wq, qin, j);
    __syncthreads();
    for (int l = 1; l <= n_mid; ++l) {
      hq[l * H + j] = hidden_unit<H, H>(wq + mid_off(DQ, H, l), hq + (l - 1) * H, j);
      __syncthreads();
    }
    if (j < DX) {
      const float mb = head_unit<H, DX>(wq + head_off(DQ, H, n_mid), hq + n_mid * H, j);
      const float x = __fadd_rn(mb, __fmul_rn(a.sc[DQ + j], ep[j]));
      xt[j] = x;
      if (live) a.xtilde[((size_t)t * NP + path) * DX + j] = x;
    }
    __syncthreads();
    // f and g on x~_t
    hf[j] = hidden_unit<DX, H>(wf, xt, j);
    hg[j] = hidden_unit<DX, H>(wg, xt, j);
    __syncthreads();
    for (int l = 1; l <= n_mid; ++l) {
      hf[l * H + j] = hidden_unit<H, H>(wf + mid_off(DX, H, l), hf + (l - 1) * H, j);
      hg[l * H + j] = hidden_unit<H, H>(wg + mid_off(DX, H, l), hg + (l - 1) * H, j);
      __syncthreads();
    }
    if (j < DX) {
      mf[j] = head_unit<H, DX>(wf + head_off(DX, H, n_mid), hf + n_mid * H, j);
    } else if (j < DQ) {
      mg[j - DX] = head_unit<H, DY>(wg + head_off(DX, H, n_mid), hg + n_mid * H, j - DX);
    }
    __syncthreads();
    if (j == 0) {
      float zf[DX], zg[DY], tf, tg, tb;
      step_terms<DX, DY>(qin, mf, qin + DX, mg, ep, a.sc, zf, zg, tf, tg, tb);
      lp += floor_logp(tf) + floor_logp(tg);
      lq += floor_logp(tb);
    }
    __syncthreads();  // thread 0 is done with qin and ep
    if (j < DX) qin[j] = xt[j];  // x~_t is the next step's query
  }
  if (live) {
    if (j == 0) {
      a.lp[path] = lp;
      a.lq[path] = lq;
    }
    if (j < DX) a.x_first[(size_t)path * DX + j] = xt[j];
  }
}

// Per-path shared-memory slots of K13.
constexpr int kBQin = 0, kBXt = 8, kBEp = 16, kBDmf = 24, kBDmg = 32, kBDmb = 40, kBDxz = 48,
              kBCarry = 56, kBSg = 64, kBHid = 80;

// g[i][o] += sum_p a_p[i] c_p[o] and g[RI*RO + o] += sum_p c_p[o] over the
// n_act live path slots in order; slot p's vectors at a0 + p*S and c0 + p*S.
// Every entry has one owning thread.
template <int RI, int RO>
__device__ __forceinline__ void layer_grads(const float* a0, const float* c0, int S, int n_act,
                                            float* g) {
  for (int e = threadIdx.x; e < RI * RO; e += kThreads) {
    const int i = e / RO, o = e % RO;
    float s = 0.0f;
    for (int p = 0; p < n_act; ++p) s = fmaf(a0[p * S + i], c0[p * S + o], s);
    g[e] += s;
  }
  for (int o = threadIdx.x; o < RO; o += kThreads) {
    float s = 0.0f;
    for (int p = 0; p < n_act; ++p) s += c0[p * S + o];
    g[RI * RO + o] += s;
  }
}

// One net's weight gradients for this step: input in, hidden activations h,
// their pre-activation cotangents c, the mean's cotangent dm (slot-0 pointers).
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void net_grads(const float* in, const float* h, const float* c,
                                          const float* dm, int S, int n_act, int n_mid,
                                          float* g) {
  layer_grads<DIN, H>(in, c, S, n_act, g);
  for (int l = 1; l <= n_mid; ++l) {
    layer_grads<H, H>(h + (l - 1) * H, c + l * H, S, n_act, g + mid_off(DIN, H, l));
  }
  layer_grads<H, DOUT>(h + n_mid * H, dm, S, n_act, g + head_off(DIN, H, n_mid));
}

// Copy one net's first and middle layers transposed: wt1 [H][DIN], wt_l [H][H].
template <int DIN, int H>
__device__ __forceinline__ void transpose_net(const float* __restrict__ w, int n_mid,
                                              float* wt) {
  for (int e = threadIdx.x; e < DIN * H; e += kThreads) {
    wt[(e % H) * DIN + e / H] = w[e];
  }
  for (int l = 1; l <= n_mid; ++l) {
    const float* src = w + mid_off(DIN, H, l);
    float* dst = wt + DIN * H + (l - 1) * H * H;
    for (int e = threadIdx.x; e < H * H; e += kThreads) dst[(e % H) * H + e / H] = src[e];
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <int DX, int DY, int H>
__global__ void __launch_bounds__(kThreads, 1) svo_backward_kernel(const BwdArgs a) {
  constexpr int P = kThreads / H;
  constexpr int DQ = DX + DY;
  constexpr int NS = 2 * DX + DY + 3;
  extern __shared__ __align__(16) float smem[];
  const int n_mid = a.n_mid, L = (n_mid + 1) * H, S = kBHid + 6 * L;
  const int nt_q = DQ * H + n_mid * H * H, nt_x = DX * H + n_mid * H * H;
  const int n_row = a.n_weights + NS;
  const int tid = threadIdx.x, p = tid / H, j = tid % H;
  float* w = smem;                                   // [n_weights]
  float* wtq = w + a.n_weights;                      // transposed layers of qb, f, g
  float* wtf = wtq + nt_q;
  float* wtg = wtf + nt_x;
  float* gsum = w + a.n_weights + round4(nt_q + 2 * nt_x);  // [n_row]: this CTA's sums
  float* base = gsum + round4(n_row);                // slot 0's buffers
  float* buf = base + p * S;
  float *qin = buf + kBQin, *xt = buf + kBXt, *ep = buf + kBEp, *dmf = buf + kBDmf,
        *dmg = buf + kBDmg, *dmb = buf + kBDmb, *dxz = buf + kBDxz, *carry = buf + kBCarry,
        *sg = buf + kBSg;
  float *hq = buf + kBHid, *hf = hq + L, *hg = hf + L;
  float *cq = hg + L, *cf = cq + L, *cg = cf + L;
  const float* wq = w;
  const float* wf = w + a.off_f;
  const float* wg = w + a.off_g;
  const int NP = a.B * a.M;
  const int groups = (NP + P - 1) / P;

  for (int i = tid; i < a.n_weights / 4; i += kThreads) {
    reinterpret_cast<float4*>(w)[i] = reinterpret_cast<const float4*>(a.weights)[i];
  }
  for (int i = tid; i < n_row; i += kThreads) gsum[i] = 0.0f;
  __syncthreads();
  transpose_net<DQ, H>(wq, n_mid, wtq);
  transpose_net<DX, H>(wf, n_mid, wtf);
  transpose_net<DX, H>(wg, n_mid, wtg);

  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int path = grp * P + p;
    const bool live = path < NP;
    const int b = live ? path / a.M : 0;
    const int n_act = NP - grp * P < P ? NP - grp * P : P;
    const float d_lp = live && a.d_lp != nullptr ? a.d_lp[path] : 0.0f;
    const float d_lq = live && a.d_lq != nullptr ? a.d_lq[path] : 0.0f;
    for (int t = 0; t < a.T1; ++t) {
      // 0. the step's operands: x_next, y_t, x~_t, eps_t
      const size_t at = ((size_t)t * NP + path) * DX;
      if (j < DX) {
        float xn = 0.0f, x = 0.0f, e = 0.0f;
        if (live) {
          xn = t == a.T1 - 1 ? a.x_anchor[(size_t)path * DX + j] : a.xtilde[at + NP * DX + j];
          x = a.xtilde[at + j];
          e = a.eps[at + j];
        }
        qin[j] = xn;
        xt[j] = x;
        ep[j] = e;
      }
      if (j < DY) qin[DX + j] = a.y[((size_t)t * a.B + b) * DY + j];
      __syncthreads();
      // 1. recompute the hidden layers of qb, f and g (K12's functions)
      hq[j] = hidden_unit<DQ, H>(wq, qin, j);
      hf[j] = hidden_unit<DX, H>(wf, xt, j);
      hg[j] = hidden_unit<DX, H>(wg, xt, j);
      __syncthreads();
      for (int l = 1; l <= n_mid; ++l) {
        hq[l * H + j] = hidden_unit<H, H>(wq + mid_off(DQ, H, l), hq + (l - 1) * H, j);
        hf[l * H + j] = hidden_unit<H, H>(wf + mid_off(DX, H, l), hf + (l - 1) * H, j);
        hg[l * H + j] = hidden_unit<H, H>(wg + mid_off(DX, H, l), hg + (l - 1) * H, j);
        __syncthreads();
      }
      // 2. the means of f and g, into their cotangents' slots for now
      if (j < DX) {
        dmf[j] = head_unit<H, DX>(wf + head_off(DX, H, n_mid), hf + n_mid * H, j);
      } else if (j < DQ) {
        dmg[j - DX] = head_unit<H, DY>(wg + head_off(DX, H, n_mid), hg + n_mid * H, j - DX);
      }
      __syncthreads();
      // 3. the density terms' cotangents, cut where the term was floored
      if (j == 0) {
        float zf[DX], zg[DY], tf, tg, tb;
        step_terms<DX, DY>(qin, dmf, qin + DX, dmg, ep, a.sc, zf, zg, tf, tg, tb);
        const float dlf = tf < kMinLogp ? 0.0f : d_lp;
        const float dlg = tg < kMinLogp ? 0.0f : d_lp;
        const float dlb = tb < kMinLogp ? 0.0f : d_lq;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          const float dz = -dlf * zf[d], r = qin[d] - dmf[d];
          dmf[d] = -dz * a.sc[d];
          dxz[d] = dz * a.sc[d];
          sg[d] = dz * r;
        }
#pragma unroll
        for (int q = 0; q < DY; ++q) {
          const float dz = -dlg * zg[q], r = qin[DX + q] - dmg[q];
          dmg[q] = -dz * a.sc[DX + q];
          sg[DX + q] = dz * r;
        }
        sg[2 * DX + DY] = dlf;
        sg[2 * DX + DY + 1] = dlg;
        sg[2 * DX + DY + 2] = dlb;
      }
      __syncthreads();
      // 4. backprop f and g to their first hidden layer
      cf[n_mid * H + j] =
          relu_cut(hf[n_mid * H + j], head_back<H, DX>(wf + head_off(DX, H, n_mid), dmf, j));
      cg[n_mid * H + j] =
          relu_cut(hg[n_mid * H + j], head_back<H, DY>(wg + head_off(DX, H, n_mid), dmg, j));
      __syncthreads();
      for (int l = n_mid; l >= 1; --l) {
        const int below = (l - 1) * H;
        cf[below + j] = relu_cut(hf[below + j],
                                 back_unit<H, H>(wtf + DX * H + (l - 1) * H * H, cf + l * H, j));
        cg[below + j] = relu_cut(hg[below + j],
                                 back_unit<H, H>(wtg + DX * H + (l - 1) * H * H, cg + l * H, j));
        __syncthreads();
      }
      // 5. d x~_t: its own cotangent, the carry (d_x_first at t = 0), f's and g's
      if (j < DX) {
        const float dfx = back_unit<DX, H>(wtf, cf, j);
        const float dgx = back_unit<DX, H>(wtg, cg, j);
        float dx = live && a.d_xtilde != nullptr ? a.d_xtilde[at + j] : 0.0f;
        if (t == 0) {
          dx += live && a.d_x_first != nullptr ? a.d_x_first[(size_t)path * DX + j] : 0.0f;
        } else {
          dx += carry[j];
        }
        dx += dfx;
        dx += dgx;
        dmb[j] = dx;
        sg[DQ + j] = dx * ep[j];  // d s_b
      }
      __syncthreads();
      // 6. backprop the draw's mean through qb
      cq[n_mid * H + j] =
          relu_cut(hq[n_mid * H + j], head_back<H, DX>(wq + head_off(DQ, H, n_mid), dmb, j));
      __syncthreads();
      for (int l = n_mid; l >= 1; --l) {
        const int below = (l - 1) * H;
        cq[below + j] = relu_cut(hq[below + j],
                                 back_unit<H, H>(wtq + DQ * H + (l - 1) * H * H, cq + l * H, j));
        __syncthreads();
      }
      // 7. d x~_{t+1} = the z_f part + qb's input cotangent (y's part dropped)
      if (j < DX) {
        const float c = dxz[j] + back_unit<DQ, H>(wtq, cq, j);
        carry[j] = c;
        if (t == a.T1 - 1 && live) a.d_x_anchor[(size_t)path * DX + j] = c;
      }
      // 8. this step's weight and sc gradients, added in path order
      net_grads<DQ, H, DX>(base + kBQin, base + kBHid, base + kBHid + 3 * L, base + kBDmb, S,
                           n_act, n_mid, gsum);
      net_grads<DX, H, DX>(base + kBXt, base + kBHid + L, base + kBHid + 4 * L, base + kBDmf, S,
                           n_act, n_mid, gsum + a.off_f);
      net_grads<DX, H, DY>(base + kBXt, base + kBHid + 2 * L, base + kBHid + 5 * L,
                           base + kBDmg, S, n_act, n_mid, gsum + a.off_g);
      for (int e = tid; e < NS; e += kThreads) {
        float s = 0.0f;
        for (int q = 0; q < n_act; ++q) s += base[q * S + kBSg + e];
        gsum[a.n_weights + e] += s;
      }
      __syncthreads();
    }
  }
  float* row = a.partial + (size_t)blockIdx.x * n_row;
  for (int i = tid; i < n_row; i += kThreads) row[i] = gsum[i];
}

// out[e] = sum_r partial[r][e], the CTA rows added in order.
__global__ void svo_sum_ctas_kernel(const float* __restrict__ partial, int rows, int n,
                                    float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * n + e];
  out[e] = s;
}

// ---------------------------------------------------------------------------
// K13, design "split": the VJP as parallel passes around a Dx-wide recurrence
// ---------------------------------------------------------------------------

constexpr int kRowFloats = 56;  // per tile row: qin 8, xt, ep, dmn, ux, dxz, dmb 4 each, jac 12, sg 12

// One net's weights in the split design's shared memory: fused_step.prepare's
// layout with every row of a matrix whose output width is H padded to H + 4
// floats (a warp's strided rows then fall in distinct banks).
template <int DIN, int H, int DOUT>
struct Padded {
  static constexpr int WS = H + 4;
  __host__ __device__ static constexpr int mid(int l) {  // layer l >= 1; mid(n_mid + 1) = head
    return DIN * WS + H + (l - 1) * (H * WS + H);
  }
  __host__ __device__ static constexpr int floats(int n_mid) {
    return round4(mid(n_mid + 1) + H * DOUT + DOUT);
  }
};

// Copy one net from the packed layout (src) into the padded one (dst), pads zeroed.
template <int DIN, int H, int DOUT>
__device__ void stage_padded(const float* __restrict__ src, int n_mid, float* __restrict__ dst) {
  using N = Padded<DIN, H, DOUT>;
  constexpr int WS = N::WS;
  const int head = N::mid(n_mid + 1), n = N::floats(n_mid);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float v = 0.0f;
    if (e < head) {
      const int l = e < N::mid(1) ? 0 : (e - N::mid(1)) / (H * WS + H) + 1;
      const int rel = l == 0 ? e : e - N::mid(l);
      const int rows = l == 0 ? DIN : H;
      const int base = l == 0 ? 0 : mid_off(DIN, H, l);
      if (rel < rows * WS) {
        if (rel % WS < H) v = src[base + (rel / WS) * H + rel % WS];
      } else {
        v = src[base + rows * H + rel - rows * WS];  // the layer's bias
      }
    } else if (e - head < H * DOUT + DOUT) {
      v = src[head_off(DIN, H, n_mid) + e - head];
    }
    dst[e] = v;
  }
}

// out[r][j] = relu(b[j] + sum_i w[i][j] in[r][i]) for the nr rows of a tile:
// K12's hidden_unit per output (four partial sums by i mod 4, one fmaf per
// term, added bias + ((s0 + s1) + (s2 + s3))), so the relu masks are K12's.
// w is [RI][H + 4] then b [H]; in has a row stride of is floats, out of H + 4.
// A thread owns a block of 4 rows x 4 units.
template <int RI, int H>
__device__ __forceinline__ void split_forward(const float* __restrict__ w,
                                              const float* __restrict__ in, int is,
                                              float* __restrict__ out, int nr) {
  constexpr int WS = H + 4, JB = H / 4;
  for (int blk = threadIdx.x; blk < (nr / 4) * JB; blk += kThreads) {
    const int r0 = (blk / JB) * 4, j0 = (blk % JB) * 4;
    float s[4][4][4];  // [i & 3][row][unit]
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[k][q][c] = 0.0f;
    if constexpr (RI % 4 == 0) {
#pragma unroll 2
      for (int i = 0; i < RI; i += 4) {
        float x[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(in + (r0 + q) * is + i);
          x[q][0] = v.x;
          x[q][1] = v.y;
          x[q][2] = v.z;
          x[q][3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 wv = *reinterpret_cast<const float4*>(w + (i + k) * WS + j0);
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[k][q][c] = fmaf(wc[c], x[q][k], s[k][q][c]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float4 wv = *reinterpret_cast<const float4*>(w + i * WS + j0);
        const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = in[(r0 + q) * is + i];
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i & 3][q][c] = fmaf(wc[c], x, s[i & 3][q][c]);
        }
      }
    }
    const float4 bv = *reinterpret_cast<const float4*>(w + RI * WS + j0);
    const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = bc[c] + ((s[0][q][c] + s[1][q][c]) + (s[2][q][c] + s[3][q][c]));
        v[c] = v[c] < 0.0f ? 0.0f : v[c];
      }
      *reinterpret_cast<float4*>(out + (r0 + q) * WS + j0) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// m[r][o] = b3[o] + sum_j h[r][j] W3[j][o]: K12's head_unit per output.
template <int H, int DOUT>
__device__ __forceinline__ void split_head(const float* __restrict__ w3,
                                           const float* __restrict__ h, float* __restrict__ m,
                                           int nr) {
  constexpr int WS = H + 4;
  for (int e = threadIdx.x; e < nr * DOUT; e += kThreads) {
    const int r = e / DOUT, o = e % DOUT;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h + r * WS + j);
      s[0] = fmaf(hv.x, w3[j * DOUT + o], s[0]);
      s[1] = fmaf(hv.y, w3[(j + 1) * DOUT + o], s[1]);
      s[2] = fmaf(hv.z, w3[(j + 2) * DOUT + o], s[2]);
      s[3] = fmaf(hv.w, w3[(j + 3) * DOUT + o], s[3]);
    }
    m[r * 4 + o] = w3[H * DOUT + o] + ((s[0] + s[1]) + (s[2] + s[3]));
  }
}

// g[i][j] += sum_r a[r][i] c[r][j] and g[RI*H + j] += sum_r c[r][j] over the
// nr rows in order (g in the packed layout, [RI][H] then the bias). A thread
// owns a block of 4 i x 4 j; a row stride of as floats, c's of H + 4.
template <int RI, int H>
__device__ __forceinline__ void split_grads(const float* __restrict__ a, int as,
                                            const float* __restrict__ c, int nr,
                                            float* __restrict__ g) {
  constexpr int WS = H + 4, IB = (RI + 3) / 4, JB = H / 4;
  for (int blk = threadIdx.x; blk < IB * JB; blk += kThreads) {
    const int i0 = (blk / JB) * 4, j0 = (blk % JB) * 4;
    float acc[4][4], bs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[k][q] = 0.0f;
    for (int r = 0; r < nr; ++r) {
      const float4 cv = *reinterpret_cast<const float4*>(c + r * WS + j0);
      const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
      float x[4];
      if constexpr (RI % 4 == 0) {
        const float4 v = *reinterpret_cast<const float4*>(a + r * as + i0);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[k] = i0 + k < RI ? a[r * as + i0 + k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] = fmaf(x[k], cc[q], acc[k][q]);
      if (i0 == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) bs[q] += cc[q];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i0 + k < RI) {
        float4* gp = reinterpret_cast<float4*>(g + (i0 + k) * H + j0);
        const float4 v = *gp;
        *gp = make_float4(v.x + acc[k][0], v.y + acc[k][1], v.z + acc[k][2], v.w + acc[k][3]);
      }
    }
    if (i0 == 0) {
      float4* gp = reinterpret_cast<float4*>(g + RI * H + j0);
      const float4 v = *gp;
      *gp = make_float4(v.x + bs[0], v.y + bs[1], v.z + bs[2], v.w + bs[3]);
    }
  }
}

// The head's sums: g[j][o] += sum_r h[r][j] dm[r][o], g[H*DOUT + o] += sum_r dm[r][o].
template <int H, int DOUT>
__device__ __forceinline__ void split_head_grads(const float* __restrict__ h,
                                                 const float* __restrict__ dm, int nr,
                                                 float* __restrict__ g) {
  constexpr int WS = H + 4;
  for (int e = threadIdx.x; e < H * DOUT + DOUT; e += kThreads) {
    float s = 0.0f;
    if (e < H * DOUT) {
      const int j = e / DOUT, o = e % DOUT;
      for (int r = 0; r < nr; ++r) s = fmaf(h[r * WS + j], dm[r * 4 + o], s);
    } else {
      for (int r = 0; r < nr; ++r) s += dm[r * 4 + e - H * DOUT];
    }
    g[e] += s;
  }
}

// acc[q][k] = sum_o w[i][o] cout[r0 + q][o] with i = ib + k*H/4 (strided, so
// that a quarter-warp's weight rows fall in distinct banks): a thread's block
// of the cotangent of a layer's input. Returns false for a thread with no block.
template <int H>
__device__ __forceinline__ bool split_back_block(const float* __restrict__ w,
                                                 const float* __restrict__ cout, int nr,
                                                 float (&acc)[4][4], int& r0, int& ib) {
  constexpr int WS = H + 4, IB = H / 4;
  const int blk = threadIdx.x;
  if (blk >= (nr / 4) * IB) return false;
  r0 = (blk / IB) * 4;
  ib = blk % IB;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[q][k] = 0.0f;
#pragma unroll 4
  for (int o = 0; o < H; o += 4) {
    float4 cv[4], wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) cv[q] = *reinterpret_cast<const float4*>(cout + (r0 + q) * WS + o);
#pragma unroll
    for (int k = 0; k < 4; ++k) wv[k] = *reinterpret_cast<const float4*>(w + (ib + k * IB) * WS + o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float s = acc[q][k];
        s = fmaf(wv[k].x, cv[q].x, s);
        s = fmaf(wv[k].y, cv[q].y, s);
        s = fmaf(wv[k].z, cv[q].z, s);
        acc[q][k] = fmaf(wv[k].w, cv[q].w, s);
      }
  }
  return true;
}

// Write a block from split_back_block into dst (row stride H + 4) as
// relu_cut(mask, acc), mask read at the same place in mask_src.
template <int H>
__device__ __forceinline__ void split_put_block(const float (&acc)[4][4], int r0, int ib,
                                                const float* mask_src, float* dst) {
  constexpr int WS = H + 4, IB = H / 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int at = (r0 + q) * WS + ib + k * IB;
      dst[at] = relu_cut(mask_src[at], acc[q][k]);
    }
}

// sum_j w[j] v[j] over H (both 16-byte aligned), in one fixed order.
template <int H>
__device__ __forceinline__ float split_dot(const float* __restrict__ w, const float* __restrict__ v) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < H; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(w + j);
    const float4 b = *reinterpret_cast<const float4*>(v + j);
    s[0] = fmaf(a.x, b.x, s[0]);
    s[1] = fmaf(a.y, b.y, s[1]);
    s[2] = fmaf(a.z, b.z, s[2]);
    s[3] = fmaf(a.w, b.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// A net's hidden layers (K12's arithmetic) into A [n_mid + 1][rows][H + 4] and
// its mean into m [rows][4].
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void split_net_forward(const float* w, const float* in, int is,
                                                  float* A, int rows, int n_mid, float* m,
                                                  int nr) {
  using N = Padded<DIN, H, DOUT>;
  constexpr int WS = H + 4;
  split_forward<DIN, H>(w, in, is, A, nr);
  __syncthreads();
  for (int l = 1; l <= n_mid; ++l) {
    split_forward<H, H>(w + N::mid(l), A + (l - 1) * rows * WS, WS, A + l * rows * WS, nr);
    __syncthreads();
  }
  split_head<H, DOUT>(w + N::mid(n_mid + 1), A + n_mid * rows * WS, m, nr);
  __syncthreads();
}

// A net's VJP from its mean's cotangent dm [rows][4]: its weight sums into g
// (packed layout), the last layer's pre-activation cotangent into X [rows][H
// + 4] (in the same phase as the head's sums), the others in place of A's
// hidden layers, and with TO_X the input cotangent sum_j W1[i][j] c_1[r][j]
// added to ux [rows][4] (i < DIN).
template <int DIN, int H, int DOUT, bool TO_X>
__device__ __forceinline__ void split_net_backward(const float* w, float* A, int rows, int n_mid,
                                                   const float* a_in, int as, const float* dm,
                                                   float* g, float* X, float* ux, int nr) {
  using N = Padded<DIN, H, DOUT>;
  constexpr int WS = H + 4;
  const float* hl = A + n_mid * rows * WS;
  const float* w3 = w + N::mid(n_mid + 1);
  split_head_grads<H, DOUT>(hl, dm, nr, g + head_off(DIN, H, n_mid));
  for (int e = threadIdx.x; e < nr * H; e += kThreads) {
    const int r = e / H, j = e % H;
    float s = 0.0f;
#pragma unroll
    for (int o = 0; o < DOUT; ++o) s = fmaf(w3[j * DOUT + o], dm[r * 4 + o], s);
    X[r * WS + j] = relu_cut(hl[r * WS + j], s);
  }
  __syncthreads();
  for (int l = n_mid; l >= 1; --l) {
    float* below = A + (l - 1) * rows * WS;
    const float* above = l == n_mid ? X : A + l * rows * WS;
    split_grads<H, H>(below, WS, above, nr, g + mid_off(DIN, H, l));
    float acc[4][4];
    int r0 = 0, ib = 0;
    const bool mine = split_back_block<H>(w + N::mid(l), above, nr, acc, r0, ib);
    __syncthreads();
    if (mine) split_put_block<H>(acc, r0, ib, below, below);
    __syncthreads();
  }
  const float* c1 = n_mid == 0 ? X : A;
  split_grads<DIN, H>(a_in, as, c1, nr, g);
  if constexpr (TO_X) {
    for (int e = threadIdx.x; e < nr * DIN; e += kThreads) {
      const int r = e / DIN, i = e % DIN;
      ux[r * 4 + i] += split_dot<H>(w + i * WS, c1 + r * WS);
    }
  }
  __syncthreads();
}

// J[r][o][i] = d m_b[o] / d x_next[i] at the tile's relu masks (in AQ), by DX
// cotangent passes through qb, one after the other; X [rows][H + 4] is
// scratch. (The DX passes side by side, one barrier a layer for all of them,
// were slower on the H100; PERF.md.)
template <int DQ, int H, int DX>
__device__ __forceinline__ void split_jacobian(const float* wq, const float* AQ, int rows,
                                               int n_mid, float* X, float* jac, int nr) {
  using N = Padded<DQ, H, DX>;
  constexpr int WS = H + 4;
  const float* hl = AQ + n_mid * rows * WS;
  const float* w3 = wq + N::mid(n_mid + 1);
  for (int o = 0; o < DX; ++o) {
    for (int e = threadIdx.x; e < nr * H; e += kThreads) {
      const int r = e / H, j = e % H;
      X[r * WS + j] = relu_cut(hl[r * WS + j], w3[j * DX + o]);
    }
    __syncthreads();
    for (int l = n_mid; l >= 1; --l) {
      float acc[4][4];
      int r0 = 0, ib = 0;
      const bool mine = split_back_block<H>(wq + N::mid(l), X, nr, acc, r0, ib);
      __syncthreads();
      if (mine) split_put_block<H>(acc, r0, ib, AQ + (l - 1) * rows * WS, X);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < nr * DX; e += kThreads) {
      const int r = e / DX, i = e % DX;
      jac[r * 12 + o * DX + i] = split_dot<H>(wq + i * WS, X + r * WS);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of the split design, in floats.
template <int DX, int DY, int H>
__host__ __device__ constexpr int split_smem_floats(int n_mid, int n_weights, int rows) {
  return Padded<DX + DY, H, DX>::floats(n_mid) + Padded<DX, H, DX>::floats(n_mid) +
         Padded<DX, H, DY>::floats(n_mid) + round4(n_weights + 2 * DX + DY + 3) +
         (2 * (n_mid + 1) + 1) * rows * (H + 4) + kRowFloats * rows;
}

// The split design. Rows are (t, path) pairs. A CTA takes a group of P paths
// and walks t ascending in tiles of CH = rows / P steps (tile row c*P + p is
// step t0 + c of path p), so the carry's recurrence stays inside the CTA.
// Per tile, every phase parallel over the tile's rows but step 5:
//   1. qb's hidden layers on [x~_{t+1}; y_t] (K12's arithmetic, masks and all);
//   2. f on x~_t, its density term's cotangents (cut where K12 floored the
//      term), f's VJP: the f weight sums and dfx; the z_f part dxz of the
//      carry; the noise term's cut;
//   3. the same for g (dgx), in f's buffers;
//   4. J_t = d m_b / d x~_{t+1} by Dx cotangent passes through qb;
//   5. one thread per path: dmb_t = u_t + carry_t with u_t = d_xtilde_t +
//      dfx_t + dgx_t, carry_{t+1} = dxz_t + J_t^T dmb_t (carry_0 =
//      d_x_first; the last carry is d_x_anchor);
//   6. qb's VJP from dmb_t: the qb weight sums and d s_b = dmb . eps;
//   7. the tile's sc sums.
// Every sum has one owning thread and a fixed order (rows ascending within a
// tile, tiles in order); the CTAs' rows go to svo_sum_ctas_kernel as in the
// chain design.
template <int DX, int DY, int H>
__global__ void __launch_bounds__(kThreads, 1) svo_backward_split_kernel(const BwdArgs a, int rows,
                                                                         int P) {
  constexpr int DQ = DX + DY, NS = 2 * DX + DY + 3, WS = H + 4, c0 = 2 * DX + DY;
  using NQ = Padded<DQ, H, DX>;
  using NF = Padded<DX, H, DX>;
  using NG = Padded<DX, H, DY>;
  extern __shared__ __align__(16) float smem[];
  const int n_mid = a.n_mid, L = n_mid + 1, n_row = a.n_weights + NS;
  const int tid = threadIdx.x;
  float* wq = smem;
  float* wf = wq + NQ::floats(n_mid);
  float* wg = wf + NF::floats(n_mid);
  float* gsum = wg + NG::floats(n_mid);      // [n_row]: this CTA's sums
  float* aq = gsum + round4(n_row);          // [L][rows][WS]: qb's hidden layers
  float* af = aq + L * rows * WS;            // [L][rows][WS]: f's, then g's
  float* xb = af + L * rows * WS;            // [rows][WS]: scratch
  float* qin = xb + rows * WS;               // [rows][8]: [x~_{t+1}; y_t]
  float* xt = qin + rows * 8;                // [rows][4]: x~_t
  float* ep = xt + rows * 4;                 // [rows][4]: eps_t
  float* dmn = ep + rows * 4;                // [rows][4]: f's / g's mean, then its cotangent
  float* ux = dmn + rows * 4;                // [rows][4]: u_t
  float* dxz = ux + rows * 4;                // [rows][4]
  float* dmb = dxz + rows * 4;               // [rows][4]
  float* jac = dmb + rows * 4;               // [rows][12]: J[o][i] at o*DX + i
  float* sg = jac + rows * 12;               // [rows][12]: the row's sc terms

  stage_padded<DQ, H, DX>(a.weights, n_mid, wq);
  stage_padded<DX, H, DX>(a.weights + a.off_f, n_mid, wf);
  stage_padded<DX, H, DY>(a.weights + a.off_g, n_mid, wg);
  for (int i = tid; i < n_row; i += kThreads) gsum[i] = 0.0f;
  __syncthreads();

  const int NP = a.B * a.M, groups = (NP + P - 1) / P, CH = rows / P;
  float carry[DX];
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    if (tid < P) {
      const int path = grp * P + tid;
#pragma unroll
      for (int d = 0; d < DX; ++d) {
        carry[d] = path < NP && a.d_x_first != nullptr ? a.d_x_first[(size_t)path * DX + d] : 0.0f;
      }
    }
    for (int t0 = 0; t0 < a.T1; t0 += CH) {
      const int steps = a.T1 - t0 < CH ? a.T1 - t0 : CH;
      const int nr = round4(steps * P);
      // 0. the tile's operands; dead rows (past T-1 or NP) are zero throughout
      for (int r = tid; r < nr; r += kThreads) {
        const int c = r / P, path = grp * P + r % P, t = t0 + c;
        const bool live = c < steps && path < NP;
        float xn[DX], x[DX], e[DX], u[DX];
#pragma unroll
        for (int d = 0; d < DX; ++d) xn[d] = x[d] = e[d] = u[d] = 0.0f;
        if (live) {
          const size_t at = ((size_t)t * NP + path) * DX;
#pragma unroll
          for (int d = 0; d < DX; ++d) {
            xn[d] = t == a.T1 - 1 ? a.x_anchor[(size_t)path * DX + d] : a.xtilde[at + NP * DX + d];
            x[d] = a.xtilde[at + d];
            e[d] = a.eps[at + d];
            u[d] = a.d_xtilde != nullptr ? a.d_xtilde[at + d] : 0.0f;
          }
        }
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          qin[r * 8 + d] = xn[d];
          xt[r * 4 + d] = x[d];
          ep[r * 4 + d] = e[d];
          ux[r * 4 + d] = u[d];
          dmb[r * 4 + d] = 0.0f;
        }
        const int b = live ? path / a.M : 0;
#pragma unroll
        for (int q = 0; q < DY; ++q) qin[r * 8 + DX + q] = live ? a.y[((size_t)t * a.B + b) * DY + q] : 0.0f;
#pragma unroll
        for (int i = 0; i < 12; ++i) sg[r * 12 + i] = 0.0f;
      }
      __syncthreads();
      // 1. qb's hidden layers and f's forward, layer by layer in the same phases
      split_forward<DQ, H>(wq, qin, 8, aq, nr);
      split_forward<DX, H>(wf, xt, 4, af, nr);
      __syncthreads();
      for (int l = 1; l <= n_mid; ++l) {
        split_forward<H, H>(wq + NQ::mid(l), aq + (l - 1) * rows * WS, WS, aq + l * rows * WS, nr);
        split_forward<H, H>(wf + NF::mid(l), af + (l - 1) * rows * WS, WS, af + l * rows * WS, nr);
        __syncthreads();
      }
      split_head<H, DX>(wf + NF::mid(n_mid + 1), af + n_mid * rows * WS, dmn, nr);
      __syncthreads();
      // 2. the f and noise terms' cotangents, f's backward
      for (int r = tid; r < nr; r += kThreads) {
        const int c = r / P, path = grp * P + r % P;
        const bool live = c < steps && path < NP;
        float zf[DX], sf = 0.0f, se = 0.0f;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          zf[d] = __fmul_rn(__fsub_rn(qin[r * 8 + d], dmn[r * 4 + d]), a.sc[d]);
          sf = __fadd_rn(sf, __fmul_rn(zf[d], zf[d]));
          se = __fadd_rn(se, __fmul_rn(ep[r * 4 + d], ep[r * 4 + d]));
        }
        const float tf = __fadd_rn(__fmul_rn(-0.5f, sf), a.sc[c0]);
        const float tb = __fadd_rn(__fmul_rn(-0.5f, se), a.sc[c0 + 2]);
        const float dlf = live && a.d_lp != nullptr && !(tf < kMinLogp) ? a.d_lp[path] : 0.0f;
        const float dlb = live && a.d_lq != nullptr && !(tb < kMinLogp) ? a.d_lq[path] : 0.0f;
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          const float dz = -dlf * zf[d], rr = qin[r * 8 + d] - dmn[r * 4 + d];
          dmn[r * 4 + d] = -dz * a.sc[d];
          dxz[r * 4 + d] = dz * a.sc[d];
          sg[r * 12 + d] = dz * rr;
        }
        sg[r * 12 + c0] = dlf;
        sg[r * 12 + c0 + 2] = dlb;
      }
      __syncthreads();
      split_net_backward<DX, H, DX, true>(wf, af, rows, n_mid, xt, 4, dmn, gsum + a.off_f, xb, ux,
                                          nr);
      // 3. g likewise
      split_net_forward<DX, H, DY>(wg, xt, 4, af, rows, n_mid, dmn, nr);
      for (int r = tid; r < nr; r += kThreads) {
        const int c = r / P, path = grp * P + r % P;
        const bool live = c < steps && path < NP;
        float zg[DY], sgs = 0.0f;
#pragma unroll
        for (int q = 0; q < DY; ++q) {
          zg[q] = __fmul_rn(__fsub_rn(qin[r * 8 + DX + q], dmn[r * 4 + q]), a.sc[DX + q]);
          sgs = __fadd_rn(sgs, __fmul_rn(zg[q], zg[q]));
        }
        const float tg = __fadd_rn(__fmul_rn(-0.5f, sgs), a.sc[c0 + 1]);
        const float dlg = live && a.d_lp != nullptr && !(tg < kMinLogp) ? a.d_lp[path] : 0.0f;
#pragma unroll
        for (int q = 0; q < DY; ++q) {
          const float dz = -dlg * zg[q], rr = qin[r * 8 + DX + q] - dmn[r * 4 + q];
          dmn[r * 4 + q] = -dz * a.sc[DX + q];
          sg[r * 12 + DX + q] = dz * rr;
        }
        sg[r * 12 + c0 + 1] = dlg;
      }
      __syncthreads();
      split_net_backward<DX, H, DY, true>(wg, af, rows, n_mid, xt, 4, dmn, gsum + a.off_g, xb, ux,
                                          nr);
      // 4. J_t
      split_jacobian<DQ, H, DX>(wq, aq, rows, n_mid, xb, jac, nr);
      // 5. the recurrence, one thread per path, t ascending
      if (tid < P && grp * P + tid < NP) {
        const int path = grp * P + tid;
        for (int c = 0; c < steps; ++c) {
          const int r = c * P + tid;
          float mb[DX];
#pragma unroll
          for (int d = 0; d < DX; ++d) {
            mb[d] = ux[r * 4 + d] + carry[d];
            dmb[r * 4 + d] = mb[d];
            sg[r * 12 + DQ + d] = mb[d] * ep[r * 4 + d];  // d s_b
          }
#pragma unroll
          for (int i = 0; i < DX; ++i) {
            float s = dxz[r * 4 + i];
#pragma unroll
            for (int o = 0; o < DX; ++o) s = fmaf(jac[r * 12 + o * DX + i], mb[o], s);
            carry[i] = s;
          }
          if (t0 + c == a.T1 - 1) {
#pragma unroll
            for (int d = 0; d < DX; ++d) a.d_x_anchor[(size_t)path * DX + d] = carry[d];
          }
        }
      }
      __syncthreads();
      // 6. qb's VJP from dmb
      split_net_backward<DQ, H, DX, false>(wq, aq, rows, n_mid, qin, 8, dmb, gsum, xb, nullptr, nr);
      // 7. the tile's sc sums, rows in order
      for (int e = tid; e < NS; e += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < nr; ++r) s += sg[r * 12 + e];
        gsum[a.n_weights + e] += s;
      }
      __syncthreads();
    }
  }
  float* row = a.partial + (size_t)blockIdx.x * n_row;
  for (int i = tid; i < n_row; i += kThreads) row[i] = gsum[i];
}

// ---------------------------------------------------------------------------
// K12, design "split": the serial chain of qb and the draw, then f, g and the
// density terms as parallel passes over the chain's rows
// ---------------------------------------------------------------------------

// A path of the split design's chain is a group of H threads, thread gl
// owning hidden unit gl: half a warp at H = 16 (a warp holds two paths), a
// warp at 32, two warps at 64. Synchronise the threads of path slot p:
// their warp below two warps (its paths run in step), else a named barrier
// of the path's two warps.
template <int H>
__device__ __forceinline__ void path_sync(int p) {
  if constexpr (H <= 32) {
    __syncwarp();
  } else {
    named_barrier(1 + p, H);
  }
}

// Dynamic shared memory of K12's split design, in floats: qb in the packed
// layout, f and g padded (as K13's split design holds them), two hidden
// vectors and x~ (4 floats) per chain slot (paths rounded up to whole
// warps), f's and g's two ping-pong hidden layers and means for a tile of
// `rows` rows, and 18 floats for each of the `steps` x `paths` chain rows
// (x~_t, x~_{t+1}, eps_t, y_t and the row's two terms).
template <int DX, int DY, int H>
__host__ __device__ constexpr int fwd_split_smem_floats(int n_mid, int off_f, int paths, int rows,
                                                        int steps) {
  return round4(off_f) + Padded<DX, H, DX>::floats(n_mid) + Padded<DX, H, DY>::floats(n_mid) +
         (paths * H + 31) / 32 * 32 / H * (2 * H + 4) + 4 * rows * (H + 4) + 8 * rows +
         18 * round4(steps * paths);
}

// The split design. A CTA takes P paths and walks t = T-2 .. 0 in chunks of
// TC steps; chain row c*P + p is step t0 - c of path p. Per chunk:
//   1. eps_t and y_t of the chunk's rows into shared memory (cp.async);
//   2. the chain, each path on its own H threads, which synchronise only
//      among themselves (their warp, or a named barrier of two warps): qb's
//      first layer (weights in registers), its first middle layer (each
//      thread's weight column in registers; later ones from shared memory),
//      its head (each output's four partial sums j = k mod 4 on four lanes,
//      joined as b3 + ((s0 + s1) + (s2 + s3))), the draw; x~_t is stored and
//      passed to the path's threads through shared memory for the next step;
//   3. f and g on the chunk's x~_t in tiles of R rows (K13's split_forward /
//      split_head: hidden_unit's and head_unit's rounding per output), then
//      step_terms once per row, in parallel;
//   4. each path's lp and lq, its rows' terms added t descending.
// Every value is computed in the chain design's order, so the outputs carry
// its bits.
template <int DX, int DY, int H>
__global__ void __launch_bounds__(kThreads, 1)
    svo_forward_split_kernel(const FwdArgs a, int P, int R, int TC) {
  constexpr int DQ = DX + DY, WS = H + 4;
  using NF = Padded<DX, H, DX>;
  using NG = Padded<DX, H, DY>;
  extern __shared__ __align__(16) float smem[];
  const int n_mid = a.n_mid, tid = threadIdx.x, NP = a.B * a.M;
  const int slots = (P * H + 31) / 32 * 32 / H, RC = round4(TC * P);
  float* wq = smem;                    // qb, packed
  float* wf = wq + round4(a.off_f);    // f, padded
  float* wg = wf + NF::floats(n_mid);  // g, padded
  float* hb = wg + NG::floats(n_mid);  // [slots][2][H]: the chain's hidden vectors
  float* xs = hb + slots * 2 * H;      // [slots][4]: the chain's x~_{t+1}
  float* af = xs + slots * 4;          // [2][R][WS]: f's hidden layers
  float* ag = af + 2 * R * WS;         // [2][R][WS]: g's
  float* mf = ag + 2 * R * WS;         // [R][4]: f's mean
  float* mg = mf + R * 4;              // [R][4]: g's mean
  float* xt = mg + R * 4;              // [RC][4]: x~_t of each chain row
  float* xn = xt + RC * 4;             // [RC][4]: x~_{t+1}
  float* ep = xn + RC * 4;             // [RC][4]: eps_t
  float* yv = ep + RC * 4;             // [RC][4]: y_t
  float* tl = yv + RC * 4;             // [RC][2]: the row's lp and lq terms

  // eps_t and y_t of the chunk's n rows (dead paths: zero noise, row 0's y)
  auto stage = [&](int t0, int n) {
    for (int e = tid; e < n * DQ; e += kThreads) {
      const int row = e / DQ, d = e % DQ, q = blockIdx.x * P + row % P, t = t0 - row / P;
      if (d < DX) {
        if (q < NP) {
          cp_async4(ep + row * 4 + d, a.eps + ((size_t)t * NP + q) * DX + d);
        } else {
          ep[row * 4 + d] = 0.0f;
        }
      } else {
        const int b = q < NP ? q / a.M : 0;
        cp_async4(yv + row * 4 + d - DX, a.y + ((size_t)t * a.B + b) * DY + d - DX);
      }
    }
    cp_async_commit();
  };
  const int first = a.T1 < TC ? a.T1 : TC;
  stage(a.T1 - 1, first * P);
  for (int i = tid; i < a.off_f / 4; i += kThreads) {
    reinterpret_cast<float4*>(wq)[i] = reinterpret_cast<const float4*>(a.weights)[i];
  }
  stage_padded<DX, H, DX>(a.weights + a.off_f, n_mid, wf);
  stage_padded<DX, H, DY>(a.weights + a.off_g, n_mid, wg);
  for (int i = tid; i < RC * 4; i += kThreads) xt[i] = 0.0f;  // a tile's pad rows stay finite

  // the chain's threads: path slot p, unit gl of its group; head lane (ho, hk)
  const bool chain = tid < slots * H;
  const int p = tid / H, gl = tid % H, pr = p < P ? p : P - 1;
  const int path = blockIdx.x * P + p;
  const bool live = p < P && path < NP;
  const bool head = gl < 4 * DX;
  const int ho = head ? gl / 4 : DX - 1, hk = gl % 4;
  float* h0 = hb + (chain ? p : 0) * 2 * H;
  float* h1 = h0 + H;
  float* xp = xs + (chain ? p : 0) * 4;  // the path's x~_{t+1}
  if (chain && gl < DX) xp[gl] = live ? a.x_anchor[(size_t)path * DX + gl] : 0.0f;
  float xo = live ? a.x_anchor[(size_t)path * DX + ho] : 0.0f;  // head lanes: x~_{t+1}[ho]
  const float sb = a.sc[DQ + ho];
  float lp = 0.0f, lq = 0.0f;  // thread p < P: path p's sums

  for (int t0 = a.T1 - 1; t0 >= 0; t0 -= TC) {
    const int steps = t0 + 1 < TC ? t0 + 1 : TC, n = steps * P;
    if (t0 != a.T1 - 1) stage(t0, n);
    cp_async_wait<0>();
    __syncthreads();
    if (chain) {
      float w1[DQ], wm[H], w3[H / 4];
#pragma unroll
      for (int i = 0; i < DQ; ++i) w1[i] = wq[i * H + gl];
      const float b1 = wq[DQ * H + gl];
      const float* m1 = wq + mid_off(DQ, H, 1);
#pragma unroll
      for (int i = 0; i < H; ++i) wm[i] = n_mid >= 1 ? m1[i * H + gl] : 0.0f;
      const float bm = n_mid >= 1 ? m1[H * H + gl] : 0.0f;
      const float* w3p = wq + head_off(DQ, H, n_mid);
#pragma unroll
      for (int m = 0; m < H / 4; ++m) w3[m] = w3p[(4 * m + hk) * DX + ho];
      const float b3 = w3p[H * DX + ho];
      for (int c = 0; c < steps; ++c) {
        const int row = c * P + pr, t = t0 - c;
        float qin[DQ];
#pragma unroll
        for (int d = 0; d < DX; ++d) qin[d] = xp[d];
#pragma unroll
        for (int q = 0; q < DY; ++q) qin[DX + q] = yv[row * 4 + q];
        {
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < DQ; ++i) s[i & 3] = fmaf(w1[i], qin[i], s[i & 3]);
          const float v = b1 + ((s[0] + s[1]) + (s[2] + s[3]));
          h0[gl] = v < 0.0f ? 0.0f : v;
        }
        path_sync<H>(p);
        float* hin = h0;
        float* hout = h1;
        if (n_mid >= 1) {
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int i = 0; i < H; i += 4) {
            const float4 hv = *reinterpret_cast<const float4*>(hin + i);
            s[0] = fmaf(wm[i], hv.x, s[0]);
            s[1] = fmaf(wm[i + 1], hv.y, s[1]);
            s[2] = fmaf(wm[i + 2], hv.z, s[2]);
            s[3] = fmaf(wm[i + 3], hv.w, s[3]);
          }
          const float v = bm + ((s[0] + s[1]) + (s[2] + s[3]));
          hout[gl] = v < 0.0f ? 0.0f : v;
          path_sync<H>(p);
          hin = h1;
          hout = h0;
        }
        for (int l = 2; l <= n_mid; ++l) {
          hout[gl] = hidden_unit<H, H>(wq + mid_off(DQ, H, l), hin, gl);
          path_sync<H>(p);
          float* tmp = hin;
          hin = hout;
          hout = tmp;
        }
        // the head: lane (ho, hk) adds the terms j = hk mod 4 of output ho
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < H / 4; ++m) s = fmaf(hin[4 * m + hk], w3[m], s);
        s = s + __shfl_xor_sync(0xffffffffu, s, 1);
        s = s + __shfl_xor_sync(0xffffffffu, s, 2);
        const float x = __fadd_rn(b3 + s, __fmul_rn(sb, ep[row * 4 + ho]));
        if (head && hk == 0) {
          if (p < P) {
            xt[row * 4 + ho] = x;
            xn[row * 4 + ho] = xo;
            if (live) a.xtilde[((size_t)t * NP + path) * DX + ho] = x;
          }
          xp[ho] = x;  // every thread of the path read x~_{t+1} before the first sync
        }
        xo = x;
        path_sync<H>(p);  // x~_t is the next step's query; the head's reads are done
      }
    }
    __syncthreads();
    // f and g on the chunk's rows, a tile at a time, then each row's terms
    for (int r0 = 0; r0 < n; r0 += R) {
      const int cnt = n - r0 < R ? n - r0 : R, nr = round4(cnt);
      split_forward<DX, H>(wf, xt + r0 * 4, 4, af, nr);
      split_forward<DX, H>(wg, xt + r0 * 4, 4, ag, nr);
      __syncthreads();
      for (int l = 1; l <= n_mid; ++l) {
        const int i = ((l - 1) & 1) * R * WS, o = (l & 1) * R * WS;
        split_forward<H, H>(wf + NF::mid(l), af + i, WS, af + o, nr);
        split_forward<H, H>(wg + NG::mid(l), ag + i, WS, ag + o, nr);
        __syncthreads();
      }
      const int last = (n_mid & 1) * R * WS;
      split_head<H, DX>(wf + NF::mid(n_mid + 1), af + last, mf, nr);
      split_head<H, DY>(wg + NG::mid(n_mid + 1), ag + last, mg, nr);
      __syncthreads();
      for (int r = tid; r < cnt; r += kThreads) {
        const int row = r0 + r;
        float zf[DX], zg[DY], tf, tg, tb;
        step_terms<DX, DY>(xn + row * 4, mf + r * 4, yv + row * 4, mg + r * 4, ep + row * 4, a.sc,
                           zf, zg, tf, tg, tb);
        tl[row * 2] = floor_logp(tf) + floor_logp(tg);
        tl[row * 2 + 1] = floor_logp(tb);
      }
    }
    __syncthreads();
    if (tid < P) {  // t descending, as the chain design adds them
      for (int c = 0; c < steps; ++c) {
        lp += tl[(c * P + tid) * 2];
        lq += tl[(c * P + tid) * 2 + 1];
      }
    }
  }
  if (chain && live && head && hk == 0) a.x_first[(size_t)path * DX + ho] = xo;
  if (tid < P && (int)blockIdx.x * P + tid < NP) {
    a.lp[blockIdx.x * P + tid] = lp;
    a.lq[blockIdx.x * P + tid] = lq;
  }
}

template <int DX, int DY, int H>
cudaError_t launch_forward_split(const FwdArgs& a, int P, int R, int TC, cudaStream_t stream) {
  if (P < 1 || P * H > kThreads || R < 4 || R % 4 != 0 || TC < 1 || a.off_f % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * fwd_split_smem_floats<DX, DY, H>(a.n_mid, a.off_f, P, R, TC);
  auto kernel = svo_forward_split_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(a.B * a.M + P - 1) / P, kThreads, smem, stream>>>(a, P, R, TC);
  return cudaGetLastError();
}

template <int DX, int DY, int H>
cudaError_t launch_forward(const FwdArgs& a, cudaStream_t stream) {
  constexpr int P = kThreads / H;
  const int L = (a.n_mid + 1) * H;
  const size_t smem = sizeof(float) * (a.n_weights + P * (kFHid + 3 * L));
  auto kernel = svo_forward_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (a.B * a.M + P - 1) / P;
  kernel<<<groups, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DX, int DY, int H>
cudaError_t launch_backward(const BwdArgs& a, int max_ctas, float* grads, cudaStream_t stream) {
  constexpr int P = kThreads / H;
  constexpr int DQ = DX + DY;
  constexpr int NS = 2 * DX + DY + 3;
  const int L = (a.n_mid + 1) * H;
  const int nt = DQ * H + 2 * DX * H + 3 * a.n_mid * H * H;
  const int n_row = a.n_weights + NS;
  const size_t smem =
      sizeof(float) * (a.n_weights + round4(nt) + round4(n_row) + P * (kBHid + 6 * L));
  auto kernel = svo_backward_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = (a.B * a.M + P - 1) / P;
  int grid = groups < sms * per_sm ? groups : sms * per_sm;
  if (grid > max_ctas) grid = max_ctas;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  svo_sum_ctas_kernel<<<(n_row + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.partial, grid, n_row, grads);
  return cudaGetLastError();
}

template <int DX, int DY, int H>
cudaError_t launch_backward_split(const BwdArgs& a, int max_ctas, int rows, int P, float* grads,
                                  cudaStream_t stream) {
  constexpr int NS = 2 * DX + DY + 3;
  if (rows < 4 || rows % 4 != 0 || rows * H > 4096 || P < 1 || P > rows) {
    return cudaErrorInvalidValue;
  }
  const int n_row = a.n_weights + NS;
  const size_t smem = sizeof(float) * split_smem_floats<DX, DY, H>(a.n_mid, a.n_weights, rows);
  auto kernel = svo_backward_split_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = (a.B * a.M + P - 1) / P;
  int grid = groups < sms * per_sm ? groups : sms * per_sm;
  if (grid > max_ctas) grid = max_ctas;
  kernel<<<grid, kThreads, smem, stream>>>(a, rows, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  svo_sum_ctas_kernel<<<(n_row + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      a.partial, grid, n_row, grads);
  return cudaGetLastError();
}

template <template <int, int, int> class Launch, typename... Ts>
int dispatch(int dx, int dy, int hidden, Ts... args) {
  if (dx == 2 && dy == 2) {
    switch (hidden) {
      case 16: return Launch<2, 2, 16>::run(args...);
      case 32: return Launch<2, 2, 32>::run(args...);
      case 64: return Launch<2, 2, 64>::run(args...);
      default: break;
    }
  }
  if (dx == 3 && dy == 3) {
    switch (hidden) {
      case 16: return Launch<3, 3, 16>::run(args...);
      case 32: return Launch<3, 3, 32>::run(args...);
      case 64: return Launch<3, 3, 64>::run(args...);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DX, int DY, int H>
struct Forward {  // design 0: split, 1: chain
  static int run(const FwdArgs& a, int design, int paths, int tile_rows, int steps,
                 cudaStream_t s) {
    if (design == 0) {
      return static_cast<int>(launch_forward_split<DX, DY, H>(a, paths, tile_rows, steps, s));
    }
    if (design == 1) return static_cast<int>(launch_forward<DX, DY, H>(a, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

template <int DX, int DY, int H>
struct Backward {  // design 0: split, 1: chain
  static int run(const BwdArgs& a, int max_ctas, int design, int rows, int paths, float* grads,
                 cudaStream_t s) {
    if (design == 0) {
      return static_cast<int>(launch_backward_split<DX, DY, H>(a, max_ctas, rows, paths, grads, s));
    }
    if (design == 1) return static_cast<int>(launch_backward<DX, DY, H>(a, max_ctas, grads, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace svo
}  // namespace psvo

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Each returns a cudaError_t. K12's design: 0 the split design (paths paths a
// CTA, tile_rows rows a tile of its parallel pass, steps steps a chunk), 1 the
// chain design (paths, tile_rows and steps unread). grads [n_weights + 2*dx +
// dy + 3] receives the weight gradients, then sc's; partial [max_ctas,
// n_weights + 2*dx + dy + 3] is scratch. K13's design: 0 the split design
// (tile_rows rows a tile, paths paths a CTA group), 1 the chain design
// (tile_rows and paths unread).
extern "C" int psvo_svo_forward(const float* x_anchor, const float* eps, const float* y,
                                const float* weights, const float* sc, float* x_first, float* lp,
                                float* lq, float* xtilde, int B, int M, int T1, int dx, int dy,
                                int hidden, int n_mid, int n_weights, int off_f, int off_g,
                                int design, int paths, int tile_rows, int steps, void* stream) {
  const psvo::svo::FwdArgs a{x_anchor, eps, y,  weights, sc, x_first, lp,        lq,
                             xtilde,   B,   M,  T1,      n_mid, n_weights, off_f, off_g};
  return psvo::svo::dispatch<psvo::svo::Forward>(dx, dy, hidden, a, design, paths, tile_rows,
                                                 steps, static_cast<cudaStream_t>(stream));
}

extern "C" int psvo_svo_backward(const float* x_anchor, const float* eps, const float* y,
                                 const float* weights, const float* sc, const float* xtilde,
                                 const float* d_x_first, const float* d_lp, const float* d_lq,
                                 const float* d_xtilde, float* d_x_anchor, float* partial,
                                 float* grads, int B, int M, int T1, int dx, int dy, int hidden,
                                 int n_mid, int n_weights, int off_f, int off_g, int max_ctas,
                                 int design, int tile_rows, int paths, void* stream) {
  const psvo::svo::BwdArgs a{x_anchor, eps,    y,          weights, sc,    xtilde, d_x_first,
                             d_lp,     d_lq,   d_xtilde,   d_x_anchor, partial, B, M,
                             T1,       n_mid,  n_weights,  off_f,   off_g};
  return psvo::svo::dispatch<psvo::svo::Backward>(dx, dy, hidden, a, max_ctas, design, tile_rows,
                                                  paths, grads, static_cast<cudaStream_t>(stream));
}
