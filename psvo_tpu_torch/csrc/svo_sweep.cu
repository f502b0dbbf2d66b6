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
// Design. Paths are independent and each walks a chain of T-1 dependent
// steps of three small MLPs (B*M = 512 paths, 99 steps at the preset). A CTA
// of 256 threads holds P = 256/H paths; thread (p, j) owns hidden unit j of
// path p in every layer (one fixed-order dot product of the layer's input,
// read from shared memory, with column j of the weights: neighbouring threads
// read neighbouring weights). A net's mean is summed by thread o < dout over
// the H hidden units. One barrier per layer; f and g run in the same phases.
// The nets' weights stay in shared memory (56 KB at hidden (64, 64)); the
// carry x~_{t+1}, the activations and lp/lq stay in shared memory and
// registers. Nothing is padded to 128 lanes: a path is H threads.
//
// K13 walks t ascending from K12's saved x~ and carries d x~_{t+1} from step
// to step (the TPU kernel's dq_c): per step it recomputes the three trunks
// (the same device functions as K12, so the same bits and floor cuts),
// backprops f and g into x~_t, then the draw and qb into x~_{t+1}. The
// weight gradients need no atomics: each CTA (persistent, at most one per SM)
// keeps one sum per weight in shared memory, owned by one thread, which adds
// the step's outer products of its P paths in path order; the CTAs write
// their rows to a [CTAs, n_weights + 2*DX + DY + 3] buffer that
// svo_sum_ctas_kernel adds row by row in order: the same bits every launch.
// Transposed copies of the first and middle layers let thread i read row i
// of a weight matrix without bank conflicts in the backward.
//
// What bounds them. Per path-step the forward is 13,632 MACs at Dx = Dy = 3,
// hidden (64, 64): 1.38e9 FLOP per launch at the preset, 0.021 ms at 67
// TFLOP/s; its bytes (eps and x~, 0.6 MB each) take 0.0004 ms. K13 does about
// three times the work, 0.062 ms. Both are latency-bound: each step is eight
// (K12) or about fourteen (K13) dependent phases with a barrier after each,
// 99 steps long, on 128 CTAs.
#include <cuda_runtime.h>

#include <cstdint>

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
struct Forward {
  static int run(const FwdArgs& a, cudaStream_t s) {
    return static_cast<int>(launch_forward<DX, DY, H>(a, s));
  }
};

template <int DX, int DY, int H>
struct Backward {
  static int run(const BwdArgs& a, int max_ctas, float* grads, cudaStream_t s) {
    return static_cast<int>(launch_backward<DX, DY, H>(a, max_ctas, grads, s));
  }
};

}  // namespace svo
}  // namespace psvo

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Each returns a cudaError_t. grads [n_weights + 2*dx + dy + 3] receives the
// weight gradients, then sc's; partial [max_ctas, n_weights + 2*dx + dy + 3]
// is scratch.
extern "C" int psvo_svo_forward(const float* x_anchor, const float* eps, const float* y,
                                const float* weights, const float* sc, float* x_first, float* lp,
                                float* lq, float* xtilde, int B, int M, int T1, int dx, int dy,
                                int hidden, int n_mid, int n_weights, int off_f, int off_g,
                                void* stream) {
  const psvo::svo::FwdArgs a{x_anchor, eps, y,  weights, sc, x_first, lp,        lq,
                             xtilde,   B,   M,  T1,      n_mid, n_weights, off_f, off_g};
  return psvo::svo::dispatch<psvo::svo::Forward>(dx, dy, hidden, a,
                                                 static_cast<cudaStream_t>(stream));
}

extern "C" int psvo_svo_backward(const float* x_anchor, const float* eps, const float* y,
                                 const float* weights, const float* sc, const float* xtilde,
                                 const float* d_x_first, const float* d_lp, const float* d_lq,
                                 const float* d_xtilde, float* d_x_anchor, float* partial,
                                 float* grads, int B, int M, int T1, int dx, int dy, int hidden,
                                 int n_mid, int n_weights, int off_f, int off_g, int max_ctas,
                                 void* stream) {
  const psvo::svo::BwdArgs a{x_anchor, eps,    y,          weights, sc,    xtilde, d_x_first,
                             d_lp,     d_lq,   d_xtilde,   d_x_anchor, partial, B, M,
                             T1,       n_mid,  n_weights,  off_f,   off_g};
  return psvo::svo::dispatch<psvo::svo::Backward>(dx, dy, hidden, a, max_ctas, grads,
                                                  static_cast<cudaStream_t>(stream));
}
