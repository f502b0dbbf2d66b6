// K10 trunk_backward: the VJP of K9 (trunk_forward.cuh) for one step, plus
// two small kernels that sum its partial gradients. The templates;
// trunk_backward.cu instantiates them without controls and holds the C entry
// point, trunk_backward_ctrl.cu their control mode.
//
// Replaces psvo_tpu/ops/pallas_trunk.py::_tr_bwd (kernel body _tr_bwd_kernel,
// which runs pallas_step._propose_weight_bwd_core with d_stats=None and
// accumulates with _accum_param_grads; ℓ = lse(α) stays outside, in tensor
// ops). Per particle of the tile, from K9's inputs and output (x_res, ε or
// the seed it drew from, x_new) and the cotangents of x_new and α:
//   1. recompute m_f = f(x_res) and m_g = g(x_new), and the unfloored α,
//      with trunk_tile.cuh's functions, so they carry K9's bits;
//   2. cut dα to 0 where the unfloored α < −3e30 (K9's floor clamped it);
//   3. backprop g; its input cotangent adds into d x_new;
//   4. d m1 = cq·d x_new; recompute q1 on x_res and backprop it;
//   5. backprop f (its hidden layers recomputed: see below).
// Outputs: d x_res = d x_q1 + d x_f; per row the sums Σ_k d x_new,
// Σ_k d x_new·m1, Σ_k d x_new·ε (for aq, cq, sq) and Σ_k dα (for ab), zero
// for the y columns (y is data); d_sconst from Σ d_z·(x − m); the weight
// gradients of the three nets in fused_step.prepare's packed layout; no
// gradient for ε. Its plain version is trunk.trunk_backward_reference.
//
// What bounds it. At Dx = Dy = 40 and hidden (64, 64), B = 8, K = 8192, a
// launch does 1.087e10 FLOP: three trunk forwards (q1, f, g) recomputed,
// and per trunk the input-side backward and the weight-gradient products,
// each as large as a forward; against ~42 MB of particle traffic. On the
// fp32 cores alone that is 0.1623 ms at 67 TFLOP/s. This design puts the six
// backward units on the tensor cores in 3xTF32 (mma_tf32.cuh: three TF32
// passes keep float32 accuracy; one pass would keep about three digits),
// so its own bound is the three forward units on the fp32 cores, 0.054 ms,
// plus the six backward units × 3 passes at 495 TFLOP/s TF32, 0.044 ms.
//
// The design (trunk_backward_tf32x3_kernel, 512 threads):
//   * Shared memory decides the grid. K9 keeps the three nets resident; their
//     gradient accumulators are as large again and do not fit beside the
//     tiles. So the weights stay resident, the grid is persistent (one CTA
//     per SM walking tiles b·(K/64) + k/64 with a stride of the grid, as K9),
//     and each CTA owns one row of a [CTAs, n_w + Dx + Dy] partial buffer in
//     device memory (15 MB for 132 CTAs: it stays in L2). A second kernel
//     adds the CTA rows in order, a third each trajectory row's per-tile
//     d_coef sums in tile order.
//   * The recompute decides the relu masks and the −3e30 cut, so it keeps
//     K9's per-output order (tile_layer: bias first, then i ascending, one
//     fmaf per term) on the fp32 cores; only the thread mapping differs
//     (4 × 4 outputs a thread at width 64, 2 × 4 at width 40, so 320
//     threads share a 40-wide layer instead of 160). f's hidden layers do
//     not stay alive while g and q1 run; they are recomputed before f's
//     backprop (a ninth more work, against the 37 KB they would need).
//   * The backward products are m16n8k8 tiles with the 64-wide dimension as
//     M: the input cotangents D[p][i] = Σ_o c[o][p]·w[i][o] (M = the tile's
//     64 particles), the weight gradients D[i][o] = Σ_p a[i][p]·c[o][p]
//     (M = the hidden width, the particles as the depth), so every shape at
//     Dx = 40 and hidden 16/32/64 tiles without padding. A warp takes two
//     m-tiles by one n-tile at a time. Which particles a lane's fragment
//     registers stand for is chosen so that each pair is one 8-byte load;
//     with the tiles' row stride of 72 floats (8 mod 32 banks) and the
//     weights' rows padded by 4 floats (4 or 12 mod 32) the fragment loads
//     are free of bank conflicts. 228.6 KB of shared memory at width 64.
//   * Each tile's weight-gradient sums are added into the CTA's row as
//     float4, one owner per entry: the fragments are regrouped by warp
//     shuffles first, and the row's old values are loaded before the
//     product. The bias, d_sconst and d_coef sums are warp-shuffle
//     reductions in a fixed order; a warp's rows are added by as many lanes.
//   * 16 warps per SM (the previous design ran 8), so one warp's barrier or
//     load hides behind the others.
//
// The previous design (trunk_backward_kernel, 256 threads, every product an
// fp32 FMA GEMM with 4×4 outputs a thread, tiles at a stride of 68 floats)
// stays callable (psvo_trunk_backward's design 1) as the yardstick of the new
// one; the main path never launches it.
//
// The small widths, (Dx, Dy) = (2, 2) and (3, 3) (FHN, Lorenz-63), run the
// previous design: their first layers have 2 or 3 inputs and their means 2
// or 3 outputs, which do not tile m16n8k8 (nor its 4 x 4 blocks), so those
// products take a plain loop, one thread an entry (layer_grads and
// input_grads below), and the hidden layers keep their blocks.
//
// The control mode (CTRL): q1's and f's first layers take b + the row's
// control term (the coefficient row's last 2H columns, read from device
// memory as K9 reads them), and their first-layer cotangents, summed over
// the tile's particles in particle order after each net's backprop, are the
// control columns' per-tile d_coef sums. It is the tensor-core design's at
// (40, 40) and the previous design's at the small widths.
//
// Determinism: no float atomics. Every gradient entry has one owner per CTA,
// the per-tile sums run in a fixed order, and the CTA rows and tiles are
// added in order, so a second launch on the same card gives the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"
#include "philox.cuh"
#include "trunk_tile.cuh"

namespace psvo {

constexpr int kPS = kTile + 4;  // row stride of the previous design's tiles, in floats

struct TrunkBwdArgs {
  const float* x_res;    // [B, DX, K]
  const float* x_new;    // [B, DX, K]: K9's output
  const float* eps;      // [B, DX, K]; stream mode only
  const float* coef;     // [B, 3*DX + DY + 1 (+ 2H with controls)]: aq, cq, sq, y, ab (, the
                         // controls' first-layer terms of q1 and f) of this step
  const float* weights;  // q1 | f | g, each fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  const float* d_x_new;  // [B, DX, K]
  const float* d_alpha;  // [B, K]
  float* d_x_res;        // [B, DX, K]
  float* partial;        // [CTAs, n_weights + DX + DY]: each CTA's gradient sums
  float* coef_part;      // [B * K / kTile, 3*DX + 1 (+ 2H)]: each tile's d_coef sums
  uint32_t seed0, seed1;
  int use_rng, t, B, K, n_mid, n_weights, off_f, off_g;
};

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The relu trunk on a [DIN][kPS] tile: hidden layer j into hs + j·H·kPS
// (n_mid + 1 of them), then the mean into out (skipped when out is null);
// with CB the first layer's bias plus the row's control term cb [H].
// Ends on a barrier.
template <int DIN, int H, int DOUT, bool CB = false>
__device__ __forceinline__ void net_forward(const float* __restrict__ w, int n_mid,
                                            const float* in, float* hs, float* out,
                                            const float* cb = nullptr) {
  tile_layer<DIN, H, true, kPS, kTrunkThreads, row_block(H, 4), H, CB>(w, in, hs, cb);
  __syncthreads();
  const float* p = w + DIN * H + H;
  for (int j = 1; j <= n_mid; ++j) {
    tile_layer<H, H, true, kPS>(p, hs + (j - 1) * H * kPS, hs + j * H * kPS);
    __syncthreads();
    p += H * H + H;
  }
  if (out != nullptr) {
    tile_layer<H, DOUT, false, kPS>(p, hs + n_mid * H * kPS, out);
    __syncthreads();
  }
}

// g[i][o] += Σ_p a[i][p]·c[o][p] and g[RI·RO + o] += Σ_p c[o][p] (a layer's
// weight and bias gradients from its input a [RI][kPS] and the cotangent of
// its pre-activation c [RO][kPS]); g is this CTA's row of the partial
// buffer. A thread owns rows i0 + SI·r and columns o0 + SO·c: neighbouring
// threads read neighbouring rows of c, which the padded stride puts on
// other banks.
template <int RI, int RO>
__device__ __forceinline__ void layer_grads(const float* __restrict__ a,
                                            const float* __restrict__ c, float* g) {
  constexpr int SI = RI / 4, SO = RO / 4;
  if constexpr (RI % 4 || RO % 4) {  // a 2- or 3-wide side: one thread an entry
    for (int e = threadIdx.x; e < RI * RO; e += kTrunkThreads) {
      const int i = e / RO, o = e % RO;
      float s = 0.0f;
      for (int p = 0; p < kTile; ++p) s = fmaf(a[i * kPS + p], c[o * kPS + p], s);
      g[e] += s;
    }
  } else {
    for (int blk = threadIdx.x; blk < SI * SO; blk += kTrunkThreads) {
      const int i0 = blk / SO, o0 = blk % SO;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
      for (int p = 0; p < kTile; p += 4) {
        float av[4][4], cv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ld4(a + (i0 + SI * r) * kPS + p, av[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) ld4(c + (o0 + SO * q) * kPS + p, cv[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r][e], cv[q][e], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) g[(i0 + SI * r) * RO + o0 + SO * q] += acc[r][q];
      }
    }
  }
  for (int o = threadIdx.x; o < RO; o += kTrunkThreads) {
    float s = 0.0f;
    for (int p = 0; p < kTile; p += 4) {
      float cv[4];
      ld4(c + o * kPS + p, cv);
#pragma unroll
      for (int q = 0; q < 4; ++q) s += cv[q];
    }
    g[RI * RO + o] += s;
  }
}

enum InputMode { kRelu, kWrite, kAdd };

// d[i][p] = Σ_o w[i][o]·c[o][p] for i < RI (w row-major [RI][RO]), c and d
// [rows][kPS]. kRelu: d holds the layer input's activation and becomes the
// cotangent of its pre-activation (zero where the activation is 0); kWrite
// and kAdd store or add the sum.
template <int RI, int RO, InputMode kMode>
__device__ __forceinline__ void input_grads(const float* __restrict__ w,
                                            const float* __restrict__ c, float* d) {
  constexpr int kColGroups = kTile / 4;
  if constexpr (RI % 4 || RO % 4) {  // a 2- or 3-wide side: one thread an entry
    for (int v = threadIdx.x; v < RI * kTile; v += kTrunkThreads) {
      const int i = v / kTile, p = v % kTile;
      float acc = 0.0f;
      for (int o = 0; o < RO; ++o) acc = fmaf(w[i * RO + o], c[o * kPS + p], acc);
      float* e = d + i * kPS + p;
      if (kMode == kRelu) *e = *e > 0.0f ? acc : 0.0f;
      if (kMode == kWrite) *e = acc;
      if (kMode == kAdd) *e += acc;
    }
  } else {
    for (int blk = threadIdx.x; blk < (RI / 4) * kColGroups; blk += kTrunkThreads) {
      const int i0 = (blk / kColGroups) * 4, p0 = (blk % kColGroups) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      }
      for (int o = 0; o < RO; o += 4) {
        float wv[4][4], cv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ld4(w + (i0 + r) * RO + o, wv[r]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ld4(c + (o + e) * kPS + p0, cv[e]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r][e], cv[e][q], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* row = d + (i0 + r) * kPS + p0;
        float dv[4];
        ld4(row, dv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (kMode == kRelu) dv[q] = dv[q] > 0.0f ? acc[r][q] : 0.0f;
          if (kMode == kWrite) dv[q] = acc[r][q];
          if (kMode == kAdd) dv[q] += acc[r][q];
        }
        *reinterpret_cast<float4*>(row) = make_float4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
  }
}

// Backprop of one relu trunk (fused_step.prepare's layout at w, its gradient
// segment at g) from the cotangent of its mean dm [DOUT][kPS], with its
// input x [DIN][kPS] and hidden layers hs from net_forward (overwritten by
// their cotangents). The input cotangent goes to dx as kMode says; dx must
// not be x. Ends on a barrier.
template <int DIN, int H, int DOUT, InputMode kMode>
__device__ __forceinline__ void net_backward(const float* __restrict__ w, float* g, int n_mid,
                                             const float* x, float* hs, const float* dm,
                                             float* dx) {
  const int head = DIN * H + H + n_mid * (H * H + H);
  float* top = hs + n_mid * H * kPS;
  layer_grads<H, DOUT>(top, dm, g + head);
  __syncthreads();
  input_grads<H, DOUT, kRelu>(w + head, dm, top);
  __syncthreads();
  for (int j = n_mid; j >= 1; --j) {
    const int off = DIN * H + H + (j - 1) * (H * H + H);
    float* cur = hs + j * H * kPS;
    float* prev = hs + (j - 1) * H * kPS;
    layer_grads<H, H>(prev, cur, g + off);
    __syncthreads();
    input_grads<H, H, kRelu>(w + off, cur, prev);
    __syncthreads();
  }
  layer_grads<DIN, H>(x, hs, g);
  input_grads<DIN, H, kMode>(w, hs, dx);
  __syncthreads();
}

// The control columns' per-tile sums: out[o] = Σ_p c[o][p] over the tile's
// particles in order, c a first layer's pre-activation cotangent [H][kPS].
template <int H>
__device__ __forceinline__ void ctrl_sums(const float* c, float* out) {
  for (int o = threadIdx.x; o < H; o += kTrunkThreads) {
    float s = 0.0f;
    for (int p = 0; p < kTile; ++p) s += c[o * kPS + p];
    out[o] = s;
  }
}

// STREAM (the weights do not fit beside the tiles: ops/trunk.py::k10_weights):
// the nets are read from device memory (L2-resident) and shared memory holds
// the tiles alone; the same products in the same order, so the same bits.
template <int DX, int DY, int H, bool CTRL, bool STREAM = false>
__global__ void __launch_bounds__(kTrunkThreads, 1) trunk_backward_kernel(const TrunkBwdArgs a) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  constexpr int NS = 3 * DX + 1;  // per-tile d_coef sums: aq, cq, sq, ab
  constexpr int NCW = NC + (CTRL ? 2 * H : 0), NSW = NS + (CTRL ? 2 * H : 0);  // with controls
  extern __shared__ __align__(16) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  // [n_weights], a multiple of 4: in shared memory, or (STREAM) the weights in device memory
  const float* wts = STREAM ? a.weights : base;
  float* xr = base + (STREAM ? 0 : a.n_weights);  // [DX][kPS]: x_res
  float* xn = xr + DX * kPS;                    // [DX][kPS]: x_new
  float* ep = xn + DX * kPS;                    // [DX][kPS]: ε
  float* mf = ep + DX * kPS;                    // [DX][kPS]: f's mean, then its cotangent
  float* mg = mf + DX * kPS;                    // [DMAX][kPS]: g's mean / cotangent, q1's
  float* dxn = mg + DMAX * kPS;                 // [DX][kPS]: d x_new, then d x_res
  float* hs = dxn + DX * kPS;                   // [(n_mid + 1) H][kPS]: one net's hidden layers
  float* red = hs + (a.n_mid + 1) * H * kPS;    // [kParts][kTile]
  float* da = red + kParts * kTile;             // [kTile]: dα after the floor cut
  float* cf = da + kTile;                       // [NC]: this row's coefficients
  const int tid = threadIdx.x, K = a.K;
  const int tiles_per_row = K / kTile;
  const int n_row = a.n_weights + DX + DY;
  float* part = a.partial + (size_t)blockIdx.x * n_row;
  const float* wq = wts;
  const float* wf = wts + a.off_f;
  const float* wg = wts + a.off_g;

  if constexpr (!STREAM) {
    for (int i = tid; i < a.n_weights / 4; i += kTrunkThreads) {
      reinterpret_cast<float4*>(base)[i] = reinterpret_cast<const float4*>(a.weights)[i];
    }
  }
  for (int i = tid; i < n_row; i += kTrunkThreads) part[i] = 0.0f;  // the pads stay 0

  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)b * DX * K;
    __syncthreads();  // the previous tile is done (and the weights and zeros are in)
    move_tile<true, kPS>(xr, a.x_res + row, nullptr, DX, K, k0);
    move_tile<true, kPS>(xn, a.x_new + row, nullptr, DX, K, k0);
    if (a.use_rng) {  // K9's draw, particle by particle
      for (int v = tid; v < ((DX + 1) / 2) * kTile; v += kTrunkThreads) {
        const int j = v / kTile, p = v % kTile;
        bool sin_branch;
        const Ctr4 r = eps_words(a.seed0, a.seed1, b, a.t, k0 + p, K, j, &sin_branch);
        ep[2 * j * kPS + p] = box_muller(r.x, r.y, sin_branch);
        if (2 * j + 1 < DX) ep[(2 * j + 1) * kPS + p] = box_muller(r.z, r.w, sin_branch);
      }
    } else {
      move_tile<true, kPS>(ep, a.eps + row, nullptr, DX, K, k0);
    }
    for (int i = tid; i < NC; i += kTrunkThreads) cf[i] = a.coef[(size_t)b * NCW + i];
    const float* cq1 = CTRL ? a.coef + (size_t)b * NCW + NC : nullptr;  // the control terms
    const float* cf1 = CTRL ? cq1 + H : nullptr;
    __syncthreads();

    // 1. recompute f on x_res (its hidden layers are scratch) and g on x_new
    net_forward<DX, H, DX, CTRL>(wf, a.n_mid, xr, hs, mf, cf1);
    net_forward<DX, H, DY>(wg, a.n_mid, xn, hs, mg);

    // 2. the unfloored α, as K9 sums it, and dα cut where the floor clamped
    {
      const int p = tid % kTile, prt = tid / kTile;
      red[prt * kTile + p] = alpha_part<DX, DY, kPS>(xn, mf, ep, mg, cf + 3 * DX, a.sconst, p, prt);
    }
    __syncthreads();
    if (tid < kTile) {
      const float al = alpha_total(red, tid, cf[NC - 1]);
      da[tid] = al >= -3e30f ? a.d_alpha[(size_t)b * K + k0 + tid] : 0.0f;
    }
    __syncthreads();

    // 3. d_sconst: Σ_p d_z·(x − m) = −Σ_p dα·z·(x − m)
    if (tid < DX + DY) {
      const bool is_f = tid < DX;
      const int d = is_f ? tid : tid - DX;
      const float si = a.sconst[tid];
      const float* m = (is_f ? mf : mg) + d * kPS;
      float s = 0.0f;
      for (int p = 0; p < kTile; ++p) {
        const float r = is_f ? xn[d * kPS + p] - m[p] : cf[3 * DX + d] - m[p];
        s -= da[p] * (r * si) * r;
      }
      part[a.n_weights + tid] += s;
    }
    __syncthreads();

    // 4. the means' cotangents in place of the means, and d x_new
    for (int v = tid; v < DX * kTile; v += kTrunkThreads) {
      const int d = v / kTile, p = v % kTile, e = d * kPS + p;
      const float si = a.sconst[d];
      const float dmf = da[p] * ((xn[e] - mf[e]) * si) * si;
      mf[e] = dmf;
      dxn[e] = a.d_x_new[row + (size_t)d * K + k0 + p] - dmf;
    }
    for (int v = tid; v < DY * kTile; v += kTrunkThreads) {
      const int q = v / kTile, p = v % kTile, e = q * kPS + p;
      const float si = a.sconst[DX + q];
      mg[e] = da[p] * ((cf[3 * DX + q] - mg[e]) * si) * si;
    }
    __syncthreads();

    // 5. backprop g: its input cotangent adds into d x_new
    net_backward<DX, H, DY, kAdd>(wg, part + a.off_g, a.n_mid, xn, hs, mg, dxn);

    // 6. recompute q1 on x_res, its mean m1 into mg's tile
    net_forward<DX, H, DX, CTRL>(wq, a.n_mid, xr, hs, mg, cq1);

    // 7. the tile's sums for aq, cq, sq and ab, then d m1 = cq·d x_new in place of m1
    if (tid < NS) {
      float s = 0.0f;
      if (tid == 3 * DX) {
        for (int p = 0; p < kTile; ++p) s += da[p];
      } else {
        const int d = tid % DX, kind = tid / DX;
        const float* other = kind == 1 ? mg : ep;
        for (int p = 0; p < kTile; ++p) {
          const float dv = dxn[d * kPS + p];
          s += kind == 0 ? dv : dv * other[d * kPS + p];
        }
      }
      a.coef_part[(size_t)tile * NSW + tid] = s;
    }
    __syncthreads();
    for (int v = tid; v < DX * kTile; v += kTrunkThreads) {
      const int d = v / kTile, e = d * kPS + v % kTile;
      mg[e] = cf[DX + d] * dxn[e];
    }
    __syncthreads();

    // 8. backprop q1: d x_res into d x_new's tile (no longer read); with
    //    controls, the tile's sums of its first-layer cotangent (hs's first H rows)
    net_backward<DX, H, DX, kWrite>(wq, part, a.n_mid, xr, hs, mg, dxn);
    if constexpr (CTRL) {
      ctrl_sums<H>(hs, a.coef_part + (size_t)tile * NSW + NS);
      __syncthreads();
    }

    // 9. recompute f's hidden layers and backprop f: d x_res adds its part
    net_forward<DX, H, DX, CTRL>(wf, a.n_mid, xr, hs, nullptr, cf1);
    net_backward<DX, H, DX, kAdd>(wf, part + a.off_f, a.n_mid, xr, hs, mf, dxn);
    if constexpr (CTRL) ctrl_sums<H>(hs, a.coef_part + (size_t)tile * NSW + NS + H);

    move_tile<false, kPS>(dxn, nullptr, a.d_x_res + row, DX, K, k0);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core design: 512 threads, the backward products in 3xTF32.

constexpr int kTcThreads = 512;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTS = kTile + 8;  // row stride of its tiles: 8 mod 32 banks
// Rows of a thread's register block in the recompute of a layer r wide: 4
// at width 64 (256 threads hold the layer, with the fewest shared-memory
// loads per FMA), else 2 (at width 40, 320 threads instead of 160).
__host__ __device__ constexpr int fwd_rows(int r) { return r % 64 == 0 ? 4 : 2; }

// Row stride in shared memory of a weight matrix with `cols` columns: 4 or 12
// mod 32 banks at 16, 32, 40 and 64 columns, so the 8 rows × 4 columns that
// a B fragment reads land on 32 different banks.
__host__ __device__ constexpr int wstride(int cols) { return cols + 4; }

// Floats of one layer (DIN rows of R weights, then R biases) in shared memory.
template <int DIN, int R>
__host__ __device__ constexpr int padded_layer() {
  return DIN * wstride(R) + R;
}

// Floats of one net in shared memory, a multiple of 4.
template <int DIN, int H, int DOUT>
__host__ __device__ constexpr int padded_net(int n_mid) {
  return (padded_layer<DIN, H>() + n_mid * padded_layer<H, H>() + padded_layer<H, DOUT>() + 3) /
         4 * 4;
}

// Copy one layer from the packed layout (src: [RIN][R] weights, then [R]
// biases) into shared memory at the padded row stride, as float4.
template <int RIN, int R>
__device__ __forceinline__ void copy_layer(float* dst, const float* __restrict__ src) {
  constexpr int Q = R / 4;
  for (int v = threadIdx.x; v < (RIN + 1) * Q; v += kTcThreads) {
    const int r = v / Q, q = 4 * (v % Q);  // row RIN is the bias
    *reinterpret_cast<float4*>(dst + r * wstride(R) + q) =
        *reinterpret_cast<const float4*>(src + r * R + q);
  }
}

template <int DIN, int H, int DOUT>
__device__ __forceinline__ void copy_net(float* dst, const float* __restrict__ src, int n_mid) {
  copy_layer<DIN, H>(dst, src);
  dst += padded_layer<DIN, H>();
  src += DIN * H + H;
  for (int j = 0; j < n_mid; ++j) {
    copy_layer<H, H>(dst, src);
    dst += padded_layer<H, H>();
    src += H * H + H;
  }
  copy_layer<H, DOUT>(dst, src);
}

// net_forward on the padded weights, every thread on each layer.
template <int DIN, int H, int DOUT, bool CB = false>
__device__ __forceinline__ void net_forward_tc(const float* __restrict__ w, int n_mid,
                                               const float* in, float* hs, float* out,
                                               const float* cb = nullptr) {
  tile_layer<DIN, H, true, kTS, kTcThreads, fwd_rows(H), wstride(H), CB>(w, in, hs, cb);
  __syncthreads();
  const float* p = w + padded_layer<DIN, H>();
  for (int j = 1; j <= n_mid; ++j) {
    tile_layer<H, H, true, kTS, kTcThreads, fwd_rows(H), wstride(H)>(p, hs + (j - 1) * H * kTS,
                                                                 hs + j * H * kTS);
    __syncthreads();
    p += padded_layer<H, H>();
  }
  if (out != nullptr) {
    tile_layer<H, DOUT, false, kTS, kTcThreads, fwd_rows(DOUT), wstride(DOUT)>(p, hs + n_mid * H * kTS,
                                                                        out);
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The first work item of this warp in a stage whose earlier products hold
// `before` items: the stage's items go round the warps in order.
__device__ __forceinline__ int first_item(int before) {
  return (static_cast<int>(threadIdx.x >> 5) - before % kTcWarps + kTcWarps) % kTcWarps;
}

// m-tiles a warp takes at once, and a product's work items (that many
// m-tiles by one n-tile each).
template <int M>
__host__ __device__ constexpr int m_block() {
  return M >= 32 ? 2 : 1;
}
template <int M, int N>
__host__ __device__ constexpr int mma_items() {
  return M / (16 * m_block<M>()) * (N / 8);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Input cotangents: d[i][p] (kMode) Σ_o w[i][o]·c[o][p] for i < RI, as D[p][i]
// with the tile's 64 particles as M and RO as the depth; w at the padded
// stride, c and d [rows][kTS]. A lane's A rows g and g + 8 stand for the
// neighbouring particles 2g and 2g + 1 of its m-tile, so each pair is one
// 8-byte load (banks 8t + 2g: conflict-free per half-warp), and its D pairs
// one 8-byte store. Returns the product's item count.
template <int RI, int RO, InputMode kMode>
__device__ __forceinline__ int input_grads_tc(const float* __restrict__ w,
                                              const float* __restrict__ c, float* d, int before) {
  constexpr int MB = m_block<kTile>(), NT = RI / 8, n = mma_items<kTile, RI>();
  static_assert(RO % 8 == 0, "m16n8k8 needs RO % 8 == 0");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int it = first_item(before); it < n; it += kTcWarps) {
    const int m0 = (it / NT) * 16 * MB, n0 = (it % NT) * 8;
    float big[MB][4] = {}, small[MB][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < RO; k0 += 8) {
      const float* wr = w + (n0 + g) * wstride(RO) + k0 + t;  // B[t][g], B[t+4][g]
      const Tf32Split b0 = split_tf32(wr[0]), b1 = split_tf32(wr[4]);
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const float* col = c + (k0 + t) * kTS + m0 + 16 * j + 2 * g;
        const float2 x = ld2(col), y = ld2(col + 4 * kTS);
        const float av[4] = {x.x, x.y, y.x, y.y};
        mma_3xtf32(big[j], small[j], av, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = big[j][e] + small[j][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // D[2g (+1)][2t + h]: particles p, p + 1 of column i
        float2* q = reinterpret_cast<float2*>(d + (n0 + 2 * t + h) * kTS + m0 + 16 * j + 2 * g);
        float2 r = make_float2(v[h], v[h + 2]);
        if (kMode != kWrite) {
          const float2 o = *q;
          if (kMode == kRelu) r = make_float2(o.x > 0.0f ? r.x : 0.0f, o.y > 0.0f ? r.y : 0.0f);
          if (kMode == kAdd) r = make_float2(o.x + r.x, o.y + r.y);
        }
        *q = r;
      }
    }
  }
  return n;
}

__device__ __forceinline__ float pick4(const float (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Weight gradients of one layer: gw[i·RO + o] += Σ_p a[i][p]·c[o][p] (a the
// layer's input [RI][kTS], c its pre-activation's cotangent [RO][kTS], gw
// this CTA's row segment in device memory). The hidden width is M: kInMajor
// takes D[i][o] (M = RI), otherwise D[o][i] (M = RO). A lane's sum entries t
// and t + 4 stand for the neighbouring particles 2t and 2t + 1 of the k-step,
// so each A and B pair is one 8-byte load (banks 8g + 2t). Each lane's
// fragment is regrouped by shuffles into one float4 of consecutive entries,
// which it alone reads (before the product, so the load's latency hides
// behind it), adds to and writes. Returns the product's item count.
template <int RI, int RO, bool kInMajor>
__device__ __forceinline__ int layer_grads_tc(const float* __restrict__ a,
                                              const float* __restrict__ c, float* gw, int before) {
  constexpr int M = kInMajor ? RI : RO, N = kInMajor ? RO : RI;
  constexpr int MB = m_block<M>(), NT = N / 8, n = mma_items<M, N>();
  const float* am = kInMajor ? a : c;  // A(m, k) = am[m·kTS + k]
  const float* bn = kInMajor ? c : a;  // B(k, n) = bn[n·kTS + k]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, s = g & 3;
  const bool odd = t & 1;
  for (int it = first_item(before); it < n; it += kTcWarps) {
    const int m0 = (it / NT) * 16 * MB, n0 = (it % NT) * 8;
    float* dst[MB];
    float4 old[MB];
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      // in-major: even t takes D[g][2t..2t+3], odd t D[g+8][2t-2..2t+1]; otherwise the
      // four lanes g = 4q + s of one t take D[o0..o0+3][i] with o0 = m0 + 16j + 4q + 8(s >> 1)
      // and i = n0 + 2t + (s & 1)
      dst[j] = kInMajor ? gw + (m0 + 16 * j + g + (odd ? 8 : 0)) * RO + n0 + 2 * (t & 2)
                        : gw + (n0 + 2 * t + (s & 1)) * RO + m0 + 16 * j + 4 * (g >> 2) +
                              8 * (s >> 1);
      old[j] = *reinterpret_cast<const float4*>(dst[j]);
    }
    float big[MB][4] = {}, small[MB][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < kTile; k0 += 8) {
      const float2 bv = ld2(bn + (n0 + g) * kTS + k0 + 2 * t);  // B[t][g], B[t+4][g]
      const Tf32Split b0 = split_tf32(bv.x), b1 = split_tf32(bv.y);
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        const float* row = am + (m0 + 16 * j + g) * kTS + k0 + 2 * t;
        const float2 x = ld2(row), y = ld2(row + 8 * kTS);
        const float av[4] = {x.x, y.x, x.y, y.y};  // A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]
        mma_3xtf32(big[j], small[j], av, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = big[j][e] + small[j][e];
      float4 upd;
      if (kInMajor) {
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        upd = odd ? make_float4(r0, r1, v[2], v[3]) : make_float4(v[0], v[1], r0, r1);
      } else {
        float u[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float send = pick4(v, s ^ x);
          u[x] = x == 0 ? send : __shfl_xor_sync(0xffffffffu, send, 4 * x);
        }
        upd = make_float4(pick4(u, s), pick4(u, s ^ 1), pick4(u, s ^ 2), pick4(u, s ^ 3));
      }
      *reinterpret_cast<float4*>(dst[j]) = make_float4(old[j].x + upd.x, old[j].y + upd.y,
                                                       old[j].z + upd.z, old[j].w + upd.w);
    }
  }
  return n;
}

// Rows a warp reduces in a stage of n rows that go round the warps.
template <int N>
__host__ __device__ constexpr int rows_per_warp() {
  return (N + kTcWarps - 1) / kTcWarps;
}

// g[o] += s_o for this warp's rows o = first + 16r (r < R): lane r owns row
// r's entry, loads it before the sums and writes it once after, so the
// warp's loads from device memory overlap. sum(o) is warp-uniform in o and
// gives every lane the row's sum.
template <int N, class Sum>
__device__ __forceinline__ void add_rows(float* g, int first, Sum sum) {
  constexpr int R = rows_per_warp<N>();
  const int lane = threadIdx.x & 31, mine = first + kTcWarps * lane;
  const bool owner = lane < R && mine < N;
  const float old = owner ? g[mine] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = first + kTcWarps * r;
    if (o < N) {
      const float v = sum(o);
      if (lane == r) s = v;
    }
  }
  if (owner) g[mine] = old + s;
}

// Bias gradients: gb[o] += Σ_p c[o][p], a warp per row (a fixed shuffle
// tree). Returns the rows.
template <int RO>
__device__ __forceinline__ int bias_grads_tc(const float* __restrict__ c, float* gb, int before) {
  const int lane = threadIdx.x & 31;
  add_rows<RO>(gb, first_item(before), [&](int o) {
    return warp_sum(c[o * kTS + lane] + c[o * kTS + lane + 32]);
  });
  return RO;
}

// net_backward on the tensor cores: the padded weights at w, the gradient
// segment at g (packed layout). Ends on a barrier.
template <int DIN, int H, int DOUT, InputMode kMode>
__device__ __forceinline__ void net_backward_tc(const float* __restrict__ w, float* g, int n_mid,
                                                const float* x, float* hs, const float* dm,
                                                float* dx) {
  const int head = DIN * H + H + n_mid * (H * H + H);
  const float* w_head = w + padded_layer<DIN, H>() + n_mid * padded_layer<H, H>();
  float* top = hs + n_mid * H * kTS;
  int done = layer_grads_tc<H, DOUT, true>(top, dm, g + head, 0);
  bias_grads_tc<DOUT>(dm, g + head + H * DOUT, done);
  __syncthreads();
  input_grads_tc<H, DOUT, kRelu>(w_head, dm, top, 0);
  __syncthreads();
  for (int j = n_mid; j >= 1; --j) {
    const int off = DIN * H + H + (j - 1) * (H * H + H);
    float* cur = hs + j * H * kTS;
    float* prev = hs + (j - 1) * H * kTS;
    done = layer_grads_tc<H, H, true>(prev, cur, g + off, 0);
    bias_grads_tc<H>(cur, g + off + H * H, done);
    __syncthreads();
    input_grads_tc<H, H, kRelu>(w + padded_layer<DIN, H>() + (j - 1) * padded_layer<H, H>(), cur,
                                prev, 0);
    __syncthreads();
  }
  // the first layer: its weight and bias gradients and its input cotangent in one stage
  done = layer_grads_tc<DIN, H, false>(x, hs, g, 0);
  done += bias_grads_tc<H>(hs, g + DIN * H, done);
  input_grads_tc<DIN, H, kMode>(w, hs, dx, done);
  __syncthreads();
}

// The control columns' per-tile sums on the tensor-core design's tiles:
// out[o] = Σ_p c[o][p], c [H][kTS], a warp a row (a fixed shuffle tree).
template <int H>
__device__ __forceinline__ void ctrl_sums_tc(const float* c, float* out) {
  const int lane = threadIdx.x & 31;
  for (int o = threadIdx.x >> 5; o < H; o += kTcWarps) {
    const float s = warp_sum(c[o * kTS + lane] + c[o * kTS + lane + 32]);
    if (lane == 0) out[o] = s;
  }
}

template <int DX, int DY, int H, bool CTRL>
__global__ void __launch_bounds__(kTcThreads, 1)
    trunk_backward_tf32x3_kernel(const TrunkBwdArgs a) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  constexpr int NS = 3 * DX + 1;  // per-tile d_coef sums: aq, cq, sq, ab
  constexpr int NCW = NC + (CTRL ? 2 * H : 0), NSW = NS + (CTRL ? 2 * H : 0);  // with controls
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_q = padded_net<DX, H, DX>(a.n_mid);
  float* wq = reinterpret_cast<float*>(smem);       // q1 | f | g at the padded strides
  float* wf = wq + n_q;
  float* wg = wf + n_q;
  float* xr = wg + padded_net<DX, H, DY>(a.n_mid);  // [DX][kTS]: x_res
  float* xn = xr + DX * kTS;                        // [DX][kTS]: x_new
  float* ep = xn + DX * kTS;                        // [DX][kTS]: ε
  float* mf = ep + DX * kTS;                        // [DX][kTS]: f's mean, then its cotangent
  float* mg = mf + DX * kTS;                        // [DMAX][kTS]: g's mean / cotangent, q1's
  float* dxn = mg + DMAX * kTS;                     // [DX][kTS]: d x_new, then d x_res
  float* hs = dxn + DX * kTS;                       // [(n_mid + 1) H][kTS]: one net's hidden layers
  float* red = hs + (a.n_mid + 1) * H * kTS;        // [kParts][kTile]
  float* da = red + kParts * kTile;                 // [kTile]: dα after the floor cut
  float* cf = da + kTile;                           // [NC]: this row's coefficients
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, K = a.K;
  const int tiles_per_row = K / kTile;
  const int n_row = a.n_weights + DX + DY;
  float* part = a.partial + (size_t)blockIdx.x * n_row;

  copy_net<DX, H, DX>(wq, a.weights, a.n_mid);
  copy_net<DX, H, DX>(wf, a.weights + a.off_f, a.n_mid);
  copy_net<DX, H, DY>(wg, a.weights + a.off_g, a.n_mid);
  for (int i = tid; i < n_row; i += kTcThreads) part[i] = 0.0f;  // the pads stay 0

  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)b * DX * K;
    __syncthreads();  // the previous tile is done (and the weights and zeros are in)
    move_tile<true, kTS, kTcThreads>(xr, a.x_res + row, nullptr, DX, K, k0);
    move_tile<true, kTS, kTcThreads>(xn, a.x_new + row, nullptr, DX, K, k0);
    if (a.use_rng) {  // K9's draw, particle by particle
      for (int v = tid; v < ((DX + 1) / 2) * kTile; v += kTcThreads) {
        const int j = v / kTile, p = v % kTile;
        bool sin_branch;
        const Ctr4 r = eps_words(a.seed0, a.seed1, b, a.t, k0 + p, K, j, &sin_branch);
        ep[2 * j * kTS + p] = box_muller(r.x, r.y, sin_branch);
        if (2 * j + 1 < DX) ep[(2 * j + 1) * kTS + p] = box_muller(r.z, r.w, sin_branch);
      }
    } else {
      move_tile<true, kTS, kTcThreads>(ep, a.eps + row, nullptr, DX, K, k0);
    }
    for (int i = tid; i < NC; i += kTcThreads) cf[i] = a.coef[(size_t)b * NCW + i];
    const float* cq1 = CTRL ? a.coef + (size_t)b * NCW + NC : nullptr;  // the control terms
    const float* cf1 = CTRL ? cq1 + H : nullptr;
    __syncthreads();

    // 1. recompute f on x_res (its hidden layers are scratch) and g on x_new
    net_forward_tc<DX, H, DX, CTRL>(wf, a.n_mid, xr, hs, mf, cf1);
    net_forward_tc<DX, H, DY>(wg, a.n_mid, xn, hs, mg);

    // 2. the unfloored α, as K9 sums it, and dα cut where the floor clamped
    if (tid < kParts * kTile) {
      const int p = tid % kTile, prt = tid / kTile;
      red[prt * kTile + p] = alpha_part<DX, DY, kTS>(xn, mf, ep, mg, cf + 3 * DX, a.sconst, p, prt);
    }
    __syncthreads();
    if (tid < kTile) {
      const float al = alpha_total(red, tid, cf[NC - 1]);
      da[tid] = al >= -3e30f ? a.d_alpha[(size_t)b * K + k0 + tid] : 0.0f;
    }
    __syncthreads();

    // 3. d_sconst: Σ_p d_z·(x − m) = −Σ_p dα·z·(x − m), a warp per entry
    add_rows<DX + DY>(part + a.n_weights, warp, [&](int e) {
      const bool is_f = e < DX;
      const int d = is_f ? e : e - DX;
      const float si = a.sconst[e];
      const float* m = (is_f ? mf : mg) + d * kTS;
      float s = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        const float r = is_f ? xn[d * kTS + p] - m[p] : cf[3 * DX + d] - m[p];
        s += da[p] * (r * si) * r;
      }
      return -warp_sum(s);
    });
    __syncthreads();

    // 4. the means' cotangents in place of the means, and d x_new
    for (int v = tid; v < DX * kTile; v += kTcThreads) {
      const int d = v / kTile, p = v % kTile, e = d * kTS + p;
      const float si = a.sconst[d];
      const float dmf = da[p] * ((xn[e] - mf[e]) * si) * si;
      mf[e] = dmf;
      dxn[e] = a.d_x_new[row + (size_t)d * K + k0 + p] - dmf;
    }
    for (int v = tid; v < DY * kTile; v += kTcThreads) {
      const int q = v / kTile, p = v % kTile, e = q * kTS + p;
      const float si = a.sconst[DX + q];
      mg[e] = da[p] * ((cf[3 * DX + q] - mg[e]) * si) * si;
    }
    __syncthreads();

    // 5. backprop g: its input cotangent adds into d x_new
    net_backward_tc<DX, H, DY, kAdd>(wg, part + a.off_g, a.n_mid, xn, hs, mg, dxn);

    // 6. recompute q1 on x_res, its mean m1 into mg's tile
    net_forward_tc<DX, H, DX, CTRL>(wq, a.n_mid, xr, hs, mg, cq1);

    // 7. the tile's sums for aq, cq, sq and ab (a warp per sum), then
    //    d m1 = cq·d x_new in place of m1
    for (int e = warp; e < NS; e += kTcWarps) {
      float s = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        if (e == 3 * DX) {
          s += da[p];
        } else {
          const int d = e % DX, kind = e / DX;
          const float dv = dxn[d * kTS + p];
          s += kind == 0 ? dv : dv * (kind == 1 ? mg : ep)[d * kTS + p];
        }
      }
      s = warp_sum(s);
      if (lane == 0) a.coef_part[(size_t)tile * NSW + e] = s;
    }
    __syncthreads();
    for (int v = tid; v < DX * kTile; v += kTcThreads) {
      const int d = v / kTile, e = d * kTS + v % kTile;
      mg[e] = cf[DX + d] * dxn[e];
    }
    __syncthreads();

    // 8. backprop q1: d x_res into d x_new's tile (no longer read); with
    //    controls, the tile's sums of its first-layer cotangent (a warp a row)
    net_backward_tc<DX, H, DX, kWrite>(wq, part, a.n_mid, xr, hs, mg, dxn);
    if constexpr (CTRL) {
      ctrl_sums_tc<H>(hs, a.coef_part + (size_t)tile * NSW + NS);
      __syncthreads();
    }

    // 9. recompute f's hidden layers and backprop f: d x_res adds its part
    net_forward_tc<DX, H, DX, CTRL>(wf, a.n_mid, xr, hs, nullptr, cf1);
    net_backward_tc<DX, H, DX, kAdd>(wf, part + a.off_f, a.n_mid, xr, hs, mf, dxn);
    if constexpr (CTRL) ctrl_sums_tc<H>(hs, a.coef_part + (size_t)tile * NSW + NS + H);

    move_tile<false, kTS, kTcThreads>(dxn, nullptr, a.d_x_res + row, DX, K, k0);
  }
}

// out[e] = Σ_r partial[r][e], the CTA rows added in order. (The two sums
// are static: each translation unit that includes this header has its own.)
static __global__ void trunk_sum_ctas_kernel(const float* __restrict__ partial, int rows, int n,
                                      float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * n + e];
  out[e] = s;
}

// d_coef[b][c] in pack_coef's layout: the trajectory row's tile sums added
// in tile order for aq, cq, sq and ab (and the ctrl_cols control columns
// after ab); zero for the y columns.
static __global__ void trunk_sum_tiles_kernel(const float* __restrict__ coef_part, int B,
                                       int tiles_per_row, int dx, int dy, int ctrl_cols,
                                       float* __restrict__ d_coef) {
  const int nc0 = 3 * dx + dy + 1, nc = nc0 + ctrl_cols, ns = 3 * dx + 1 + ctrl_cols;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * nc) return;
  const int b = e / nc, c = e % nc;
  float s = 0.0f;
  if (c < 3 * dx || c >= nc0 - 1) {
    const int j = c < 3 * dx ? c : 3 * dx + c - (nc0 - 1);
    for (int i = 0; i < tiles_per_row; ++i) {
      s += coef_part[((size_t)b * tiles_per_row + i) * ns + j];
    }
  }
  d_coef[e] = s;
}

// Launch one design's kernel (kTensorCores: trunk_backward_tf32x3_kernel,
// else the previous trunk_backward_kernel) on a persistent grid, then the two
// sums.
template <int DX, int DY, int H, bool kTensorCores, bool CTRL, bool STREAM = false>
cudaError_t launch_trunk_backward(const TrunkBwdArgs& a, int max_ctas, float* grads,
                                  float* d_coef, cudaStream_t stream) {
  static_assert(!(kTensorCores && STREAM), "the tensor-core design keeps its weights resident");
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  constexpr int threads = kTensorCores ? kTcThreads : kTrunkThreads;
  const int tile_rows = 5 * DX + DMAX + (a.n_mid + 1) * H;
  const int n_w = kTensorCores ? 2 * padded_net<DX, H, DX>(a.n_mid) + padded_net<DX, H, DY>(a.n_mid)
                 : STREAM     ? 0
                              : a.n_weights;
  const size_t smem = sizeof(float) * (n_w + tile_rows * (kTensorCores ? kTS : kPS) +
                                       kParts * kTile + kTile + ((NC + 3) / 4) * 4);
  auto kernel = [] {  // the other design is not instantiated (the small widths have no
                     // tensor-core one)
    if constexpr (kTensorCores) {
      return trunk_backward_tf32x3_kernel<DX, DY, H, CTRL>;
    } else {
      return trunk_backward_kernel<DX, DY, H, CTRL, STREAM>;
    }
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = a.B * (a.K / kTile);
  int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (grid > max_ctas) grid = max_ctas;
  kernel<<<grid, threads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = a.n_weights + DX + DY;
  trunk_sum_ctas_kernel<<<(n + kTrunkThreads - 1) / kTrunkThreads, kTrunkThreads, 0, stream>>>(
      a.partial, grid, n, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nd = a.B * (NC + (CTRL ? 2 * H : 0));
  trunk_sum_tiles_kernel<<<(nd + kTrunkThreads - 1) / kTrunkThreads, kTrunkThreads, 0, stream>>>(
      a.coef_part, a.B, a.K / kTile, DX, DY, CTRL ? 2 * H : 0, d_coef);
  return cudaGetLastError();
}

// One (Dx, Dy)'s launches by hidden width: the tensor-core design (design 0)
// at (40, 40) alone, the previous one (design 1) at every width (in the
// control mode at the small widths alone, where it is the paths' design);
// weights in shared memory (weights 0) in the kernels' library.
template <int DX, int DY, bool CTRL>
int launch_backward_widths(const TrunkBwdArgs& a, int hidden, int design, int weights,
                           int max_ctas, float* grads, float* d_coef, cudaStream_t s) {
  constexpr bool kTcWidth = DX == 40 && DY == 40;
  if (weights != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (design == 0) {
    if constexpr (kTcWidth) {
      switch (hidden) {
        case 16: return launch_trunk_backward<DX, DY, 16, true, CTRL>(a, max_ctas, grads, d_coef, s);
        case 32: return launch_trunk_backward<DX, DY, 32, true, CTRL>(a, max_ctas, grads, d_coef, s);
        case 64: return launch_trunk_backward<DX, DY, 64, true, CTRL>(a, max_ctas, grads, d_coef, s);
        default: break;
      }
    }
  } else if (design == 1) {
    if constexpr (!(CTRL && kTcWidth)) {
      switch (hidden) {
        case 16: return launch_trunk_backward<DX, DY, 16, false, CTRL>(a, max_ctas, grads, d_coef, s);
        case 32: return launch_trunk_backward<DX, DY, 32, false, CTRL>(a, max_ctas, grads, d_coef, s);
        case 64: return launch_trunk_backward<DX, DY, 64, false, CTRL>(a, max_ctas, grads, d_coef, s);
        default: break;
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K10 with or without controls; returns a cudaError_t. The kernels' library
// instantiates the presets' (Dx, Dy) (ops/trunk.py::TRUNK_DIMS) at hidden
// 16/32/64, weights in shared memory; a trunk shape library the previous
// design (design 1) at the one shape and weights plan (PSVO_TRUNK_K10: 0
// shared memory, 1 device memory) that its PSVO_TRUNK_* macros name.
// Instantiated once per CTRL, each in its own translation unit.
template <bool CTRL>
int dispatch_trunk_backward(const TrunkBwdArgs& a, int dx, int dy, int hidden, int design,
                            int weights, int max_ctas, float* grads, float* d_coef,
                            cudaStream_t s) {
#ifdef PSVO_TRUNK_DX
  if (dx == PSVO_TRUNK_DX && dy == PSVO_TRUNK_DY && hidden == PSVO_TRUNK_H && design == 1 &&
      weights == PSVO_TRUNK_K10) {
    return static_cast<int>(
        launch_trunk_backward<PSVO_TRUNK_DX, PSVO_TRUNK_DY, PSVO_TRUNK_H, false, CTRL,
                              PSVO_TRUNK_K10 == 1>(a, max_ctas, grads, d_coef, s));
  }
#else
  if (dx == 2 && dy == 2) {
    return launch_backward_widths<2, 2, CTRL>(a, hidden, design, weights, max_ctas, grads, d_coef,
                                              s);
  }
  if (dx == 3 && dy == 3) {
    return launch_backward_widths<3, 3, CTRL>(a, hidden, design, weights, max_ctas, grads, d_coef,
                                              s);
  }
  if (dx == 40 && dy == 40) {
    return launch_backward_widths<40, 40, CTRL>(a, hidden, design, weights, max_ctas, grads,
                                                d_coef, s);
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace psvo
