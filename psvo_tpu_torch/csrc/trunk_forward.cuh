// K9 trunk_forward: one filtering step after the resample, for the trunk
// class (Lorenz-96's wide state; the FHN and Lorenz-63 widths outside the
// whole-scan class: ESS-adaptive resampling, IWAE, the full FIVO gradient).
// The templates; trunk_forward.cu instantiates them without controls and
// holds the C entry point, trunk_forward_ctrl.cu their control mode.
//
// Replaces psvo_tpu/ops/pallas_trunk.py::_tr_fwd (kernel body _tr_fwd_kernel,
// which runs pallas_step._propose_weight_core on K-tiles and draws its ε per
// tile in kernel_rng mode). Per particle of the resampled cloud x_res:
//   m1 = q1(x_res), m_f = f(x_res)                (relu MLP trunks)
//   x_new = cq·m1 + aq + sq·ε                      (the fused proposal draw)
//   m_g = g(x_new)
//   α = −½ Σ_d (z_f² − ε²) − ½ Σ_e z_g² + ab,  floored at −3e30,
// with z_f = (x_new − m_f)/s_f, z_g = (y − m_g)/s_g and every K-independent
// constant in ab (the same α as K1, step_math.cuh; the plain version is
// fused_step._propose_weight plus the floor). The tile layer, the tile moves
// and α's sum are in trunk_tile.cuh, shared with the VJP K10, which
// recomputes the trunks and α with them.
//
// Design. What bounds it is arithmetic: at Dx = Dy = 40 and hidden (64, 64)
// the three trunks cost 55,296 FLOP per particle, 3.6e9 per step at B = 8,
// K = 8192, against ~21 MB of particle traffic. K1 keeps one particle's first
// hidden layer in registers; at Dx = 40 that no longer fits, so K9 works as
// K4 does: 64-particle tiles of every trunk stage in shared memory
// ([unit][particle]), each layer a small GEMM in which a thread owns a 4×4
// block of outputs and reads weights and activations as float4. The three
// nets' weights (113 KB at width 64) stay resident in shared memory, with
// the tiles (75 KB) beside them, so one CTA of 256 threads fits an SM; the
// grid is persistent (as many CTAs as fit the card), each CTA loading the
// weights once and walking tiles b·(K/64) + k/64 with a stride of the grid.
// The alternative, staging one net at a time from L2 (38 KB, two CTAs per
// SM), reloads 113 KB per tile; left for a later measurement.
//
// Two designs. "tile" (trunk_forward_kernel, the previous one, kept as its
// yardstick) is the above on 256 threads: q1, then f, then g, about 13
// barriers a tile, and each tile's x_res and ε loaded before it computes.
// "async" (trunk_forward_async_kernel, the one the paths run) runs 512
// threads, one CTA an SM. Its products are what bound it, and from shared
// memory they run fastest in 8 x 4 register blocks on 8 warps (on an NVIDIA
// H100 80GB HBM3 at 700 W a 64 x 64 x 64 tile layer reached 60-65% of the
// fp32 peak in 8 x 4 blocks, 50% in the tile design's 4 x 4; PERF.md), so
// 8 warps run the nets, q1 and f side by side between the same barriers on
// a second pair of hidden-layer tiles, while the other 8 load the next
// tile's coefficients and draw its ε, and the next tile's x_res and
// streamed ε are copied in by cp.async while the current one computes
// (231,680 bytes in all at hidden 64). Every product
// still goes through tile_layer and α through alpha_part / alpha_total with
// kParts = 4, so both designs give the same bits, and K10's recompute
// matches either.
//
// The small widths. At (Dx, Dy) = (2, 2) and (3, 3) (FHN, Lorenz-63) the
// same kernels run with each mean's register block as wide as divides it
// (trunk_tile.cuh::row_block: 2 rows, or 1): the hidden layers keep their
// blocks, so the work per particle is the trunks' few thousand FLOP and the
// tiles are small; the grid and the overlap are the wide state's.
//
// The control mode (CTRL, the async design only): the coefficient row
// carries, after ab, u_t's first-layer terms of q1 and f for the row (H
// each, fused_step.control_term), and q1's and f's first layers take
// b + that term as their bias (tile_layer_at's CB), read from device memory
// where the layer starts; the shared-memory plan is the uncontrolled one.
//
// ε is either a streamed operand [B, Dx, K] or drawn in the kernel from a
// two-word seed and the step t with K2's counter layout (philox.cuh), per
// particle: the draw of a particle does not depend on the tiling, so K2
// extracts exactly the ε this kernel used (the TPU kernel's per-tile seed
// fold, and its rng_tiles_ok gate, have no counterpart here).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "named_barrier.cuh"
#include "philox.cuh"
#include "trunk_tile.cuh"

namespace psvo {

struct TrunkArgs {
  const float* x_res;    // [B, DX, K]
  const float* eps;      // [B, DX, K]; stream mode only
  const float* coef;     // [B, 3*DX + DY + 1 (+ 2H with controls)]: aq, cq, sq, y, ab (, the
                         // controls' first-layer terms of q1 and f) of this step
  const float* weights;  // q1 | f | g, each fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  float* x_new;          // [B, DX, K]
  float* alpha;          // [B, K]
  uint32_t seed0, seed1;
  int use_rng, t, B, K, n_mid, n_weights, off_f, off_g;
};

// One relu MLP mean on the tile: [DIN -> H], n_mid x [H -> H], [H -> DOUT],
// weights in fused_step.prepare's layout; h0 and h1 are [H][kTile] scratch.
// Ends on a barrier: out is readable by all.
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void tile_net(const float* __restrict__ w, int n_mid,
                                         const float* in, float* out, float* h0, float* h1) {
  tile_layer<DIN, H, true, kTile>(w, in, h0);
  __syncthreads();
  const float* p = w + DIN * H + H;
  for (int j = 0; j < n_mid; ++j) {
    tile_layer<H, H, true, kTile>(p, h0, h1);
    __syncthreads();
    float* tmp = h0;
    h0 = h1;
    h1 = tmp;
    p += H * H + H;
  }
  tile_layer<H, DOUT, false, kTile>(p, h0, out);
  __syncthreads();
}

template <int DX, int DY, int H>
__global__ void __launch_bounds__(kTrunkThreads, 1) trunk_forward_kernel(const TrunkArgs a) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wts = reinterpret_cast<float*>(smem);  // [n_weights], a multiple of 4
  float* xa = wts + a.n_weights;                 // [DMAX][kTile]: x_res, then g's mean
  float* xb = xa + DMAX * kTile;                 // [DX][kTile]: q1's mean, then x_new
  float* mf = xb + DX * kTile;                   // [DX][kTile]: f's mean
  float* ep = mf + DX * kTile;                   // [DX][kTile]: ε
  float* h0 = ep + DX * kTile;                   // [H][kTile]
  float* h1 = h0 + H * kTile;                    // [H][kTile]
  float* red = h1 + H * kTile;                   // [kParts][kTile]
  float* cf = red + kParts * kTile;              // [NC]: this row's coefficients
  const int tid = threadIdx.x, K = a.K;
  const int tiles_per_row = K / kTile;

  for (int i = tid; i < a.n_weights / 4; i += kTrunkThreads) {
    reinterpret_cast<float4*>(wts)[i] = reinterpret_cast<const float4*>(a.weights)[i];
  }

  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)b * DX * K;
    __syncthreads();  // the previous tile's readers are done (and the weights are in)
    move_tile<true, kTile>(xa, a.x_res + row, nullptr, DX, K, k0);
    if (a.use_rng) {
      for (int v = tid; v < ((DX + 1) / 2) * kTile; v += kTrunkThreads) {
        const int j = v / kTile, p = v % kTile;
        bool sin_branch;
        const Ctr4 r = eps_words(a.seed0, a.seed1, b, a.t, k0 + p, K, j, &sin_branch);
        ep[2 * j * kTile + p] = box_muller(r.x, r.y, sin_branch);
        if (2 * j + 1 < DX) ep[(2 * j + 1) * kTile + p] = box_muller(r.z, r.w, sin_branch);
      }
    } else {
      move_tile<true, kTile>(ep, a.eps + row, nullptr, DX, K, k0);
    }
    for (int i = tid; i < NC; i += kTrunkThreads) cf[i] = a.coef[(size_t)b * NC + i];
    __syncthreads();

    // q1 and f on the resampled particles
    tile_net<DX, H, DX>(wts, a.n_mid, xa, xb, h0, h1);
    tile_net<DX, H, DX>(wts + a.off_f, a.n_mid, xa, mf, h0, h1);

    // the fused draw, in place of q1's mean
    for (int v = tid; v < DX * kTile; v += kTrunkThreads) {
      const int d = v / kTile;
      xb[v] = cf[DX + d] * xb[v] + cf[d] + cf[2 * DX + d] * ep[v];
    }
    __syncthreads();
    move_tile<false, kTile>(xb, nullptr, a.x_new + row, DX, K, k0);

    // g on the drawn particles, into x_res's tile (no longer read)
    tile_net<DX, H, DY>(wts + a.off_g, a.n_mid, xb, xa, h0, h1);

    // α: kParts threads per particle, each over every kParts-th row
    const int p = tid % kTile, part = tid / kTile;
    red[part * kTile + p] =
        alpha_part<DX, DY, kTile>(xb, mf, ep, xa, cf + 3 * DX, a.sconst, p, part);
    __syncthreads();
    if (tid < kTile) {
      // finiteness floor: a diverged mean gives a finite, hopeless weight
      a.alpha[(size_t)b * K + k0 + tid] = fmaxf(alpha_total(red, tid, cf[NC - 1]), -3e30f);
    }
  }
}

// ---------------------------------------------------------------------------
// Design "async": the products on 8 warps in 8 x 4 register blocks, q1 and f
// side by side; 8 more warps load the next tile's coefficients and draw its
// ε; the next tile's x_res (and streamed ε) copied in while this one computes
// ---------------------------------------------------------------------------

constexpr int kAsyncThreads = 512;
constexpr int kGroup = 256;  // the compute group: warps 0-7 (named barrier 1)
static_assert(kParts * kTile == kGroup, "α's parts are the compute group's threads");

__device__ __forceinline__ void group_sync() { named_barrier(1, kGroup); }

// A net's middle layers and its mean on the tile, from its first hidden layer
// in h[0] (h[1] the ping-pong partner), NT threads numbered ht in blocks of
// RB (RBH for the mean) rows; the compute group's barrier after each layer.
template <int DIN, int H, int DOUT, int NT, int RB, int RBH>
__device__ __forceinline__ void group_tail(const float* __restrict__ w, int n_mid, float* h,
                                           float* out, int ht) {
  const float* p = w + DIN * H + H;
  float* h0 = h;
  float* h1 = h + H * kTile;
  for (int j = 0; j < n_mid; ++j) {
    tile_layer_at<H, H, true, kTile, NT, RB>(p, h0, h1, ht);
    group_sync();
    float* tmp = h0;
    h0 = h1;
    h1 = tmp;
    p += H * H + H;
  }
  tile_layer_at<H, DOUT, false, kTile, NT, RBH>(p, h0, out, ht);
  group_sync();
}

// Floats of the async design's shared memory (its layout below): with
// `pair`, f's two hidden layers beside q1's; with `prefetch`, a second ε
// slot, a second row of coefficients and, unless f's spare hidden layer is
// wide enough for it, a tile for g's mean.
template <int DX, int DY, int H>
__host__ __device__ constexpr int async_smem_floats(int n_weights, int pair, int prefetch) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NCP = (3 * DX + DY + 1 + 3) / 4 * 4;
  const bool own_gm = prefetch && !(pair && H >= DY);
  return n_weights +  // 0 where the weights stay in device memory (STREAM)
         (DMAX + 2 * DX + (prefetch ? 2 : 1) * DX + (pair ? 4 : 2) * H + (own_gm ? DY : 0) +
          kParts) * kTile +
         (prefetch ? 2 : 1) * NCP;
}

// The async design: the tile design's functions and order (so its bits).
// The compute group (256 threads) runs the nets: with `pair` q1 on its first
// 128 threads and f on the other 128, layer by layer between the same
// barriers, in 8 x 4 register blocks at hidden 64 (the g net too); α keeps
// kParts = 4 threads a particle. With `prefetch`, as soon as the current
// x_res has been read (after the first layers) the compute group starts the
// next tile's x_res (and streamed ε) by cp.async into x_res's tile and the
// other ε slot, and the other 8 warps load the next tile's coefficients and,
// in RNG mode, draw its ε there; g's mean then goes to f's spare hidden
// layer (or a tile of its own where that is narrower than DY). Without
// `prefetch` each tile's operands are loaded, and ε drawn, by all 16 warps
// before it computes. Either part is left out where it does not fit. With
// STREAM (the weights do not fit beside the tiles: ops/trunk.py::k9_weights)
// the nets are read from device memory, where they stay L2-resident (186 KB
// at (55, 55) with three layers of 64), and shared memory holds the tiles
// alone: the same products in the same order, so the same bits.
template <int DX, int DY, int H, bool CTRL, bool STREAM = false>
__global__ void __launch_bounds__(kAsyncThreads, 1)
    trunk_forward_async_kernel(const TrunkArgs a, int pair, int prefetch) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1, NCP = (NC + 3) / 4 * 4;
  constexpr int NCW = NC + (CTRL ? 2 * H : 0);  // a row of coef in device memory
  constexpr int NT = kAsyncThreads;
  constexpr int RBN = H >= 64 ? 8 : H >= 32 ? 4 : 2;  // a net's hidden layers on 128 threads
  constexpr int RBG = H >= 64 ? 8 : 4;                // g's hidden layers on 256 threads
  constexpr int ND = (DX + 1) / 2 * kTile;            // the draw's (pair of rows, particle) items
  extern __shared__ __align__(16) unsigned char smem[];
  const bool own_gm = prefetch && !(pair && H >= DY);
  float* base = reinterpret_cast<float*>(smem);
  // [n_weights], a multiple of 4: in shared memory, or (STREAM) the weights in device memory
  const float* wts = STREAM ? a.weights : base;
  float* xa = base + (STREAM ? 0 : a.n_weights);  // [DMAX][kTile]: x_res
  float* xb = xa + DMAX * kTile;                 // [DX][kTile]: q1's mean, then x_new
  float* mf = xb + DX * kTile;                   // [DX][kTile]: f's mean
  float* eb = mf + DX * kTile;                   // [1 or 2][DX][kTile]: ε
  float* hq = eb + (prefetch ? 2 : 1) * DX * kTile;  // [2][H][kTile]: q1's, then g's layers
  float* hf = hq + 2 * H * kTile;                // [2][H][kTile]: f's layers (pair)
  float* go = hf + (pair ? 2 : 0) * H * kTile;   // [DY][kTile]: g's mean (own_gm)
  float* red = go + (own_gm ? DY : 0) * kTile;   // [kParts][kTile]
  float* cb = red + kParts * kTile;              // [1 or 2][NCP]: a row's coefficients
  float* gm = !prefetch ? xa : own_gm ? go : hf + ((a.n_mid + 1) & 1) * H * kTile;
  const int tid = threadIdx.x, K = a.K;
  const int tiles_per_row = K / kTile, tiles = a.B * tiles_per_row;

  // cp.async of a tile's x_res, and its streamed ε into slot e (compute group)
  auto copy_in = [&](int tile, float* e) {
    const int k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)(tile / tiles_per_row) * DX * K;
    for (int v = tid; v < DX * (kTile / 4); v += kGroup) {
      const int d = v / (kTile / 4), q = (v % (kTile / 4)) * 4;
      const size_t g = row + (size_t)d * K + k0 + q;
      cp_async16(xa + d * kTile + q, a.x_res + g);
      if (!a.use_rng) cp_async16(e + d * kTile + q, a.eps + g);
    }
    cp_async_commit();
  };
  // a tile's coefficients into c and, in RNG mode, its ε into e: threads
  // t0, t0 + nt, ...
  auto operands = [&](int tile, float* e, float* c, int t0, int nt) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    for (int i = t0; i < NC; i += nt) c[i] = a.coef[(size_t)b * NCW + i];
    if (!a.use_rng) return;
    for (int v = t0; v < ND; v += nt) {
      const int j = v / kTile, q = v % kTile;
      bool sin_branch;
      const Ctr4 r = eps_words(a.seed0, a.seed1, b, a.t, k0 + q, K, j, &sin_branch);
      e[2 * j * kTile + q] = box_muller(r.x, r.y, sin_branch);
      if (2 * j + 1 < DX) e[(2 * j + 1) * kTile + q] = box_muller(r.z, r.w, sin_branch);
    }
  };
  if (prefetch && (int)blockIdx.x < tiles) {
    if (tid < kGroup) copy_in(blockIdx.x, eb);
    operands(blockIdx.x, eb, cb, tid, NT);
  }
  if constexpr (!STREAM) {
    for (int i = tid; i < a.n_weights / 4; i += NT) {
      reinterpret_cast<float4*>(base)[i] = reinterpret_cast<const float4*>(a.weights)[i];
    }
  }

  int slot = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, slot ^= prefetch) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)b * DX * K;
    float* ep = eb + slot * DX * kTile;
    float* cf = cb + slot * NCP;
    if (prefetch) {
      cp_async_wait<0>();
    } else {
      __syncthreads();  // the previous tile's readers are done (and the weights are in)
      move_tile<true, kTile, NT>(xa, a.x_res + row, nullptr, DX, K, k0);
      if (!a.use_rng) move_tile<true, kTile, NT>(ep, a.eps + row, nullptr, DX, K, k0);
      operands(tile, ep, cf, tid, NT);
    }
    __syncthreads();
    const int next = tile + gridDim.x;
    if (tid >= kGroup) {  // the next tile's coefficients and RNG ε, beside the compute
      if (prefetch && next < tiles) {
        operands(next, eb + (slot ^ 1) * DX * kTile, cb + (slot ^ 1) * NCP, tid - kGroup,
                 NT - kGroup);
      }
      continue;
    }

    // q1 and f on the resampled particles (with controls, their first-layer
    // bias plus the row's control terms: q1's H, then f's)
    const float* cq1 = CTRL ? a.coef + (size_t)b * NCW + NC : nullptr;
    const float* cf1 = CTRL ? cq1 + H : nullptr;
    if (pair) {
      const int half = tid / (kGroup / 2), ht = tid % (kGroup / 2);
      const float* w = wts + (half ? a.off_f : 0);
      float* h = half ? hf : hq;
      tile_layer_at<DX, H, true, kTile, kGroup / 2, RBN, H, CTRL>(w, xa, h, ht,
                                                                  half ? cf1 : cq1);
      group_sync();
      if (prefetch && next < tiles) copy_in(next, eb + (slot ^ 1) * DX * kTile);
      group_tail<DX, H, DX, kGroup / 2, RBN, row_block(DX, 8)>(w, a.n_mid, h, half ? mf : xb, ht);
    } else {
      tile_layer_at<DX, H, true, kTile, kGroup, RBG, H, CTRL>(wts, xa, hq, tid, cq1);
      group_sync();
      group_tail<DX, H, DX, kGroup, RBG, row_block(DX, 4)>(wts, a.n_mid, hq, xb, tid);
      tile_layer_at<DX, H, true, kTile, kGroup, RBG, H, CTRL>(wts + a.off_f, xa, hq, tid, cf1);
      group_sync();
      if (prefetch && next < tiles) copy_in(next, eb + (slot ^ 1) * DX * kTile);
      group_tail<DX, H, DX, kGroup, RBG, row_block(DX, 4)>(wts + a.off_f, a.n_mid, hq, mf, tid);
    }

    // the fused draw, in place of q1's mean, and x_new out
    for (int v = tid; v < DX * (kTile / 4); v += kGroup) {
      const int d = v / (kTile / 4), q = (v % (kTile / 4)) * 4;
      float* xv = xb + d * kTile + q;
      const float* ev = ep + d * kTile + q;
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = cf[DX + d] * xv[c] + cf[d] + cf[2 * DX + d] * ev[c];
      const float4 x4 = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(xv) = x4;
      *reinterpret_cast<float4*>(a.x_new + row + (size_t)d * K + k0 + q) = x4;
    }
    group_sync();

    // g on the drawn particles
    tile_layer_at<DX, H, true, kTile, kGroup, RBG>(wts + a.off_g, xb, hq, tid);
    group_sync();
    group_tail<DX, H, DY, kGroup, RBG, row_block(DY, 4)>(wts + a.off_g, a.n_mid, hq, gm, tid);

    // α: kParts threads per particle, each over every kParts-th row
    {
      const int q = tid % kTile, part = tid / kTile;
      red[part * kTile + q] =
          alpha_part<DX, DY, kTile>(xb, mf, ep, gm, cf + 3 * DX, a.sconst, q, part);
    }
    group_sync();
    if (tid < kTile) {
      a.alpha[(size_t)b * K + k0 + tid] = fmaxf(alpha_total(red, tid, cf[NC - 1]), -3e30f);
    }
  }
}

template <int DX, int DY, int H, bool CTRL, bool STREAM>
cudaError_t launch_trunk_async(const TrunkArgs& a, int pair, int prefetch, cudaStream_t stream) {
  if ((pair != 0 && pair != 1) || (prefetch != 0 && prefetch != 1)) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * async_smem_floats<DX, DY, H>(STREAM ? 0 : a.n_weights, pair, prefetch);
  auto kernel = trunk_forward_async_kernel<DX, DY, H, CTRL, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAsyncThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = a.B * (a.K / kTile);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, kAsyncThreads, smem, stream>>>(a, pair, prefetch);
  return cudaGetLastError();
}

template <int DX, int DY, int H>
cudaError_t launch_trunk(const TrunkArgs& a, cudaStream_t stream) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  const size_t smem = sizeof(float) * (a.n_weights + (DMAX + 3 * DX + 2 * H + kParts) * kTile +
                                       ((NC + 3) / 4) * 4);
  auto kernel = trunk_forward_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTrunkThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = a.B * (a.K / kTile);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, kTrunkThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One (Dx, Dy, hidden)'s launch: design 0 the async design, its weights in
// shared memory (weights 0) or, in a shape library whose plan says so, in
// device memory (weights 1); 1 the tile design (uncontrolled, weights in
// shared memory, the kernels' own library only).
template <int DX, int DY, int H, bool CTRL, int WEIGHTS>
int launch_design(const TrunkArgs& a, int design, int pair, int prefetch, int weights,
                  cudaStream_t s) {
  if (weights != WEIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  if (design == 0) {
    return static_cast<int>(launch_trunk_async<DX, DY, H, CTRL, WEIGHTS == 1>(a, pair, prefetch, s));
  }
#ifndef PSVO_TRUNK_DX
  if constexpr (!CTRL) {
    if (design == 1) return static_cast<int>(launch_trunk<DX, DY, H>(a, s));
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DX, int DY, bool CTRL>
int launch_widths(const TrunkArgs& a, int hidden, int design, int pair, int prefetch,
                  int weights, cudaStream_t s) {
  switch (hidden) {
    case 16: return launch_design<DX, DY, 16, CTRL, 0>(a, design, pair, prefetch, weights, s);
    case 32: return launch_design<DX, DY, 32, CTRL, 0>(a, design, pair, prefetch, weights, s);
    case 64: return launch_design<DX, DY, 64, CTRL, 0>(a, design, pair, prefetch, weights, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9 with or without controls; returns a cudaError_t. The kernels' library
// instantiates the presets' (Dx, Dy) = (2, 2), (3, 3), (40, 40) (ops/trunk.py::
// TRUNK_DIMS) at hidden 16/32/64, weights in shared memory; a trunk shape
// library (ops/_build.py::load_shape_library) the one shape and weights plan
// that its PSVO_TRUNK_* macros name. Instantiated once per CTRL, each in its
// own translation unit.
template <bool CTRL>
int dispatch_trunk_forward(const TrunkArgs& a, int dx, int dy, int hidden, int design, int pair,
                           int prefetch, int weights, cudaStream_t s) {
#ifdef PSVO_TRUNK_DX
  if (dx == PSVO_TRUNK_DX && dy == PSVO_TRUNK_DY && hidden == PSVO_TRUNK_H) {
    return launch_design<PSVO_TRUNK_DX, PSVO_TRUNK_DY, PSVO_TRUNK_H, CTRL, PSVO_TRUNK_K9>(
        a, design, pair, prefetch, weights, s);
  }
#else
  if (dx == 2 && dy == 2) return launch_widths<2, 2, CTRL>(a, hidden, design, pair, prefetch, weights, s);
  if (dx == 3 && dy == 3) return launch_widths<3, 3, CTRL>(a, hidden, design, pair, prefetch, weights, s);
  if (dx == 40 && dy == 40) {
    return launch_widths<40, 40, CTRL>(a, hidden, design, pair, prefetch, weights, s);
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace psvo
