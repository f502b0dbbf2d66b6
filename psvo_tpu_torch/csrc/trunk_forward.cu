// K9 trunk_forward: one filtering step after the resample, for wide states.
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
// ε is either a streamed operand [B, Dx, K] or drawn in the kernel from a
// two-word seed and the step t with K2's counter layout (philox.cuh), per
// particle: the draw of a particle does not depend on the tiling, so K2
// extracts exactly the ε this kernel used (the TPU kernel's per-tile seed
// fold, and its rng_tiles_ok gate, have no counterpart here).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "trunk_tile.cuh"

namespace psvo {

struct TrunkArgs {
  const float* x_res;    // [B, DX, K]
  const float* eps;      // [B, DX, K]; stream mode only
  const float* coef;     // [B, 3*DX + DY + 1]: aq, cq, sq, y, ab of this step
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

}  // namespace psvo

// Plain C entry point (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Returns a cudaError_t; the launch is checked with cudaGetLastError().
extern "C" int psvo_trunk_forward(const float* x_res, const float* eps, const float* coef,
                                  const float* weights, const float* sconst, float* x_new,
                                  float* alpha, uint32_t seed0, uint32_t seed1, int use_rng, int t,
                                  int B, int K, int dx, int dy, int hidden, int n_mid,
                                  int n_weights, int off_f, int off_g, void* stream) {
  const psvo::TrunkArgs a{x_res, eps,   coef,    weights, sconst, x_new, alpha, seed0, seed1,
                          use_rng, t,   B,       K,       n_mid,  n_weights, off_f, off_g};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dx == 40 && dy == 40) {  // Lorenz-96
    switch (hidden) {
      case 16: return psvo::launch_trunk<40, 40, 16>(a, s);
      case 32: return psvo::launch_trunk<40, 40, 32>(a, s);
      case 64: return psvo::launch_trunk<40, 40, 64>(a, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
