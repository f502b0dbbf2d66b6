// The per-particle log-weight shared by the forward scan (scan_forward.cuh)
// and its backward (scan_backward.cu), so that the backward's recompute of α
// is the forward's own arithmetic and its −3e30 floor cut falls on exactly
// the particles the forward floored.
//
// Replaces the α line of psvo_tpu/ops/pallas_step.py::_propose_weight_core
// (and its rebuild in _propose_weight_bwd_core):
//   α = −½ Σ_d (z_f² − ε²) − ½ Σ_e z_g² + ab,
//   z_f = (x_new − m_f) / s_f,  z_g = (y − m_g) / s_g,
// with every K-independent constant folded into ab. The caller applies the
// floor max(α, −3e30).
//
// Also the plans and with_dims, the dispatch of the four kernels' C entry
// points to their instantiated shapes.
#pragma once

#include <cuda_runtime.h>

namespace psvo {

// The fused draw x_new = cq·m1 + aq + sq·ε, both products contracted:
// fma(sq, ε, fma(cq, m1, aq)). Written out so that K1 and K14, which both
// inline it, round alike at every shape: left to the compiler, the two
// kernels contracted the expression differently at hidden width 8.
__device__ __forceinline__ float fused_draw(float cq, float m1, float aq, float sq, float e) {
  return __fmaf_rn(sq, e, __fmaf_rn(cq, m1, aq));
}

template <int DX, int DY>
__device__ __forceinline__ float alpha_unfloored(const float (&xn)[DX], const float (&mf)[DX],
                                                 const float (&e)[DX], const float (&y)[DY],
                                                 const float (&mg)[DY], const float (&sfi)[DX],
                                                 const float (&sgi)[DY], float ab) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < DX; ++d) {
    const float zf = (xn[d] - mf[d]) * sfi[d];
    acc += zf * zf - e[d] * e[d];
  }
#pragma unroll
  for (int q = 0; q < DY; ++q) {
    const float zg = (y[q] - mg[q]) * sgi[q];
    acc += zg * zg;
  }
  return -0.5f * acc + ab;
}

// Where the four kernels keep what does not fit a CTA's shared memory at
// the larger shapes of the class (fused_step.k1_plan / k4_plan choose):
// K1/K14 the weights (kFwdSmem: shared memory; kFwdStream: device memory,
// read through L1) and, at widths whose register trunk would spill
// (kFwdTile), also the activations: the trunks run over tiles of FP particles
// in shared memory (step_tiles.cuh), with the weights in device memory;
// K4/K15 the weights, their gradient sums and the
// activation tiles (kBwdSmem: all in shared memory, f's and g's tiles side
// by side; kBwdGlobal: the gradient sums in the CTA's row of `partial`;
// kBwdSplit: also one net's tiles at a time, g recomputed for its backward;
// kBwdStream: also the weights in device memory). Every plan gives the same
// bits: the same adds in the same order by the same owning thread.
enum FwdPlan { kFwdSmem = 0, kFwdStream = 1, kFwdTile = 2 };
enum BwdPlan { kBwdSmem = 0, kBwdGlobal = 1, kBwdSplit = 2, kBwdStream = 3 };

// One instantiated shape: state and observation widths, the hidden width,
// K4/K15's middle layers (K1 and K14 take any depth at run time), the plans,
// under kFwdTile the particles of K1's and K14's tiles (FP) and the particles
// of K4's and K15's tiles (BP: 64 but where a wide net's tiles fit only
// smaller, under kBwdStream).
template <int DX_, int DY_, int H_, int NMID_ = 1, int FWD_ = kFwdSmem, int BWD_ = kBwdSmem,
          int FP_ = 64, int BP_ = 64>
struct Dims {
  static constexpr int DX = DX_, DY = DY_, H = H_, NMID = NMID_, FWD = FWD_, BWD = BWD_,
                       FP = FP_, BP = BP_;
};

// f(Dims<...>{}) for an instantiated shape; returns f's cudaError_t as an
// int, or cudaErrorInvalidValue for any other shape. The kernels' library
// (ops/_build.py::load_library) holds the presets' shapes, those of
// prebuilt_shapes.cuh: one middle layer in K4/K15, every plan in shared
// memory. A shape library (_build.load_shape_library) is built for one other
// shape of the class, named by the PSVO_SHAPE_* macros, and holds that shape
// alone (PSVO_SHAPE_FP only under the tiled plan, PSVO_SHAPE_BP only where
// K4's tiles are narrower than 64 particles).
template <class F>
int with_dims(int dx, int dy, int hidden, F&& f) {
#ifdef PSVO_SHAPE_DX
#ifndef PSVO_SHAPE_FP
#define PSVO_SHAPE_FP 64
#endif
#ifndef PSVO_SHAPE_BP
#define PSVO_SHAPE_BP 64
#endif
  if (dx == PSVO_SHAPE_DX && dy == PSVO_SHAPE_DY && hidden == PSVO_SHAPE_H)
    return static_cast<int>(f(Dims<PSVO_SHAPE_DX, PSVO_SHAPE_DY, PSVO_SHAPE_H, PSVO_SHAPE_NMID,
                                   PSVO_SHAPE_FWD, PSVO_SHAPE_BWD, PSVO_SHAPE_FP,
                                   PSVO_SHAPE_BP>{}));
#else
#define PSVO_PREBUILT(DX, DY, H) \
  if (dx == DX && dy == DY && hidden == H) return static_cast<int>(f(Dims<DX, DY, H>{}));
#include "prebuilt_shapes.cuh"
#undef PSVO_PREBUILT
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace psvo
