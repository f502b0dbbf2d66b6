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
// Also with_dims, the dispatch of the four kernels' C entry points to their
// instantiated shapes.
#pragma once

#include <cuda_runtime.h>

namespace psvo {

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

template <int DX_, int DY_, int H_>
struct Dims {
  static constexpr int DX = DX_, DY = DY_, H = H_;
};

// f(Dims<DX, DY, H>{}) for an instantiated shape: (Dx, Dy) ∈ {(2, 2), (3, 3)}
// (FitzHugh-Nagumo, Lorenz-63) and hidden width 16, 32 or 64. Returns f's
// cudaError_t as an int, or cudaErrorInvalidValue for any other shape.
template <class F>
int with_dims(int dx, int dy, int hidden, F&& f) {
  if (dx == 2 && dy == 2) {
    switch (hidden) {
      case 16: return static_cast<int>(f(Dims<2, 2, 16>{}));
      case 32: return static_cast<int>(f(Dims<2, 2, 32>{}));
      case 64: return static_cast<int>(f(Dims<2, 2, 64>{}));
      default: break;
    }
  }
  if (dx == 3 && dy == 3) {
    switch (hidden) {
      case 16: return static_cast<int>(f(Dims<3, 3, 16>{}));
      case 32: return static_cast<int>(f(Dims<3, 3, 32>{}));
      case 64: return static_cast<int>(f(Dims<3, 3, 64>{}));
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace psvo
