// The per-particle log-weight shared by the forward scan (scan_forward.cu)
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
#pragma once

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

}  // namespace psvo
