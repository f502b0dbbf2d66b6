// K12 svo_sweep_forward and K13 svo_sweep_backward: the C entry points, and
// the builds without controls (CTRL = false). The kernels are in
// svo_sweep.cuh (its comment gives their design); svo_sweep_ctrl.cu builds
// the split designs' control mode, which the entry points reach with a
// non-null cbias.
#include <cuda_runtime.h>

#include <cstdint>

#include "svo_sweep.cuh"

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Each returns a cudaError_t. K12's design: 0 the split design (paths paths a
// CTA, tile_rows rows a tile of its parallel pass, steps steps a chunk), 1 the
// chain design (paths, tile_rows and steps unread). grads [n_weights + 2*dx +
// dy + 3] receives the weight gradients, then sc's; partial [max_ctas,
// n_weights + 2*dx + dy + 3 rounded up to 4] is scratch. K13's design: 0 the split design
// (tile_rows rows a tile, paths paths a CTA group), 1 the chain design
// (tile_rows and paths unread). A non-null cbias [T1, B, hidden] (f's control
// bias) runs the split design's control mode (design 0 only); K13 then also
// writes d_cbias [T1, B, hidden], with bias_part [T1, B, (M - 1) / paths + 2,
// hidden] as scratch.
extern "C" int psvo_svo_forward(const float* x_anchor, const float* eps, const float* y,
                                const float* weights, const float* sc, const float* cbias,
                                float* x_first, float* lp, float* lq, float* xtilde, int B, int M,
                                int T1, int dx, int dy, int hidden, int n_mid, int n_weights,
                                int off_f, int off_g, int design, int paths, int tile_rows,
                                int steps, void* stream) {
  const psvo::svo::FwdArgs a{x_anchor, eps, y,  weights, sc,    x_first,   lp,    lq,
                             xtilde,   B,   M,  T1,      n_mid, n_weights, off_f, off_g,
                             cbias};
  const auto s = static_cast<cudaStream_t>(stream);
  if (cbias != nullptr) {
    return design == 0 ? psvo::svo::forward_ctrl(a, dx, dy, hidden, paths, tile_rows, steps, s)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
  return psvo::svo::dispatch<psvo::svo::Forward>(dx, dy, hidden, a, design, paths, tile_rows,
                                                 steps, s);
}

extern "C" int psvo_svo_backward(const float* x_anchor, const float* eps, const float* y,
                                 const float* weights, const float* sc, const float* cbias,
                                 const float* xtilde, const float* d_x_first, const float* d_lp,
                                 const float* d_lq, const float* d_xtilde, float* d_x_anchor,
                                 float* partial, float* grads, float* bias_part, float* d_cbias,
                                 int B, int M, int T1, int dx, int dy, int hidden, int n_mid,
                                 int n_weights, int off_f, int off_g, int max_ctas, int design,
                                 int tile_rows, int paths, void* stream) {
  const psvo::svo::BwdArgs a{x_anchor, eps,       y,     weights,  sc,     xtilde,     d_x_first,
                             d_lp,     d_lq,      d_xtilde, d_x_anchor, partial, B, M,
                             T1,       n_mid,     n_weights, off_f,  off_g,  cbias,  bias_part,
                             d_cbias};
  const auto s = static_cast<cudaStream_t>(stream);
  if (cbias != nullptr) {
    const bool ok = design == 0 && bias_part != nullptr && d_cbias != nullptr;
    return ok ? psvo::svo::backward_ctrl(a, dx, dy, hidden, max_ctas, tile_rows, paths, grads, s)
              : static_cast<int>(cudaErrorInvalidValue);
  }
  return psvo::svo::dispatch<psvo::svo::Backward>(dx, dy, hidden, a, max_ctas, design, tile_rows,
                                                  paths, grads, s);
}

#ifdef PSVO_SVO_DX
// An SVO shape library's own error strings (the kernels' library has them in
// scan_forward.cu).
extern "C" const char* psvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
