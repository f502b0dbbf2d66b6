// K9 trunk_forward without controls, and its C entry point; the kernels are
// in trunk_forward.cuh, their control mode in trunk_forward_ctrl.cu.
#include "trunk_forward.cuh"

namespace psvo {
template int dispatch_trunk_forward<false>(const TrunkArgs&, int, int, int, int, int, int,
                                           int, cudaStream_t);
extern template int dispatch_trunk_forward<true>(const TrunkArgs&, int, int, int, int, int, int,
                                                 int, cudaStream_t);
}  // namespace psvo

// Plain C entry point (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Returns a cudaError_t; the launch is checked with cudaGetLastError().
// design 0: the async design (pair, prefetch: its parts that fit, as
// ops/trunk.py::k9_plan picks them); 1: the tile design (pair and prefetch
// unread; no control mode). wplan 0: the nets in shared memory, 1: in
// device memory (ops/trunk.py::k9_weights, a trunk shape library's plan).
// ctrl 1: the coef rows carry the controls' first-layer terms of q1 and f
// (2·hidden more columns).
extern "C" int psvo_trunk_forward(const float* x_res, const float* eps, const float* coef,
                                  const float* weights, const float* sconst, float* x_new,
                                  float* alpha, uint32_t seed0, uint32_t seed1, int use_rng, int t,
                                  int B, int K, int dx, int dy, int hidden, int n_mid,
                                  int n_weights, int off_f, int off_g, int design, int pair,
                                  int prefetch, int wplan, int ctrl, void* stream) {
  const psvo::TrunkArgs a{x_res, eps,   coef,    weights, sconst, x_new, alpha, seed0, seed1,
                          use_rng, t,   B,       K,       n_mid,  n_weights, off_f, off_g};
  const auto s = static_cast<cudaStream_t>(stream);
  if (ctrl == 1) {
    return psvo::dispatch_trunk_forward<true>(a, dx, dy, hidden, design, pair, prefetch, wplan, s);
  }
  if (ctrl == 0) {
    return psvo::dispatch_trunk_forward<false>(a, dx, dy, hidden, design, pair, prefetch, wplan,
                                               s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef PSVO_TRUNK_DX
// A trunk shape library's own error strings (the kernels' library has them
// in scan_forward.cu).
extern "C" const char* psvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
