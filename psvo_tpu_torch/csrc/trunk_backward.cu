// K10 trunk_backward without controls, and its C entry point; the kernels
// are in trunk_backward.cuh, their control mode in trunk_backward_ctrl.cu.
#include "trunk_backward.cuh"

namespace psvo {
template int dispatch_trunk_backward<false>(const TrunkBwdArgs&, int, int, int, int, int, int,
                                            float*, float*, cudaStream_t);
extern template int dispatch_trunk_backward<true>(const TrunkBwdArgs&, int, int, int, int, int, int,
                                                  float*, float*, cudaStream_t);
}  // namespace psvo

// Plain C entry point (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// design 0 launches the tensor-core kernel (Dx = Dy = 40), 1 the previous
// one. grads [n_weights + dx + dy] receives the weight gradients, then
// d_sconst; d_coef [B, 3·dx + dy + 1 (+ 2·hidden with ctrl)]; partial
// [max_ctas, n_weights + dx + dy] and coef_part [B·K/64, 3·dx + 1 (+ 2·hidden)]
// are scratch. ctrl 1: the coef rows carry the controls' first-layer terms
// of q1 and f, whose d_coef columns get the per-row sums of those layers'
// cotangents. wplan 0: the nets in shared memory, 1: in device memory (the
// previous design in a trunk shape library; ops/trunk.py::k10_weights).
// Returns a cudaError_t.
extern "C" int psvo_trunk_backward(const float* x_res, const float* x_new, const float* eps,
                                   const float* coef, const float* weights, const float* sconst,
                                   const float* d_x_new, const float* d_alpha, float* d_x_res,
                                   float* partial, float* coef_part, float* grads, float* d_coef,
                                   uint32_t seed0, uint32_t seed1, int use_rng, int t, int B,
                                   int K, int dx, int dy, int hidden, int n_mid, int n_weights,
                                   int off_f, int off_g, int max_ctas, int design, int wplan,
                                   int ctrl, void* stream) {
  const psvo::TrunkBwdArgs a{x_res, x_new, eps,     coef,     weights, sconst, d_x_new,
                             d_alpha, d_x_res, partial, coef_part, seed0, seed1, use_rng,
                             t,     B,       K,       n_mid,    n_weights, off_f, off_g};
  const auto s = static_cast<cudaStream_t>(stream);
  if (ctrl == 1) {
    return psvo::dispatch_trunk_backward<true>(a, dx, dy, hidden, design, wplan, max_ctas, grads,
                                               d_coef, s);
  }
  if (ctrl == 0) {
    return psvo::dispatch_trunk_backward<false>(a, dx, dy, hidden, design, wplan, max_ctas,
                                                grads, d_coef, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
