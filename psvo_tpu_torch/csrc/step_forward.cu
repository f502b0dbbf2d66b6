// K14 step_forward: its C entry points and its build without controls (CTRL
// = false); step_forward_ctrl.cu builds its control mode. The kernels are in
// scan_forward.cuh, K1's entry points in scan_forward.cu.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_forward.cuh"

// K14 on `slices` CTAs per row; counter [B] is 0 before the launch and after it.
extern "C" int psvo_step_forward(const float* x, const float* logw, const float* coef,
                                 const float* eps, const float* pos, const float* weights,
                                 const float* sconst, float* x_new, float* alpha, float* stats,
                                 int* idx, int* counter, int B, int K, int dx, int dy, int hidden,
                                 int n_mid, int n_weights, int off_f, int off_g, int ctrl,
                                 int slices, void* stream) {
  const psvo::StepArgs a{x,     logw,  coef,    eps, pos,   weights, sconst,    x_new, alpha,
                         stats, idx,   counter, B,   K,     n_mid,   n_weights, off_f, off_g,
                         slices};
  if (slices < 1 || K % slices != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return ctrl ? psvo::step_forward_launch_ctrl(a, dx, dy, hidden, s)
              : psvo::step_forward_launch<false>(a, dx, dy, hidden, s);
}

// How many CTAs of K14 (kernel 0; its control build with ctrl) or K15
// (kernel 1, one build) with `smem` bytes each the current device holds at
// once, at (dx, dy, hidden), into *out. fused_step.step_slices picks S from it.
extern "C" int psvo_step_max_active(int kernel, int dx, int dy, int hidden, int ctrl, int smem,
                                    int* out) {
  if (kernel == 1) return psvo::step_backward_resident(dx, dy, hidden, smem, out);
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto sm = static_cast<size_t>(smem);
  return ctrl ? psvo::step_forward_resident_ctrl(dx, dy, hidden, sm, out)
              : psvo::step_forward_resident<false>(dx, dy, hidden, sm, out);
}

