// K1 scan_forward: its C entry points and its build without controls (CTRL
// = false). The kernels are in scan_forward.cuh (its comment gives their
// design); scan_forward_ctrl.cu builds K1's control mode, which the entry
// points reach with ctrl = 1; step_forward.cu and step_forward_ctrl.cu do
// the same for K14, so that nvcc compiles the four in parallel.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_forward.cuh"

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Each returns a cudaError_t; the launch is checked with cudaGetLastError().
extern "C" int psvo_scan_forward(const float* x0, const float* alpha0, const float* coef,
                                 const float* eps, const float* pos, const float* weights,
                                 const float* sconst, float* x_last, float* alpha_last,
                                 float* stats, float* x_all, float* alpha_all, int* idx,
                                 uint32_t seed0, uint32_t seed1, int use_rng, int B, int K,
                                 int T1, int dx, int dy, int hidden, int n_mid, int n_weights,
                                 int off_f, int off_g, int ctrl, int cluster, void* stream) {
  const psvo::ScanArgs a{x0,    alpha0,    coef,   eps,       pos,   weights, sconst,
                         x_last, alpha_last, stats, x_all,     alpha_all, idx, seed0,
                         seed1,  use_rng,   B,      K,         T1,    n_mid,  n_weights,
                         off_f,  off_g,     cluster};
  if (cluster < 1 || K % cluster != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return ctrl ? psvo::scan_forward_launch_ctrl(a, dx, dy, hidden, s)
              : psvo::scan_forward_launch<false>(a, dx, dy, hidden, s);
}

// How many clusters of `cluster` CTAs with `smem` bytes each can be resident
// at once (cluster.cuh::max_active_clusters), into *out, for K1 (kernel 0;
// its control build with ctrl) or K4 (kernel 1, one build) at (dx, dy,
// hidden). fused_step.cluster_size picks C from it.
extern "C" int psvo_max_active_clusters(int kernel, int dx, int dy, int hidden, int ctrl,
                                        int cluster, int smem, int* out) {
  if (kernel == 1) return psvo::scan_backward_max_active(dx, dy, hidden, cluster, smem, out);
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto sm = static_cast<size_t>(smem);
  return ctrl ? psvo::scan_forward_max_active_ctrl(dx, dy, hidden, cluster, sm, out)
              : psvo::scan_forward_max_active<false>(dx, dy, hidden, cluster, sm, out);
}

// Message of a CUDA error code returned by the entry points.
extern "C" const char* psvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
