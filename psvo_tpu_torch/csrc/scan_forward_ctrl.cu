// K1 scan_forward and K14 step_forward in their control mode (CTRL = true,
// data.di > 0; scan_forward.cuh says how the controls enter): the kernels of
// scan_forward.cuh built in a translation unit of their own, so that nvcc
// compiles the two modes in parallel. scan_forward.cu's entry points call
// these with ctrl = 1.
#include <cuda_runtime.h>

#include "scan_forward.cuh"

namespace psvo {

int scan_forward_launch_ctrl(const ScanArgs& a, int dx, int dy, int hidden, cudaStream_t s) {
  return scan_forward_launch<true>(a, dx, dy, hidden, s);
}

int scan_forward_max_active_ctrl(int dx, int dy, int hidden, int cluster, size_t smem, int* out) {
  return scan_forward_max_active<true>(dx, dy, hidden, cluster, smem, out);
}

int step_forward_launch_ctrl(const StepArgs& a, int dx, int dy, int hidden, cudaStream_t s) {
  return step_forward_launch<true>(a, dx, dy, hidden, s);
}

int step_forward_resident_ctrl(int dx, int dy, int hidden, size_t smem, int* out) {
  return step_forward_resident<true>(dx, dy, hidden, smem, out);
}

}  // namespace psvo
