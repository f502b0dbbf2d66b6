// K14 step_forward in its control mode (CTRL = true; scan_forward.cuh says
// how the controls enter), a translation unit of its own so that nvcc
// compiles it beside the other builds. step_forward.cu's entry points call
// these with ctrl = 1.
#include <cuda_runtime.h>

#include "scan_forward.cuh"

namespace psvo {

int step_forward_launch_ctrl(const StepArgs& a, int dx, int dy, int hidden, cudaStream_t s) {
  return step_forward_launch<true>(a, dx, dy, hidden, s);
}

int step_forward_resident_ctrl(int dx, int dy, int hidden, size_t smem, int* out) {
  return step_forward_resident<true>(dx, dy, hidden, smem, out);
}

}  // namespace psvo
