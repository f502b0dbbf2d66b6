// K1 scan_forward in its control mode (CTRL = true, data.di > 0;
// scan_forward.cuh says how the controls enter): the kernel of
// scan_forward.cuh built in a translation unit of its own, so that nvcc
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

}  // namespace psvo
