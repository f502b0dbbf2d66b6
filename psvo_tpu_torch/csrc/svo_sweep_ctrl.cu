// K12 svo_sweep_forward and K13 svo_sweep_backward in their control mode
// (CTRL = true, data.di > 0; svo_sweep.cuh says how the controls enter): the
// split designs of svo_sweep.cuh built in a translation unit of their own, so
// that nvcc compiles the two modes in parallel. svo_sweep.cu's entry points
// call these with a non-null cbias.
#include <cuda_runtime.h>

#include "svo_sweep.cuh"

namespace psvo {
namespace svo {

template <int DX, int DY, int H>
struct ForwardCtrl {
  static int run(const FwdArgs& a, int paths, int tile_rows, int steps, cudaStream_t s) {
    return static_cast<int>(launch_forward_split<DX, DY, H, true>(a, paths, tile_rows, steps, s));
  }
};

template <int DX, int DY, int H>
struct BackwardCtrl {
  static int run(const BwdArgs& a, int max_ctas, int rows, int paths, float* grads,
                 cudaStream_t s) {
    return static_cast<int>(
        launch_backward_split<DX, DY, H, true>(a, max_ctas, rows, paths, grads, s));
  }
};

int forward_ctrl(const FwdArgs& a, int dx, int dy, int hidden, int paths, int tile_rows, int steps,
                 cudaStream_t s) {
  return dispatch<ForwardCtrl>(dx, dy, hidden, a, paths, tile_rows, steps, s);
}

int backward_ctrl(const BwdArgs& a, int dx, int dy, int hidden, int max_ctas, int rows, int paths,
                  float* grads, cudaStream_t s) {
  return dispatch<BackwardCtrl>(dx, dy, hidden, a, max_ctas, rows, paths, grads, s);
}

}  // namespace svo
}  // namespace psvo
