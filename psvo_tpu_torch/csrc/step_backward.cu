// K15 step_backward: its instantiations and C entry point; the kernels are
// in scan_backward.cuh, K4's entry point in scan_backward.cu.
#include "scan_backward.cuh"

namespace psvo {

int step_backward_resident(int dx, int dy, int hidden, int smem, int* out) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return max_resident(step_backward_kernel<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>,
                        static_cast<size_t>(smem), out);
  });
}

}  // namespace psvo

// K15 on `slices` CTAs per row; dxres [B, dx, K] and coef_part [B, slices,
// 3·dx + 1 (+ 2·hidden with ctrl)] are scratch, counter [B] is 0 before the
// launch and after it.
extern "C" int psvo_step_backward(const float* x, const float* x_new, const int* idx,
                                  const float* stats, const float* coef, const float* eps,
                                  const float* weights, const float* sconst,
                                  const float* d_stats, const float* d_x_new,
                                  const float* d_alpha, float* d_x, float* d_coef, float* dxres,
                                  float* coef_part, float* partial, float* grads, int* counter,
                                  int B, int K, int dx, int dy, int hidden, int n_mid,
                                  int n_weights, int off_f, int off_g, int ctrl, int slices,
                                  void* stream) {
  const psvo::StepBwdArgs a{x,       x_new,   idx,       stats,   coef,      eps,
                            weights, sconst,  d_stats,   d_x_new, d_alpha,   d_x,
                            d_coef,  dxres,   coef_part, partial, counter,   B,
                            K,       n_weights, off_f,   off_g,   ctrl,      slices};
  if (slices < 1 || K % slices != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return psvo::with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    if (n_mid != D::NMID) return cudaErrorInvalidValue;  // the depth is instantiated
    // the last CTA stages the row's K ancestors in its idle tiles where they fit
    const int k_idx = K > psvo::BwdLayout<D::H, D::NMID, D::BWD, D::BP>::kTileFloats ? K : 0;
    cudaError_t err = psvo::launch_slices(
        psvo::step_backward_kernel<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>, a, B, slices,
        psvo::bwd_smem_bytes<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>(n_weights, k_idx, 0,
                                                                         false, 1, ctrl != 0),
        s);
    if (err != cudaSuccess) return err;
    return psvo::sum_rows(partial, B * slices, n_weights + D::DX + D::DY, grads, s);
  });
}
