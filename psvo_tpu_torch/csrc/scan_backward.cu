// K4 scan_backward: its instantiations and C entry point; the kernels are
// in scan_backward.cuh, K15's entry point in step_backward.cu.
#include "scan_backward.cuh"

namespace psvo {

int scan_backward_max_active(int dx, int dy, int hidden, int cluster, int smem, int* out) {
  return with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    return max_active_clusters(
        scan_backward_kernel<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>, cluster,
        static_cast<size_t>(smem), out);
  });
}

}  // namespace psvo

// Plain C entry points (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// grads [n_weights + dx + dy] receives the weight gradients, then d_sconst;
// partial [B·cluster, n_weights + dx + dy] (K15: [B·slices, ...]) is
// scratch. Each returns a cudaError_t.
extern "C" int psvo_scan_backward(const float* x0, const float* x_all, const int* idx,
                                  const float* stats, const float* coef, const float* eps,
                                  const float* weights, const float* sconst,
                                  const float* d_stats, const float* d_x_last,
                                  const float* d_alpha_last, const float* d_x_all,
                                  const float* d_alpha_all, float* d_x0, float* d_coef,
                                  float* partial, float* grads, uint32_t seed0, uint32_t seed1,
                                  int use_rng, int B, int K, int T1, int dx, int dy, int hidden,
                                  int n_mid, int n_weights, int off_f, int off_g, int ctrl,
                                  int cluster, void* stream) {
  const psvo::BwdArgs a{x0,      x_all,    idx,      stats,        coef,    eps,
                        weights, sconst,   d_stats,  d_x_last,     d_alpha_last,
                        d_x_all, d_alpha_all, d_x0,  d_coef,       partial, seed0,
                        seed1,   use_rng,  B,        K,            T1,      n_weights,
                        off_f,   off_g,    ctrl,     cluster};
  if (cluster < 1 || K % cluster != 0 || (cluster > 1 && (K / cluster) % psvo::kP != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return psvo::with_dims(dx, dy, hidden, [&](auto d) {
    using D = decltype(d);
    if (n_mid != D::NMID) return cudaErrorInvalidValue;  // the depth is instantiated
    const int n = n_weights + D::DX + D::DY;
    cudaError_t err = psvo::launch_clusters(
        psvo::scan_backward_kernel<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>, a, B, cluster,
        psvo::bwd_smem_bytes<D::DX, D::DY, D::H, D::NMID, D::BWD, D::BP>(
            n_weights, K, K / cluster, true, cluster, ctrl != 0),
        s);
    if (err != cudaSuccess) return err;
    return psvo::sum_rows(partial, B * cluster, n, grads, s);
  });
}

