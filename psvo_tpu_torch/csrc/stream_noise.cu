// K2 stream_noise: materialize the noise that scan_forward draws in its
// in-kernel RNG mode — eps [T1, B, DX, K] and the systematic offsets u0
// [T1, B] — through the same device functions and counter layout
// (philox.cuh), so the plain filter can replay exactly what the kernel drew.
//
// Replaces psvo_tpu/ops/pallas_step.py::generate_stream_noise. Bounded by
// its device-memory writes (4·T1·B·DX·K bytes); one block per (t, row),
// consecutive threads on consecutive particles, so the stores coalesce.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace psvo {

template <int DX>
__global__ void stream_noise_kernel(uint32_t k0, uint32_t k1, int B, int K, float* eps,
                                    float* u0) {
  const int row = blockIdx.x % B, t = blockIdx.x / B;
  const size_t base = (size_t)blockIdx.x * DX * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float e[DX];
    draw_eps<DX>(k0, k1, row, t, i, K, e);
#pragma unroll
    for (int d = 0; d < DX; ++d) eps[base + (size_t)d * K + i] = e[d];
  }
  if (threadIdx.x == 0) u0[blockIdx.x] = draw_u0(k0, k1, row, t);
}

template <int DX>
cudaError_t launch_noise(uint32_t k0, uint32_t k1, int T1, int B, int K, float* eps,
                         float* u0, cudaStream_t stream) {
  stream_noise_kernel<DX><<<T1 * B, 256, 0, stream>>>(k0, k1, B, K, eps, u0);
  return cudaGetLastError();
}

}  // namespace psvo

extern "C" int psvo_stream_noise(float* eps, float* u0, uint32_t seed0, uint32_t seed1,
                                 int T1, int B, int dx, int K, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dx) {
    case 1: return psvo::launch_noise<1>(seed0, seed1, T1, B, K, eps, u0, s);
    case 2: return psvo::launch_noise<2>(seed0, seed1, T1, B, K, eps, u0, s);
    case 3: return psvo::launch_noise<3>(seed0, seed1, T1, B, K, eps, u0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
