// K2 stream_noise: materialize the noise that scan_forward and trunk_forward
// draw in their in-kernel RNG mode — eps [T1, B, dx, K] and the systematic
// offsets u0 [T1, B] — through the same device functions and counter layout
// (philox.cuh), so the plain filter can replay exactly what the kernels drew.
//
// Replaces psvo_tpu/ops/pallas_step.py::generate_stream_noise and
// psvo_tpu/ops/pallas_trunk.py::generate_trunk_noise. Any state width: the
// counter layout gives rows 2j and 2j + 1 one Philox call per particle, so
// the draw of a particle does not depend on how a kernel tiles K. Bounded by
// its device-memory writes (4·T1·B·dx·K bytes) at small dx, by the Philox
// and Box-Muller arithmetic at dx = 40; one block per (t, row), consecutive
// threads on consecutive particles, so the stores coalesce.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace psvo {

__global__ void stream_noise_kernel(uint32_t k0, uint32_t k1, int B, int dx, int K, float* eps,
                                    float* u0) {
  const int row = blockIdx.x % B, t = blockIdx.x / B;
  float* base = eps + (size_t)blockIdx.x * dx * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    for (int j = 0; 2 * j < dx; ++j) {
      bool sin_branch;
      const Ctr4 r = eps_words(k0, k1, row, t, i, K, j, &sin_branch);
      base[(size_t)(2 * j) * K + i] = box_muller(r.x, r.y, sin_branch);
      if (2 * j + 1 < dx) base[(size_t)(2 * j + 1) * K + i] = box_muller(r.z, r.w, sin_branch);
    }
  }
  if (threadIdx.x == 0) u0[blockIdx.x] = draw_u0(k0, k1, row, t);
}

}  // namespace psvo

extern "C" int psvo_stream_noise(float* eps, float* u0, uint32_t seed0, uint32_t seed1,
                                 int T1, int B, int dx, int K, void* stream) {
  psvo::stream_noise_kernel<<<T1 * B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      seed0, seed1, B, dx, K, eps, u0);
  return static_cast<int>(cudaGetLastError());
}
