// K2 stream_noise: materialize the noise that scan_forward and trunk_forward
// draw in their in-kernel RNG mode — eps [T1, B, dx, K] and the systematic
// offsets u0 [T1, B] — through the same device functions and counter layout
// (philox.cuh), so the plain filter can replay exactly what the kernels drew.
//
// Replaces psvo_tpu/ops/pallas_step.py::generate_stream_noise and
// psvo_tpu/ops/pallas_trunk.py::generate_trunk_noise. Any state width: the
// counter layout gives rows 2j and 2j + 1 one Philox call per particle pair,
// so the draw of a particle does not depend on how a kernel tiles K.
//
// What bounds it: its device-memory writes (4·T1·B·dx·K bytes: 31.5 MB, 0.0094
// ms at [3, 8, 40, 8192]) and, of the same order once each draw is made once,
// the integer rate of Philox4x32-10. Two designs, with the same bits:
//
// "pair" (stream_noise_pair_kernel, the one every caller takes): one thread
// per (t, row, pair p, group j). It makes the pair's one Philox call, one
// logf and sqrtf per (u1, u2) and the cos and the sin of the same angle
// (box_muller_pair, box_muller's operations), and writes the four normals:
// rows 2j and 2j + 1, particles p and p + K/2. The grid spans (t·B + row) ×
// groups × tiles of 256 pairs, 7,680 CTAs at [3, 8, 40, 8192] and 6,336 at
// [99, 32, 2, 1024]: every SM is busy, and a thread finds its (t, row) with
// one division. Consecutive threads take consecutive pairs, so each of the
// four stores coalesces. u0 is drawn once per (t, row), by thread 0 of the
// row's first CTA.
//
// "particle" (stream_noise_kernel, the previous design, kept as its
// yardstick): one CTA per (t, row), 24 CTAs at [3, 8, 40, 8192] on 132 SMs,
// and each thread draws particle i's normals through draw_eps's eps_words,
// so the threads of particles p and p + K/2 each make the pair's Philox call,
// logf and sqrtf.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace psvo {

constexpr int kPairThreads = 256;  // pairs a CTA of the pair design serves

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

// Both halves of one Box-Muller pair: rad and ang with exactly box_muller's
// operations, then the cos branch (particle p) and the sin branch (p + K/2).
// sincosf shares one range reduction between the two; chip_smoke.py phases
// (d) and (n) hold its bits to sinf's and cosf's (the particle design and
// the plain version's torch.sin / torch.cos).
__device__ __forceinline__ void box_muller_pair(uint32_t bits1, uint32_t bits2, float& cos_half,
                                                float& sin_half) {
  const float u1 = __fsub_rn(1.0f, unit24(bits1));
  const float u2 = unit24(bits2);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(6.283185307179586f, u2);
  float sn, cs;
  sincosf(ang, &sn, &cs);
  cos_half = __fmul_rn(rad, cs);
  sin_half = __fmul_rn(rad, sn);
}

// Grid (t·B + row, group j, tile of kPairThreads pairs); ops/fused_step.py::k2_plan
// mirrors it.
__global__ void __launch_bounds__(kPairThreads) stream_noise_pair_kernel(
    uint32_t k0, uint32_t k1, int B, int dx, int K, float* eps, float* u0) {
  const int tr = blockIdx.x, j = blockIdx.y, half = K >> 1;
  const int row = tr % B, t = tr / B;
  const int p = blockIdx.z * kPairThreads + threadIdx.x;
  if (p < half) {
    const Ctr4 r = philox4x32_10(Ctr4{uint32_t(p), uint32_t(t), uint32_t(row), uint32_t(1 + j)},
                                 k0, k1);
    float* base = eps + ((size_t)tr * dx + 2 * j) * K;
    float c, s;
    box_muller_pair(r.x, r.y, c, s);
    base[p] = c;
    base[p + half] = s;
    if (2 * j + 1 < dx) {
      box_muller_pair(r.z, r.w, c, s);
      base[K + p] = c;
      base[K + p + half] = s;
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) u0[tr] = draw_u0(k0, k1, row, t);
}

}  // namespace psvo

// design 0: the pair design, 1: the particle design.
extern "C" int psvo_stream_noise(float* eps, float* u0, uint32_t seed0, uint32_t seed1,
                                 int T1, int B, int dx, int K, int design, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (T1 < 1 || B < 1 || dx < 1 || K < 2 || K % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (design == 0) {
    const int groups = (dx + 1) / 2, tiles = (K / 2 + psvo::kPairThreads - 1) / psvo::kPairThreads;
    if (groups > 65535 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    psvo::stream_noise_pair_kernel<<<dim3(T1 * B, groups, tiles), psvo::kPairThreads, 0, s>>>(
        seed0, seed1, B, dx, K, eps, u0);
    return static_cast<int>(cudaGetLastError());
  }
  if (design != 1) return static_cast<int>(cudaErrorInvalidValue);
  psvo::stream_noise_kernel<<<T1 * B, 256, 0, s>>>(seed0, seed1, B, dx, K, eps, u0);
  return static_cast<int>(cudaGetLastError());
}
