// Counter-based noise shared by the whole-scan forward kernel (in-kernel RNG
// mode, scan_forward.cuh), the per-step trunk kernel (trunk_forward.cu) and
// the stream extractor (stream_noise.cu).
//
// Replaces the TPU hardware PRNG of psvo_tpu/ops/pallas_step.py
// (_rng_seed / _rng_unit_bits / _rng_eps / _rng_sys_u). The draws keep that
// code's FORM — top-24-bit uniforms, the Box-Muller pair form on the Dx live
// state rows, one systematic offset u0 per (row, step) — but not its bits:
// the generator here is Philox4x32-10 (Salmon et al., SC'11), keyed by a
// two-word seed drawn from the run's generator, so the streams differ from
// the TPU's. `fused_step.philox4x32_reference` is the same function in plain
// PyTorch integer arithmetic, and the extractor must match it bit for bit.
//
// Counter layout (c0, c1, c2, c3) for batch row b and scan step t:
//   systematic offset u0:       (0, t, b, 0), word 0
//   normals of pair p, group j: (p, t, b, 1 + j), j = d / 2;
//     words (2m, 2m+1) with m = d % 2 are the (u1, u2) of state row d.
// Pair p serves particles p (cos branch) and p + K/2 (sin branch), as the
// reference's concat([rad·cos, rad·sin]) along K does.
#pragma once

#include <cstdint>

namespace psvo {

struct Ctr4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ Ctr4 philox4x32_10(Ctr4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = Ctr4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// Top 24 bits as a float in [0, 1): exact (an integer below 2^24 times 2^-24).
__device__ __forceinline__ float unit24(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
}

// The systematic-resampling offset u0 in [0, 1) of (row, t).
__device__ __forceinline__ float draw_u0(uint32_t k0, uint32_t k1, int row, int t) {
  const Ctr4 r = philox4x32_10(Ctr4{0u, uint32_t(t), uint32_t(row), 0u}, k0, k1);
  return unit24(r.x);
}

// One standard normal from a (u1 bits, u2 bits) pair. u1 = 1 - top24·2^-24
// lies in (0, 1], safe under log. Written op by op with round-to-nearest
// intrinsics so no contraction changes the bits against the plain version.
__device__ __forceinline__ float box_muller(uint32_t bits1, uint32_t bits2, bool sin_branch) {
  const float u1 = __fsub_rn(1.0f, unit24(bits1));
  const float u2 = unit24(bits2);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(6.283185307179586f, u2);
  return __fmul_rn(rad, sin_branch ? sinf(ang) : cosf(ang));
}

// The Philox words of normal group j (state rows 2j and 2j + 1) of particle
// i (of K) at (row, t); *sin_branch says which half of the pair it is.
__device__ __forceinline__ Ctr4 eps_words(uint32_t k0, uint32_t k1, int row, int t, int i,
                                          int K, int j, bool* sin_branch) {
  const int half = K >> 1;
  *sin_branch = i >= half;
  const uint32_t p = uint32_t(*sin_branch ? i - half : i);
  return philox4x32_10(Ctr4{p, uint32_t(t), uint32_t(row), uint32_t(1 + j)}, k0, k1);
}

// The DX normals of particle i (of K) at (row, t).
template <int DX>
__device__ __forceinline__ void draw_eps(uint32_t k0, uint32_t k1, int row, int t,
                                         int i, int K, float (&eps)[DX]) {
#pragma unroll
  for (int j = 0; j < (DX + 1) / 2; ++j) {
    bool sin_branch;
    const Ctr4 r = eps_words(k0, k1, row, t, i, K, j, &sin_branch);
    eps[2 * j] = box_muller(r.x, r.y, sin_branch);
    if (2 * j + 1 < DX) eps[2 * j + 1] = box_muller(r.z, r.w, sin_branch);
  }
}

}  // namespace psvo
