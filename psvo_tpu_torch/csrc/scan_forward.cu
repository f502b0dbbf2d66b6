// K1 scan_forward: the whole forward FIVO filter, t = 1 .. T-1, in one launch.
//
// Replaces psvo_tpu/ops/pallas_step.py::_scan_fwd (kernel body
// _scan_fwd_kernel), which inlines _fwd_core, pallas_resample's
// _two_level_indices, _gather_particles/_lane_gather, _trunk,
// _propose_weight_core and the in-kernel RNG _rng_eps/_rng_sys_u.
//
// Design. One CTA per trajectory row b (grid = B) walks the time loop that
// was the TPU kernel's sequential t grid axis. The carry — particles
// x [Dx][K] (double-buffered, so the ancestor gather reads the old buffer
// while the draw writes the new one) and log-weights [K] — lives in shared
// memory for the whole scan, as do the q1/f/g weights (about 53 KB in fp32
// at hidden (64, 64), hence dynamic shared memory above 48 KB). Per step:
//   1. ESS of the incoming weights and their fp64 inclusive CDF
//      (resample.cuh::block_cdf);
//   2. per particle i: the ancestor a_i by binary search, x_res = x[:, a_i],
//      the q1 and f trunks on x_res, the fused draw
//      x_new = cq·m1 + aq + sq·ε, the g trunk on x_new, and
//      α = −½Σ(z_f² − ε² + z_g²) + ab floored at −3e30;
//   3. ℓ = lse(α) − log K and the filtered mean, by block reductions.
// ε and the positions are either streamed operands or drawn in the kernel
// (philox.cuh), which then reads no noise from device memory at all.
// Residual mode (fused_step.ScanForward, the train step) also writes every
// step's x_new into x_all and its ancestor indices into idx: what
// _scan_fwd keeps for its backward (scan_backward.cu), which regathers the
// resampled particles as x_{t-1}[idx_t] instead of storing them.
//
// What bounds it. At B=32, K=1024, hidden (64, 64) one step is ~0.9 GFLOP
// of fp32 FMAs on the CUDA cores (three trunks per particle, the 64x64
// middle layer dominating) against ~0.5 MB of noise traffic, so it is
// arithmetic-bound; but only B CTAs run, 32 of the card's 132 SMs, each
// with 8 warps. The trunk keeps a particle's first hidden layer in registers
// and streams the middle layer straight into the output layer, so no
// activation touches shared or device memory; every weight read is a
// warp-uniform shared-memory broadcast (float4 where rows allow).
// Splitting K across a cluster to fill the card is later work.
//
// The ones-channel bias folding and the PD=8 / HA=H+8 padding of the TPU
// kernel existed for the MXU and Mosaic and are not carried over: the
// kernel reads plain weights and biases (fused_step.prepare's layout).
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "resample.cuh"
#include "step_math.cuh"

namespace psvo {

struct ScanArgs {
  const float* x0;       // [B, DX, K]
  const float* alpha0;   // [B, K]
  const float* coef;     // [T1, B, 3*DX + DY + 1]: aq, cq, sq, y, ab
  const float* eps;      // [T1, B, DX, K]; stream mode only
  const float* pos;      // [T1, B, K] sorted positions; stream mode only
  const float* weights;  // q1 | f | g, each fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  float* x_last;         // [B, DX, K]
  float* alpha_last;     // [B, K]
  float* stats;          // [T1, B, 2 + DX]: ell, ess, filtered mean
  float* x_all;          // [T1, B, DX, K] or null (neither cache nor residuals)
  float* alpha_all;      // [T1, B, K] or null (no cache)
  int* idx;              // [T1, B, K] ancestor indices or null (no residuals)
  uint32_t seed0, seed1;
  int use_rng, B, K, T1, n_mid, n_weights, off_f, off_g;
};

// relu(x W + b) for one particle: W [DIN, H] row-major, then b [H].
template <int DIN, int H>
__device__ __forceinline__ void dense_relu_in(const float* __restrict__ w,
                                              const float (&x)[DIN], float (&h)[H]) {
  const float* b = w + DIN * H;
#pragma unroll
  for (int o = 0; o < H; o += 4) {
    float4 acc = *reinterpret_cast<const float4*>(b + o);
#pragma unroll
    for (int i = 0; i < DIN; ++i) {
      const float4 c = *reinterpret_cast<const float4*>(w + i * H + o);
      acc.x = fmaf(x[i], c.x, acc.x);
      acc.y = fmaf(x[i], c.y, acc.y);
      acc.z = fmaf(x[i], c.z, acc.z);
      acc.w = fmaf(x[i], c.w, acc.w);
    }
    h[o] = fmaxf(acc.x, 0.0f);
    h[o + 1] = fmaxf(acc.y, 0.0f);
    h[o + 2] = fmaxf(acc.z, 0.0f);
    h[o + 3] = fmaxf(acc.w, 0.0f);
  }
}

// Pre-activations of four consecutive units o..o+3 of an [H, H] layer.
template <int H>
__device__ __forceinline__ float4 dense4(const float* __restrict__ w,
                                         const float* __restrict__ b, int o,
                                         const float (&h)[H]) {
  float4 acc = *reinterpret_cast<const float4*>(b + o);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float4 c = *reinterpret_cast<const float4*>(w + i * H + o);
    acc.x = fmaf(h[i], c.x, acc.x);
    acc.y = fmaf(h[i], c.y, acc.y);
    acc.z = fmaf(h[i], c.z, acc.z);
    acc.w = fmaf(h[i], c.w, acc.w);
  }
  return acc;
}

// One relu MLP head on one particle: layers [DIN -> H], n_mid x [H -> H],
// mean [H -> DOUT]. The last hidden layer is never stored: each group of four
// units feeds the output layer as soon as it is computed.
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void trunk(const float* __restrict__ w, int n_mid,
                                      const float (&x)[DIN], float (&out)[DOUT]) {
  float h[H];
  dense_relu_in<DIN, H>(w, x, h);
  const float* p = w + DIN * H + H;
  for (int j = 0; j + 1 < n_mid; ++j) {
    float g[H];
#pragma unroll
    for (int o = 0; o < H; o += 4) {
      const float4 a = dense4<H>(p, p + H * H, o, h);
      g[o] = fmaxf(a.x, 0.0f);
      g[o + 1] = fmaxf(a.y, 0.0f);
      g[o + 2] = fmaxf(a.z, 0.0f);
      g[o + 3] = fmaxf(a.w, 0.0f);
    }
#pragma unroll
    for (int o = 0; o < H; ++o) h[o] = g[o];
    p += H * H + H;
  }
  if (n_mid > 0) {
    const float* w3 = p + H * H + H;
    const float* b3 = w3 + H * DOUT;
#pragma unroll
    for (int d = 0; d < DOUT; ++d) out[d] = b3[d];
#pragma unroll
    for (int o = 0; o < H; o += 4) {
      const float4 a = dense4<H>(p, p + H * H, o, h);
      const float r[4] = {fmaxf(a.x, 0.0f), fmaxf(a.y, 0.0f), fmaxf(a.z, 0.0f),
                          fmaxf(a.w, 0.0f)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int d = 0; d < DOUT; ++d) out[d] = fmaf(r[q], w3[(o + q) * DOUT + d], out[d]);
      }
    }
  } else {
    const float* b3 = p + H * DOUT;
#pragma unroll
    for (int d = 0; d < DOUT; ++d) out[d] = b3[d];
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int d = 0; d < DOUT; ++d) out[d] = fmaf(h[i], p[i * DOUT + d], out[d]);
    }
  }
}

template <int DX, int DY, int H>
__global__ void __launch_bounds__(kThreads) scan_forward_kernel(const ScanArgs a) {
  static_assert(DX == DY, "the three heads share one trunk instance (one output width)");
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, B = a.B, b = blockIdx.x, tid = threadIdx.x;
  double* cdf = reinterpret_cast<double*>(smem);              // [K]
  double* dred = cdf + K;                                      // [kWarps]
  float* wts = reinterpret_cast<float*>(dred + kWarps);        // [n_weights]
  float* xbuf = wts + a.n_weights;                             // [2][DX][K]
  float* lw = xbuf + 2 * DX * K;                               // [K]
  float* red = lw + K;                                         // [kWarps]

  for (int i = tid; i < a.n_weights; i += kThreads) wts[i] = a.weights[i];
  for (int i = tid; i < DX * K; i += kThreads) xbuf[i] = a.x0[(size_t)b * DX * K + i];
  for (int i = tid; i < K; i += kThreads) lw[i] = a.alpha0[(size_t)b * K + i];
  float sfi[DX], sgi[DY];
#pragma unroll
  for (int d = 0; d < DX; ++d) sfi[d] = a.sconst[d];
#pragma unroll
  for (int e = 0; e < DY; ++e) sgi[e] = a.sconst[DX + e];
  __syncthreads();

  constexpr int NC = 3 * DX + DY + 1;
  const float log_k = logf(static_cast<float>(K));
  int cur = 0;
  for (int t = 0; t < a.T1; ++t) {
    const size_t row = (size_t)t * B + b;
    const float* c = a.coef + row * NC;
    float aq[DX], cq[DX], sq[DX], y[DY];
#pragma unroll
    for (int d = 0; d < DX; ++d) {
      aq[d] = c[d];
      cq[d] = c[DX + d];
      sq[d] = c[2 * DX + d];
    }
#pragma unroll
    for (int e = 0; e < DY; ++e) y[e] = c[3 * DX + e];
    const float ab = c[3 * DX + DY];

    // 1. ESS and the CDF of the incoming weights
    const float m = block_max_of(lw, K, red);
    float s1, s2;
    const double total = block_cdf(lw, K, m, cdf, dred, red, &s1, &s2);
    const float ess = s1 * s1 / fmaxf(s2, 1e-30f);
    const float u0 = a.use_rng ? draw_u0(a.seed0, a.seed1, b, t) : 0.0f;

    // 2. resample, propose and weight each particle
    const float* xc = xbuf + cur * DX * K;
    float* xn_buf = xbuf + (cur ^ 1) * DX * K;
    for (int i = tid; i < K; i += kThreads) {
      const float pos = a.use_rng ? systematic_position(i, u0, K) : a.pos[row * K + i];
      const int anc = ancestor(cdf, K, static_cast<double>(pos) * total);
      float e[DX];
      if (a.use_rng) {
        draw_eps<DX>(a.seed0, a.seed1, b, t, i, K, e);
      } else {
#pragma unroll
        for (int d = 0; d < DX; ++d) e[d] = a.eps[(row * DX + d) * K + i];
      }
      // The three heads run through ONE copy of the (fully unrolled) trunk:
      // q1 and f on the resampled particle, then g on the drawn one.
      float xn[DX], m1[DX], mf[DX], mg[DY];
#pragma unroll
      for (int d = 0; d < DX; ++d) xn[d] = xc[d * K + anc];
#pragma unroll 1
      for (int n = 0; n < 3; ++n) {
        if (n == 2) {
#pragma unroll
          for (int d = 0; d < DX; ++d) xn[d] = cq[d] * m1[d] + aq[d] + sq[d] * e[d];
        }
        const int off = n == 0 ? 0 : (n == 1 ? a.off_f : a.off_g);
        trunk<DX, H, DY>(wts + off, a.n_mid, xn, mg);
#pragma unroll
        for (int d = 0; d < DX; ++d) {
          if (n == 0) m1[d] = mg[d];
          if (n == 1) mf[d] = mg[d];
        }
      }
      // finiteness floor: a diverged mean gives a finite, hopeless weight
      const float alpha =
          fmaxf(alpha_unfloored<DX, DY>(xn, mf, e, y, mg, sfi, sgi, ab), -3e30f);
#pragma unroll
      for (int d = 0; d < DX; ++d) xn_buf[d * K + i] = xn[d];
      lw[i] = alpha;
      if (a.x_all != nullptr) {
#pragma unroll
        for (int d = 0; d < DX; ++d) a.x_all[(row * DX + d) * K + i] = xn[d];
      }
      if (a.alpha_all != nullptr) a.alpha_all[row * K + i] = alpha;
      if (a.idx != nullptr) a.idx[row * K + i] = anc;
    }
    __syncthreads();

    // 3. logZ increment and filtered mean under the new weights
    const float amax = block_max_of(lw, K, red);
    float sw = 0.0f, sx[DX];
#pragma unroll
    for (int d = 0; d < DX; ++d) sx[d] = 0.0f;
    for (int i = tid; i < K; i += kThreads) {
      const float w = expf(lw[i] - amax);
      sw += w;
#pragma unroll
      for (int d = 0; d < DX; ++d) sx[d] = fmaf(w, xn_buf[d * K + i], sx[d]);
    }
    sw = block_reduce<false>(sw, red);
#pragma unroll
    for (int d = 0; d < DX; ++d) sx[d] = block_reduce<false>(sx[d], red);
    if (tid == 0) {
      float* st = a.stats + row * (2 + DX);
      st[0] = logf(sw) + amax - log_k;
      st[1] = ess;
#pragma unroll
      for (int d = 0; d < DX; ++d) st[2 + d] = sx[d] / sw;
    }
    cur ^= 1;
  }

  const float* xc = xbuf + cur * DX * K;
  for (int i = tid; i < DX * K; i += kThreads) a.x_last[(size_t)b * DX * K + i] = xc[i];
  for (int i = tid; i < K; i += kThreads) a.alpha_last[(size_t)b * K + i] = lw[i];
}

template <int DX, int DY, int H>
cudaError_t launch_scan(const ScanArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(double) * (a.K + kWarps) +
                      sizeof(float) * (a.n_weights + 2 * DX * a.K + a.K + kWarps);
  auto kernel = scan_forward_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace psvo

// Plain C entry point (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// Returns a cudaError_t; the launch is checked with cudaGetLastError().
extern "C" int psvo_scan_forward(const float* x0, const float* alpha0, const float* coef,
                                 const float* eps, const float* pos, const float* weights,
                                 const float* sconst, float* x_last, float* alpha_last,
                                 float* stats, float* x_all, float* alpha_all, int* idx,
                                 uint32_t seed0, uint32_t seed1, int use_rng, int B, int K,
                                 int T1, int dx, int dy, int hidden, int n_mid, int n_weights,
                                 int off_f, int off_g, void* stream) {
  const psvo::ScanArgs a{x0,    alpha0,    coef,   eps,       pos,   weights, sconst,
                         x_last, alpha_last, stats, x_all,     alpha_all, idx, seed0,
                         seed1,  use_rng,   B,      K,         T1,    n_mid,  n_weights,
                         off_f,  off_g};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dx == 2 && dy == 2) {  // FitzHugh-Nagumo
    switch (hidden) {
      case 16: return psvo::launch_scan<2, 2, 16>(a, s);
      case 32: return psvo::launch_scan<2, 2, 32>(a, s);
      case 64: return psvo::launch_scan<2, 2, 64>(a, s);
      default: break;
    }
  }
  if (dx == 3 && dy == 3) {  // Lorenz-63
    switch (hidden) {
      case 16: return psvo::launch_scan<3, 3, 16>(a, s);
      case 32: return psvo::launch_scan<3, 3, 32>(a, s);
      case 64: return psvo::launch_scan<3, 3, 64>(a, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Message of a CUDA error code returned by the entry points.
extern "C" const char* psvo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
