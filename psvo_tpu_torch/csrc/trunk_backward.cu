// K10 trunk_backward: the VJP of K9 (trunk_forward.cu) for one step, plus
// two small kernels that sum its partial gradients.
//
// Replaces psvo_tpu/ops/pallas_trunk.py::_tr_bwd (kernel body _tr_bwd_kernel,
// which runs pallas_step._propose_weight_bwd_core with d_stats=None and
// accumulates with _accum_param_grads; ℓ = lse(α) stays outside, in tensor
// ops). Per particle of the tile, from K9's inputs and output (x_res, ε or
// the seed it drew from, x_new) and the cotangents of x_new and α:
//   1. recompute m_f = f(x_res) and m_g = g(x_new), and the unfloored α,
//      with trunk_tile.cuh's functions, so they carry K9's bits;
//   2. cut dα to 0 where the unfloored α < −3e30 (K9's floor clamped it);
//   3. backprop g; its input cotangent adds into d x_new;
//   4. d m1 = cq·d x_new; recompute q1 on x_res and backprop it;
//   5. backprop f (its hidden layers recomputed: see below).
// Outputs: d x_res = d x_q1 + d x_f; per row the sums Σ_k d x_new,
// Σ_k d x_new·m1, Σ_k d x_new·ε (for aq, cq, sq) and Σ_k dα (for ab), zero
// for the y columns (y is data); d_sconst from Σ d_z·(x − m); the weight
// gradients of the three nets in fused_step.prepare's packed layout; no
// gradient for ε. Its plain version is trunk.trunk_backward_reference.
//
// What bounds it. About 9 × 18,432 FLOP per particle at Dx = Dy = 40 and
// hidden (64, 64): the three trunk recomputes, their input-side backward and
// their weight-gradient products; 1.1e10 FLOP per launch at B = 8, K = 8192,
// against ~42 MB of particle traffic, so the fp32 cores bound it (0.16 ms at
// 67 TFLOP/s). Every stage is a small GEMM over a 64-particle tile in shared
// memory ([unit][particle], rows padded to 68 floats so that float4 rows of
// neighbouring units land on other banks), 4×4 outputs per thread.
//
// Shared memory decides the design. K9 keeps the three nets resident (113 KB
// at width 64); their gradient accumulators are as large again, and both do
// not fit one CTA's 227 KB beside the tiles. So the weights stay resident,
// the grid is persistent (one CTA per SM walking tiles b·(K/64) + k/64 with a
// stride of the grid, as K9), and each CTA owns one row of a [CTAs, n_w +
// Dx + Dy] partial buffer in global memory (15 MB for 132 CTAs: it stays in
// L2), whose every entry has one owning thread that adds the CTA's tile sums
// in tile order. A second kernel adds the CTA rows in order, as K4's
// sum_rows_kernel does; a third adds each trajectory row's per-tile d_coef
// sums in tile order. The tiles hold x_res, x_new, ε, f's mean (then its
// cotangent), g's mean (then its cotangent, then q1's mean, then its
// cotangent), d x_new (then d x_res) and one net's hidden layers: 215 KB at
// width 64 with the weights. f's hidden layers do not stay alive while g and
// q1 run; they are recomputed before f's backprop, one extra trunk forward
// (a ninth more work) against the 35 KB they would need.
//
// Determinism: no float atomics. Every gradient entry has one owner per CTA,
// the per-tile sums run in a fixed order, and the CTA rows and tiles are
// added in order, so a second launch on the same card gives the same bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"
#include "trunk_tile.cuh"

namespace psvo {

constexpr int kPS = kTile + 4;  // row stride of K10's tiles, in floats

struct TrunkBwdArgs {
  const float* x_res;    // [B, DX, K]
  const float* x_new;    // [B, DX, K]: K9's output
  const float* eps;      // [B, DX, K]; stream mode only
  const float* coef;     // [B, 3*DX + DY + 1]: aq, cq, sq, y, ab of this step
  const float* weights;  // q1 | f | g, each fused_step.prepare's layout
  const float* sconst;   // [DX + DY]: 1/s_f, 1/s_g
  const float* d_x_new;  // [B, DX, K]
  const float* d_alpha;  // [B, K]
  float* d_x_res;        // [B, DX, K]
  float* partial;        // [CTAs, n_weights + DX + DY]: each CTA's gradient sums
  float* coef_part;      // [B * K / kTile, 3*DX + 1]: each tile's d_coef sums
  uint32_t seed0, seed1;
  int use_rng, t, B, K, n_mid, n_weights, off_f, off_g;
};

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The relu trunk on a [DIN][kPS] tile: hidden layer j into hs + j·H·kPS
// (n_mid + 1 of them), then the mean into out (skipped when out is null).
// Ends on a barrier.
template <int DIN, int H, int DOUT>
__device__ __forceinline__ void net_forward(const float* __restrict__ w, int n_mid,
                                            const float* in, float* hs, float* out) {
  tile_layer<DIN, H, true, kPS>(w, in, hs);
  __syncthreads();
  const float* p = w + DIN * H + H;
  for (int j = 1; j <= n_mid; ++j) {
    tile_layer<H, H, true, kPS>(p, hs + (j - 1) * H * kPS, hs + j * H * kPS);
    __syncthreads();
    p += H * H + H;
  }
  if (out != nullptr) {
    tile_layer<H, DOUT, false, kPS>(p, hs + n_mid * H * kPS, out);
    __syncthreads();
  }
}

// g[i][o] += Σ_p a[i][p]·c[o][p] and g[RI·RO + o] += Σ_p c[o][p] (a layer's
// weight and bias gradients from its input a [RI][kPS] and the cotangent of
// its pre-activation c [RO][kPS]); g is this CTA's row of the partial
// buffer. A thread owns rows i0 + SI·r and columns o0 + SO·c: neighbouring
// threads read neighbouring rows of c, which the padded stride puts on
// other banks.
template <int RI, int RO>
__device__ __forceinline__ void layer_grads(const float* __restrict__ a,
                                            const float* __restrict__ c, float* g) {
  constexpr int SI = RI / 4, SO = RO / 4;
  for (int blk = threadIdx.x; blk < SI * SO; blk += kTrunkThreads) {
    const int i0 = blk / SO, o0 = blk % SO;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    for (int p = 0; p < kTile; p += 4) {
      float av[4][4], cv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ld4(a + (i0 + SI * r) * kPS + p, av[r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) ld4(c + (o0 + SO * q) * kPS + p, cv[q]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r][e], cv[q][e], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) g[(i0 + SI * r) * RO + o0 + SO * q] += acc[r][q];
    }
  }
  for (int o = threadIdx.x; o < RO; o += kTrunkThreads) {
    float s = 0.0f;
    for (int p = 0; p < kTile; p += 4) {
      float cv[4];
      ld4(c + o * kPS + p, cv);
#pragma unroll
      for (int q = 0; q < 4; ++q) s += cv[q];
    }
    g[RI * RO + o] += s;
  }
}

enum InputMode { kRelu, kWrite, kAdd };

// d[i][p] = Σ_o w[i][o]·c[o][p] for i < RI (w row-major [RI][RO]), c and d
// [rows][kPS]. kRelu: d holds the layer input's activation and becomes the
// cotangent of its pre-activation (zero where the activation is 0); kWrite
// and kAdd store or add the sum.
template <int RI, int RO, InputMode kMode>
__device__ __forceinline__ void input_grads(const float* __restrict__ w,
                                            const float* __restrict__ c, float* d) {
  constexpr int kColGroups = kTile / 4;
  for (int blk = threadIdx.x; blk < (RI / 4) * kColGroups; blk += kTrunkThreads) {
    const int i0 = (blk / kColGroups) * 4, p0 = (blk % kColGroups) * 4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
    }
    for (int o = 0; o < RO; o += 4) {
      float wv[4][4], cv[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ld4(w + (i0 + r) * RO + o, wv[r]);
#pragma unroll
      for (int e = 0; e < 4; ++e) ld4(c + (o + e) * kPS + p0, cv[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r][e], cv[e][q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = d + (i0 + r) * kPS + p0;
      float dv[4];
      ld4(row, dv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kMode == kRelu) dv[q] = dv[q] > 0.0f ? acc[r][q] : 0.0f;
        if (kMode == kWrite) dv[q] = acc[r][q];
        if (kMode == kAdd) dv[q] += acc[r][q];
      }
      *reinterpret_cast<float4*>(row) = make_float4(dv[0], dv[1], dv[2], dv[3]);
    }
  }
}

// Backprop of one relu trunk (fused_step.prepare's layout at w, its gradient
// segment at g) from the cotangent of its mean dm [DOUT][kPS], with its
// input x [DIN][kPS] and hidden layers hs from net_forward (overwritten by
// their cotangents). The input cotangent goes to dx as kMode says; dx must
// not be x. Ends on a barrier.
template <int DIN, int H, int DOUT, InputMode kMode>
__device__ __forceinline__ void net_backward(const float* __restrict__ w, float* g, int n_mid,
                                             const float* x, float* hs, const float* dm,
                                             float* dx) {
  const int head = DIN * H + H + n_mid * (H * H + H);
  float* top = hs + n_mid * H * kPS;
  layer_grads<H, DOUT>(top, dm, g + head);
  __syncthreads();
  input_grads<H, DOUT, kRelu>(w + head, dm, top);
  __syncthreads();
  for (int j = n_mid; j >= 1; --j) {
    const int off = DIN * H + H + (j - 1) * (H * H + H);
    float* cur = hs + j * H * kPS;
    float* prev = hs + (j - 1) * H * kPS;
    layer_grads<H, H>(prev, cur, g + off);
    __syncthreads();
    input_grads<H, H, kRelu>(w + off, cur, prev);
    __syncthreads();
  }
  layer_grads<DIN, H>(x, hs, g);
  input_grads<DIN, H, kMode>(w, hs, dx);
  __syncthreads();
}

template <int DX, int DY, int H>
__global__ void __launch_bounds__(kTrunkThreads, 1) trunk_backward_kernel(const TrunkBwdArgs a) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  constexpr int NS = 3 * DX + 1;  // per-tile d_coef sums: aq, cq, sq, ab
  extern __shared__ __align__(16) unsigned char smem[];
  float* wts = reinterpret_cast<float*>(smem);  // [n_weights], a multiple of 4
  float* xr = wts + a.n_weights;                // [DX][kPS]: x_res
  float* xn = xr + DX * kPS;                    // [DX][kPS]: x_new
  float* ep = xn + DX * kPS;                    // [DX][kPS]: ε
  float* mf = ep + DX * kPS;                    // [DX][kPS]: f's mean, then its cotangent
  float* mg = mf + DX * kPS;                    // [DMAX][kPS]: g's mean / cotangent, q1's
  float* dxn = mg + DMAX * kPS;                 // [DX][kPS]: d x_new, then d x_res
  float* hs = dxn + DX * kPS;                   // [(n_mid + 1) H][kPS]: one net's hidden layers
  float* red = hs + (a.n_mid + 1) * H * kPS;    // [kParts][kTile]
  float* da = red + kParts * kTile;             // [kTile]: dα after the floor cut
  float* cf = da + kTile;                       // [NC]: this row's coefficients
  const int tid = threadIdx.x, K = a.K;
  const int tiles_per_row = K / kTile;
  const int n_row = a.n_weights + DX + DY;
  float* part = a.partial + (size_t)blockIdx.x * n_row;
  const float* wq = wts;
  const float* wf = wts + a.off_f;
  const float* wg = wts + a.off_g;

  for (int i = tid; i < a.n_weights / 4; i += kTrunkThreads) {
    reinterpret_cast<float4*>(wts)[i] = reinterpret_cast<const float4*>(a.weights)[i];
  }
  for (int i = tid; i < n_row; i += kTrunkThreads) part[i] = 0.0f;  // the pads stay 0

  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {
    const int b = tile / tiles_per_row, k0 = (tile % tiles_per_row) * kTile;
    const size_t row = (size_t)b * DX * K;
    __syncthreads();  // the previous tile is done (and the weights and zeros are in)
    move_tile<true, kPS>(xr, a.x_res + row, nullptr, DX, K, k0);
    move_tile<true, kPS>(xn, a.x_new + row, nullptr, DX, K, k0);
    if (a.use_rng) {  // K9's draw, particle by particle
      for (int v = tid; v < ((DX + 1) / 2) * kTile; v += kTrunkThreads) {
        const int j = v / kTile, p = v % kTile;
        bool sin_branch;
        const Ctr4 r = eps_words(a.seed0, a.seed1, b, a.t, k0 + p, K, j, &sin_branch);
        ep[2 * j * kPS + p] = box_muller(r.x, r.y, sin_branch);
        if (2 * j + 1 < DX) ep[(2 * j + 1) * kPS + p] = box_muller(r.z, r.w, sin_branch);
      }
    } else {
      move_tile<true, kPS>(ep, a.eps + row, nullptr, DX, K, k0);
    }
    for (int i = tid; i < NC; i += kTrunkThreads) cf[i] = a.coef[(size_t)b * NC + i];
    __syncthreads();

    // 1. recompute f on x_res (its hidden layers are scratch) and g on x_new
    net_forward<DX, H, DX>(wf, a.n_mid, xr, hs, mf);
    net_forward<DX, H, DY>(wg, a.n_mid, xn, hs, mg);

    // 2. the unfloored α, as K9 sums it, and dα cut where the floor clamped
    {
      const int p = tid % kTile, prt = tid / kTile;
      red[prt * kTile + p] = alpha_part<DX, DY, kPS>(xn, mf, ep, mg, cf + 3 * DX, a.sconst, p, prt);
    }
    __syncthreads();
    if (tid < kTile) {
      const float al = alpha_total(red, tid, cf[NC - 1]);
      da[tid] = al >= -3e30f ? a.d_alpha[(size_t)b * K + k0 + tid] : 0.0f;
    }
    __syncthreads();

    // 3. d_sconst: Σ_p d_z·(x − m) = −Σ_p dα·z·(x − m)
    if (tid < DX + DY) {
      const bool is_f = tid < DX;
      const int d = is_f ? tid : tid - DX;
      const float si = a.sconst[tid];
      const float* m = (is_f ? mf : mg) + d * kPS;
      float s = 0.0f;
      for (int p = 0; p < kTile; ++p) {
        const float r = is_f ? xn[d * kPS + p] - m[p] : cf[3 * DX + d] - m[p];
        s -= da[p] * (r * si) * r;
      }
      part[a.n_weights + tid] += s;
    }
    __syncthreads();

    // 4. the means' cotangents in place of the means, and d x_new
    for (int v = tid; v < DX * kTile; v += kTrunkThreads) {
      const int d = v / kTile, p = v % kTile, e = d * kPS + p;
      const float si = a.sconst[d];
      const float dmf = da[p] * ((xn[e] - mf[e]) * si) * si;
      mf[e] = dmf;
      dxn[e] = a.d_x_new[row + (size_t)d * K + k0 + p] - dmf;
    }
    for (int v = tid; v < DY * kTile; v += kTrunkThreads) {
      const int q = v / kTile, p = v % kTile, e = q * kPS + p;
      const float si = a.sconst[DX + q];
      mg[e] = da[p] * ((cf[3 * DX + q] - mg[e]) * si) * si;
    }
    __syncthreads();

    // 5. backprop g: its input cotangent adds into d x_new
    net_backward<DX, H, DY, kAdd>(wg, part + a.off_g, a.n_mid, xn, hs, mg, dxn);

    // 6. recompute q1 on x_res, its mean m1 into mg's tile
    net_forward<DX, H, DX>(wq, a.n_mid, xr, hs, mg);

    // 7. the tile's sums for aq, cq, sq and ab, then d m1 = cq·d x_new in place of m1
    if (tid < NS) {
      float s = 0.0f;
      if (tid == 3 * DX) {
        for (int p = 0; p < kTile; ++p) s += da[p];
      } else {
        const int d = tid % DX, kind = tid / DX;
        const float* other = kind == 1 ? mg : ep;
        for (int p = 0; p < kTile; ++p) {
          const float dv = dxn[d * kPS + p];
          s += kind == 0 ? dv : dv * other[d * kPS + p];
        }
      }
      a.coef_part[(size_t)tile * NS + tid] = s;
    }
    __syncthreads();
    for (int v = tid; v < DX * kTile; v += kTrunkThreads) {
      const int d = v / kTile, e = d * kPS + v % kTile;
      mg[e] = cf[DX + d] * dxn[e];
    }
    __syncthreads();

    // 8. backprop q1: d x_res into d x_new's tile (no longer read)
    net_backward<DX, H, DX, kWrite>(wq, part, a.n_mid, xr, hs, mg, dxn);

    // 9. recompute f's hidden layers and backprop f: d x_res adds its part
    net_forward<DX, H, DX>(wf, a.n_mid, xr, hs, nullptr);
    net_backward<DX, H, DX, kAdd>(wf, part + a.off_f, a.n_mid, xr, hs, mf, dxn);

    move_tile<false, kPS>(dxn, nullptr, a.d_x_res + row, DX, K, k0);
  }
}

// out[e] = Σ_r partial[r][e], the CTA rows added in order.
__global__ void trunk_sum_ctas_kernel(const float* __restrict__ partial, int rows, int n,
                                      float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * n + e];
  out[e] = s;
}

// d_coef[b][c] in pack_coef's layout: the trajectory row's tile sums added
// in tile order for aq, cq, sq and ab; zero for the y columns.
__global__ void trunk_sum_tiles_kernel(const float* __restrict__ coef_part, int B,
                                       int tiles_per_row, int dx, int dy,
                                       float* __restrict__ d_coef) {
  const int nc = 3 * dx + dy + 1, ns = 3 * dx + 1;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * nc) return;
  const int b = e / nc, c = e % nc;
  float s = 0.0f;
  if (c < 3 * dx || c == nc - 1) {
    const int j = c < 3 * dx ? c : ns - 1;
    for (int i = 0; i < tiles_per_row; ++i) {
      s += coef_part[((size_t)b * tiles_per_row + i) * ns + j];
    }
  }
  d_coef[e] = s;
}

template <int DX, int DY, int H>
cudaError_t launch_trunk_backward(const TrunkBwdArgs& a, int max_ctas, float* grads,
                                  float* d_coef, cudaStream_t stream) {
  constexpr int DMAX = DX > DY ? DX : DY;
  constexpr int NC = 3 * DX + DY + 1;
  const size_t smem =
      sizeof(float) * (a.n_weights + (5 * DX + DMAX + (a.n_mid + 1) * H) * kPS +
                       kParts * kTile + kTile + ((NC + 3) / 4) * 4);
  auto kernel = trunk_backward_kernel<DX, DY, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTrunkThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = a.B * (a.K / kTile);
  int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (grid > max_ctas) grid = max_ctas;
  kernel<<<grid, kTrunkThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n = a.n_weights + DX + DY;
  trunk_sum_ctas_kernel<<<(n + kTrunkThreads - 1) / kTrunkThreads, kTrunkThreads, 0, stream>>>(
      a.partial, grid, n, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nd = a.B * NC;
  trunk_sum_tiles_kernel<<<(nd + kTrunkThreads - 1) / kTrunkThreads, kTrunkThreads, 0, stream>>>(
      a.coef_part, a.B, a.K / kTile, DX, DY, d_coef);
  return cudaGetLastError();
}

}  // namespace psvo

// Plain C entry point (bound with ctypes by psvo_tpu_torch/ops/_build.py).
// grads [n_weights + dx + dy] receives the weight gradients, then d_sconst;
// d_coef [B, 3·dx + dy + 1]; partial [max_ctas, n_weights + dx + dy] and
// coef_part [B·K/64, 3·dx + 1] are scratch. Returns a cudaError_t.
extern "C" int psvo_trunk_backward(const float* x_res, const float* x_new, const float* eps,
                                   const float* coef, const float* weights, const float* sconst,
                                   const float* d_x_new, const float* d_alpha, float* d_x_res,
                                   float* partial, float* coef_part, float* grads, float* d_coef,
                                   uint32_t seed0, uint32_t seed1, int use_rng, int t, int B,
                                   int K, int dx, int dy, int hidden, int n_mid, int n_weights,
                                   int off_f, int off_g, int max_ctas, void* stream) {
  const psvo::TrunkBwdArgs a{x_res, x_new, eps,     coef,     weights, sconst, d_x_new,
                             d_alpha, d_x_res, partial, coef_part, seed0, seed1, use_rng,
                             t,     B,       K,       n_mid,    n_weights, off_f, off_g};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dx == 40 && dy == 40) {  // Lorenz-96
    switch (hidden) {
      case 16: return psvo::launch_trunk_backward<40, 40, 16>(a, max_ctas, grads, d_coef, s);
      case 32: return psvo::launch_trunk_backward<40, 40, 32>(a, max_ctas, grads, d_coef, s);
      case 64: return psvo::launch_trunk_backward<40, 40, 64>(a, max_ctas, grads, d_coef, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
