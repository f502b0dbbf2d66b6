// The dense layers of the whole-step kernels over a tile of P particles in
// shared memory: K4 and K15 (scan_backward.cuh) recompute the trunks this way
// at every width (P = kP), and K1 and K14 (scan_forward.cuh) run their trunks
// this way under the tiled plan (kFwdTile, widths whose register trunk would
// spill), at a P that fits their shared memory.
//
// Layout: a tile holds one row of P + 4 floats per unit ([unit][particle],
// the 4 floats of padding put float4 rows on distinct banks). Each output of
// a layer has one owning thread, which starts from the bias and adds the
// inputs in ascending order with fmaf: the order of K1's register trunk
// (scan_forward.cuh::trunk), so the tiled layers give its bits at every P.
#pragma once

#include <cuda_runtime.h>

#include "resample.cuh"

namespace psvo {

constexpr int kP = 64;       // particles per tile of K4 and K15
constexpr int kPS = kP + 4;  // row stride of their tile arrays, in floats
constexpr int kPB = kP / 4;  // 4-particle blocks per tile row

// Offsets inside one net's segment of the packed buffer: W1 [DIN, H], b1
// [H], then per middle layer j = 1..NMID Wj [H, H], bj [H], then W3 [H, DOUT],
// b3 [DOUT].
template <int DIN, int H, int DOUT, int NMID>
struct Net {
  static constexpr int W1 = 0, B1 = DIN * H, W3 = B1 + H + NMID * (H * H + H),
                       B3 = W3 + H * DOUT;
  __host__ __device__ static constexpr int W(int j) { return B1 + H + (j - 1) * (H * H + H); }
  __host__ __device__ static constexpr int B(int j) { return W(j) + H * H; }
};

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// y[o][p] = relu(b[o] + Σ_i W[i][o] x[i][p]) over the tile, in K1's fmaf
// order. x [DIN][P + 4], W [DIN][H] row-major, y [H][P + 4]. Each thread owns
// units o0..o0+3 of particles p0..p0+3.
template <int DIN, int H, int P = kP>
__device__ __forceinline__ void dense_relu_tile(const float* __restrict__ w,
                                                const float* __restrict__ bias,
                                                const float* __restrict__ x,
                                                float* __restrict__ y) {
  constexpr int PS = P + 4, PB = P / 4;
  for (int blk = threadIdx.x; blk < (H / 4) * PB; blk += kThreads) {
    const int o0 = (blk / PB) * 4, p0 = (blk % PB) * 4;
    float bv[4], acc[4][4];
    ld4(bias + o0, bv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = bv[r];
    }
#pragma unroll 4
    for (int i = 0; i < DIN; ++i) {
      float wv[4], xv[4];
      ld4(w + i * H + o0, wv);
      ld4(x + i * PS + p0, xv);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[c], wv[r], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = fmaxf(acc[r][c], 0.0f);
      st4(y + (o0 + r) * PS + p0, out);
    }
  }
}

// m[d][p] = b3[d] + Σ_o W3[o][d] x[o][p]: the mean head, in K1's order.
template <int H, int DOUT, int P = kP>
__device__ __forceinline__ void dense_out_tile(const float* __restrict__ w3,
                                               const float* __restrict__ b3,
                                               const float* __restrict__ x,
                                               float* __restrict__ m) {
  constexpr int PS = P + 4;
  for (int e = threadIdx.x; e < DOUT * P; e += kThreads) {
    const int d = e / P, p = e % P;
    float acc = b3[d];
#pragma unroll 8
    for (int o = 0; o < H; ++o) acc = fmaf(x[o * PS + p], w3[o * DOUT + d], acc);
    m[d * PS + p] = acc;
  }
}

// One relu MLP head over the tile at any depth (n_mid middle layers, read at
// run time): its hidden layers ping-pong between the two [H][P + 4] tiles of
// act, the first layer's bias read from b1, the mean into m [DOUT][P + 4].
// K1's and K14's tiled plan; K4 keeps every layer (scan_backward.cuh::
// forward_tiles), for its backward. Ends on a barrier.
template <int DIN, int H, int DOUT, int P>
__device__ __forceinline__ void tile_net(const float* w, const float* b1, int n_mid,
                                         const float* x, float* act, float* m) {
  constexpr int T = H * (P + 4);
  dense_relu_tile<DIN, H, P>(w, b1, x, act);
  __syncthreads();
  const float* p = w + DIN * H + H;  // the first middle layer, then W3
  float *cur = act, *nxt = act + T;
  for (int j = 0; j < n_mid; ++j) {
    dense_relu_tile<H, H, P>(p, p + H * H, cur, nxt);
    __syncthreads();
    float* done = cur;
    cur = nxt;
    nxt = done;
    p += H * H + H;
  }
  dense_out_tile<H, DOUT, P>(p, p + H * DOUT, cur, m);
  __syncthreads();
}

}  // namespace psvo
