// Tile pieces shared by the trunk kernel K9 (trunk_forward.cu) and its VJP
// K10 (trunk_backward.cu): the block shape, one relu-MLP layer over a tile of
// particles in shared memory, tile loads and stores, and α's sum. K10
// recomputes the trunks and α with these same functions, so its m_f, m_g and
// unfloored α carry K9's bits and the −3e30 floor cuts the same particles.
#pragma once

#include <cuda_runtime.h>

namespace psvo {

constexpr int kTrunkThreads = 256;
constexpr int kTile = 64;  // particles per tile
constexpr int kParts = kTrunkThreads / kTile;  // threads summing one particle's α

// out[r][p] = b[r] + Σ_i w[i][r]·in[i][p] (relu'd when RELU) for r < R and
// the tile's kTile particles; w is [DIN] rows of R weights at a row stride of
// WS floats followed by b [R] (x @ W + b), in and out are [rows][S] (S >=
// kTile, a multiple of 4), all in shared memory. NT threads, numbered tid
// (tile_layer: threadIdx.x), share the outputs in blocks of RB rows × 4
// particles. The sum runs bias first, then i ascending, one fmaf per term,
// whatever NT, RB and WS, so every mapping gives the same bits. The caller
// synchronises before reading out.
template <int DIN, int R, bool RELU, int S, int NT = kTrunkThreads, int RB = 4, int WS = R>
__device__ __forceinline__ void tile_layer_at(const float* __restrict__ w,
                                              const float* __restrict__ in,
                                              float* __restrict__ out, int tid) {
  static_assert((RB == 2 || RB == 4 || RB == 8) && R % RB == 0 && WS % RB == 0,
                "RB x 4 register blocks need R % RB == 0");
  constexpr int kColGroups = kTile / 4;
  const float* b = w + DIN * WS;
  for (int blk = tid; blk < (R / RB) * kColGroups; blk += NT) {
    const int r0 = (blk / kColGroups) * RB, p0 = (blk % kColGroups) * 4;
    float acc[RB][4];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const float bias = b[r0 + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = bias;
    }
#pragma unroll 8
    for (int i = 0; i < DIN; ++i) {
      float wq[RB];
      if constexpr (RB >= 4) {
#pragma unroll
        for (int q = 0; q < RB; q += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(w + i * WS + r0 + q);
          wq[q] = wv.x;
          wq[q + 1] = wv.y;
          wq[q + 2] = wv.z;
          wq[q + 3] = wv.w;
        }
      } else {
        const float2 wv = *reinterpret_cast<const float2*>(w + i * WS + r0);
        wq[0] = wv.x;
        wq[1] = wv.y;
      }
      const float4 xv = *reinterpret_cast<const float4*>(in + i * S + p0);
      const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < RB; ++q) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] = fmaf(wq[q], xc[c], acc[q][c]);
      }
    }
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      float4 o = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      if (RELU) {
        o.x = fmaxf(o.x, 0.0f);
        o.y = fmaxf(o.y, 0.0f);
        o.z = fmaxf(o.z, 0.0f);
        o.w = fmaxf(o.w, 0.0f);
      }
      *reinterpret_cast<float4*>(out + (r0 + q) * S + p0) = o;
    }
  }
}

template <int DIN, int R, bool RELU, int S, int NT = kTrunkThreads, int RB = 4, int WS = R>
__device__ __forceinline__ void tile_layer(const float* __restrict__ w,
                                           const float* __restrict__ in,
                                           float* __restrict__ out) {
  tile_layer_at<DIN, R, RELU, S, NT, RB, WS>(w, in, out, threadIdx.x);
}

// Copy rows x [rows][K] (row stride K, starting at particle k0) into a
// [rows][S] tile, or the tile back out, as float4, NT threads.
template <bool kLoad, int S, int NT = kTrunkThreads>
__device__ __forceinline__ void move_tile(float* tile, const float* src, float* dst, int rows,
                                          int K, int k0) {
  for (int v = threadIdx.x; v < rows * (kTile / 4); v += NT) {
    const int d = v / (kTile / 4), p = (v % (kTile / 4)) * 4;
    const size_t g = (size_t)d * K + k0 + p;
    if (kLoad) {
      *reinterpret_cast<float4*>(tile + d * S + p) = *reinterpret_cast<const float4*>(src + g);
    } else {
      *reinterpret_cast<float4*>(dst + g) = *reinterpret_cast<const float4*>(tile + d * S + p);
    }
  }
}

// One thread's part of Σ_d (z_f² − ε²) + Σ_e z_g² for tile particle p: rows
// part, part + kParts, ... of x_new, f's mean, ε ([DX][S] tiles) and g's
// mean ([DY][S]), with y [DY] and sconst = (1/s_f, 1/s_g). Written op by op
// with round-to-nearest intrinsics, so no contraction differs between the
// kernels that call it.
template <int DX, int DY, int S>
__device__ __forceinline__ float alpha_part(const float* xn, const float* mf, const float* ep,
                                            const float* mg, const float* y,
                                            const float* sconst, int p, int part) {
  float acc = 0.0f;
  for (int d = part; d < DX; d += kParts) {
    const float zf = __fmul_rn(__fsub_rn(xn[d * S + p], mf[d * S + p]), sconst[d]);
    const float e = ep[d * S + p];
    acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(zf, zf), __fmul_rn(e, e)));
  }
  for (int q = part; q < DY; q += kParts) {
    const float zg = __fmul_rn(__fsub_rn(y[q], mg[q * S + p]), sconst[DX + q]);
    acc = __fadd_rn(acc, __fmul_rn(zg, zg));
  }
  return acc;
}

// The unfloored α of tile particle p from the kParts parts red[j][p]
// ([kParts][kTile]), added in order, and the K-independent bias ab.
__device__ __forceinline__ float alpha_total(const float* red, int p, float ab) {
  float s = red[p];
#pragma unroll
  for (int j = 1; j < kParts; ++j) s = __fadd_rn(s, red[j * kTile + p]);
  return __fadd_rn(__fmul_rn(-0.5f, s), ab);
}

}  // namespace psvo
