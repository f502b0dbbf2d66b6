// The large-K resampling step, in two kernels: ancestor indices, then the
// particle gather; and the gather's VJP. The per-step trunk path
// (smc._forward_filter_trunk) runs the first two before each trunk_forward
// launch, and its backward the third.
//
// K7 ancestor_indices_large: logw [B, K] and the sorted positions [B, K]
// (systematic or multinomial) -> idx int32 [B, K]. Replaces
// psvo_tpu/ops/pallas_resample.py::_indices_large (its kernel body is
// _two_level_indices: an MXU triangular cumsum and a two-level
// compare-and-count, built for the TPU's lanes). The index semantics are the
// count form a_i = #{j : C_j <= pos_i·C_{K-1}} of
// fused_step.count_form_indices, with C the inclusive CDF of
// w_j = expf(lw_j - max lw) accumulated in fp64. Bounded by latency, not
// bytes (8 KB a row in, 4 KB out). Two designs:
//  - "cluster" (ancestor_indices_cluster_kernel, the one the paths run): a
//    row on a thread-block cluster of C CTAs (cluster.cuh; the host picks C,
//    resample_gather.k7_cluster: 8 at B = 8, K = 8192, so 64 CTAs, not 8).
//    Each CTA owns a slice of K/C log-weights and the same slice of
//    positions. It loads its slice with 16-byte loads and exchanges the
//    slice maxima over DSMEM; scans its slice in fp64 (a thread's
//    consecutive weights, the warp's shuffles, the warps in order: at C = 1
//    the row design's order, bit for bit); exchanges the slice totals over
//    DSMEM and offsets its slice by the lower ranks' totals added in rank
//    order, so the row total, their sum in the same order, is C_{K-1} bit
//    for bit; pushes its offset slice into every CTA's shared memory (a
//    DSMEM store, unlike a load, waits for no round trip); and searches its
//    own positions against the whole CDF: a binary search for a thread's
//    first position, then, the positions being sorted, a galloping search
//    from the previous answer. So a degenerate row (every
//    position in one ancestor) costs what a healthy one costs. Shared
//    memory 8·(K + 10) + 4·(K/C + 9) bytes (k7_cluster_smem).
//  - "row" (ancestor_indices_large_kernel, the previous design, kept as the
//    yardstick): one CTA per row (8 at the Lorenz-96 preset), the CDF a
//    block scan of 32 weights a thread (resample.cuh::block_cdf), and a
//    binary search of log2(K) dependent probes for every particle. Shared
//    memory 12·K + 96 bytes: K up to 19200 fits the 227 KB a CTA may use,
//    which caps both designs.
//
// K8 gather_particles: x [B, D, K], idx int32 [B, K] -> x[b, d, idx[b, k]].
// Replaces the gather half of pallas_resample.py::_win_pallas_call
// (_win_gather_kernel) together with what _win_gather's validity cond
// falls back to: _compact_gather (and its use of _rank_of_positions) and
// XLA's dynamic gather. Those windows, anchors and ranks exist because a TPU
// core cannot address lanes one by one; on Hopper a gather by index is a
// plain load, so one kernel covers every regime, degenerate weights
// included. Bounded by bytes (each x_res element written once, each source
// read once when the indices are near the identity); a grid over (k-tile,
// d-tile, b) puts B·ceil(D/8)·ceil(K/256) CTAs on the card, not B. The
// indices must lie in [0, K): K7 guarantees it.
//
// K11 segment_sum_scatter, the VJP of K8: g [B, D, K], idx int32 [B, K]
// nondecreasing along K -> d_x[b, d, s] = Σ_{q : idx[b,q] = s} g[b, d, q],
// exactly 0 for a source with no children. Replaces four TPU functions that
// compute this one transpose of a gather by sorted indices:
// pallas_resample.py::_rg_bwd's fused _scatter_kernel (one-hot MXU scatter,
// K <= 2048), the scatter half of _win_pallas_call (_win_scatter_kernel,
// 128-lane windows), and the fallback _sorted_segsum with its
// _rank_of_positions (a bf16-exact rank) and _lane_cumsum (a triangular-
// matmul cumsum). Those exist because a TPU core moves whole lanes; on
// Hopper one segmented sum covers every K and every regime. The children of
// each ancestor are one contiguous run of q, summed by a segmented scan
// (head flags where idx changes) whose additions follow a fixed tree
// (within a thread, then the warp's shuffles, then the warps in order): no
// atomics, the same bits on every launch. Bounded by bytes: g read once,
// d_x written once. idx must be nondecreasing in [0, K), as K7's are; an
// index outside [0, K) is dropped. Two designs:
//  - "tiled" (segment_sum_tiled_kernel<P>, the one the paths run): a CTA per
//    (b, tile of 256·P particles, group of 32/P state rows), the tiles of a
//    (b, group) one cluster (resample_gather.k11_plan: P = 8 and 4 tiles of
//    2048 at K = 8192, 4 state rows a CTA, so 8 × 4 × 10 = 320 CTAs at the
//    preset, each doing one chunk; three CTAs an SM, so that all are
//    resident at once). A
//    thread owns P consecutive particles: idx as int4, g as float4 per state
//    row; the run flags are computed once for the group's rows. A run that
//    crosses into a tile is finished by the tile where it ends: that tile
//    adds the aggregates of the tiles before it, in tile order, read over
//    DSMEM. The CTA of tile [q0, q1) owns the sources [q0, q1) of its rows,
//    staged in shared memory (zeroed, 32 KB): the thread where a run ends
//    stores the run's total into the stage of its source's owner (over DSMEM
//    when that is another CTA), and each CTA then writes its stage out with
//    16-byte stores. So every output element is written exactly once,
//    childless sources as 0, and every CTA reads and writes the same bytes
//    whatever the indices (one ancestor a row included).
//  - "row" (segment_sum_scatter_kernel, the previous design, kept as the
//    yardstick): one CTA per (b, d) row walks the row in chunks of 1024
//    particles with a carry between chunks, the row's output held in shared
//    memory (K floats, zeroed first) and written out whole.
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "resample.cuh"

namespace psvo {

__global__ void __launch_bounds__(kThreads)
    ancestor_indices_large_kernel(const float* logw, const float* pos, int K, int* idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cdf = reinterpret_cast<double*>(smem);        // [K]
  double* dred = cdf + K;                                // [kWarps]
  float* lw = reinterpret_cast<float*>(dred + kWarps);  // [K]
  float* red = lw + K;                                   // [kWarps]
  const size_t row = (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += kThreads) lw[i] = logw[row + i];
  __syncthreads();
  const float m = block_max_of(lw, K, red);
  float s1, s2;
  const double total = block_cdf(lw, K, m, cdf, dred, red, &s1, &s2);
  for (int i = threadIdx.x; i < K; i += kThreads) {
    idx[row + i] = ancestor(cdf, K, static_cast<double>(pos[row + i]) * total);
  }
}

constexpr int kGatherRows = 8;  // state rows per CTA: the index is loaded once for them

__global__ void __launch_bounds__(kThreads)
    gather_particles_kernel(const float* x, const int* idx, int D, int K, float* out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const int b = blockIdx.z, d0 = blockIdx.y * kGatherRows;
  const int a = idx[(size_t)b * K + k];
  const int rows = min(kGatherRows, D - d0);
  const float* src = x + ((size_t)b * D + d0) * K;
  float* dst = out + ((size_t)b * D + d0) * K;
  for (int d = 0; d < rows; ++d) dst[(size_t)d * K + k] = src[(size_t)d * K + a];
}

constexpr int kSegPer = 4;                    // consecutive particles per thread
constexpr int kSegChunk = kThreads * kSegPer;  // particles per block-wide scan

// (fa, va) ⊕ (fb, vb) of a segmented sum: a head flag fb restarts the sum.
__device__ __forceinline__ void seg_add(int fa, float va, int& fb, float& vb) {
  vb = fb ? vb : va + vb;
  fb |= fa;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_scatter_kernel(const float* g, const int* idx, int D, int K, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [K]: this row's d_x
  __shared__ int tot_f[kWarps + 1];             // warp totals, then the prefixes
  __shared__ float tot_v[kWarps + 1];
  __shared__ int pre_f[kWarps + 1];
  __shared__ float pre_v[kWarps + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d = blockIdx.x;
  const float* grow = g + ((size_t)b * D + d) * K;
  const int* irow = idx + (size_t)b * K;
  for (int s = tid; s < K; s += kThreads) acc[s] = 0.0f;
  if (tid == 0) {
    pre_f[kWarps] = 1;  // the carry into the first chunk: an empty run
    pre_v[kWarps] = 0.0f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < K; c0 += kSegChunk) {
    const int q0 = c0 + tid * kSegPer;
    int a[kSegPer], h[kSegPer], last[kSegPer];
    float v[kSegPer];
    int prev = q0 > 0 && q0 <= K ? irow[q0 - 1] : -1;
#pragma unroll
    for (int j = 0; j < kSegPer; ++j) {
      const int q = q0 + j;
      const bool live = q < K;
      a[j] = live ? irow[q] : -1;
      v[j] = live ? grow[q] : 0.0f;
      h[j] = !live || q == 0 || a[j] != prev;  // a run starts here
      last[j] = live && (q == K - 1 || irow[q + 1] != a[j]);  // a run ends here
      prev = a[j];
    }
    // this thread's aggregate, in particle order
    int f = h[0];
    float s = v[0];
#pragma unroll
    for (int j = 1; j < kSegPer; ++j) {
      int fj = h[j];
      float sj = v[j];
      seg_add(f, s, fj, sj);
      f = fj;
      s = sj;
    }
    // inclusive scan of the aggregates within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fo = __shfl_up_sync(kFull, f, o);
      const float so = __shfl_up_sync(kFull, s, o);
      if (lane >= o) seg_add(fo, so, f, s);
    }
    int fx = __shfl_up_sync(kFull, f, 1);  // exclusive, within the warp
    float sx = __shfl_up_sync(kFull, s, 1);
    if (lane == 31) {
      tot_f[warp] = f;
      tot_v[warp] = s;
    }
    __syncthreads();
    if (tid == 0) {  // the warps' prefixes in order, the previous chunk's carry first
      int cf = pre_f[kWarps];
      float cv = pre_v[kWarps];
      for (int w = 0; w < kWarps; ++w) {
        pre_f[w] = cf;
        pre_v[w] = cv;
        int tf = tot_f[w];
        float tv = tot_v[w];
        seg_add(cf, cv, tf, tv);
        cf = tf;
        cv = tv;
      }
      pre_f[kWarps] = cf;  // the carry into the next chunk
      pre_v[kWarps] = cv;
    }
    __syncthreads();
    int pf = pre_f[warp];
    float pv = pre_v[warp];
    if (lane > 0) {
      seg_add(pf, pv, fx, sx);
      pf = fx;
      pv = sx;
    }
#pragma unroll
    for (int j = 0; j < kSegPer; ++j) {
      int fj = h[j];
      float sj = v[j];
      seg_add(pf, pv, fj, sj);
      pf = fj;
      pv = sj;
      if (last[j] && a[j] >= 0 && a[j] < K) acc[a[j]] = sj;
    }
  }
  __syncthreads();
  float* orow = out + ((size_t)b * D + d) * K;
  for (int s = tid; s < K; s += kThreads) orow[s] = acc[s];
}

// ---- K7, the cluster design ----

struct K7Args {
  const float* logw;  // [B, K]
  const float* pos;   // [B, K], sorted along K
  int* idx;           // [B, K]
  int K, cluster;
  int vec;  // a thread's particles come in and go out by 16 bytes (K/C/kThreads % 4 == 0)
};

// Dynamic shared memory of one CTA: the row's fp64 CDF [K], a slot per warp,
// the slice total (two slots, so that what follows stays 16-byte aligned);
// the slice's log-weights [K/C], a slot per warp, the slice max.
inline size_t k7_cluster_smem(int K, int C) {
  return sizeof(double) * (K + kWarps + 2) + sizeof(float) * (K / C + kWarps + 1);
}

// The first index in [lo, hi) whose cdf exceeds t, or hi (cdf nondecreasing).
__device__ __forceinline__ int first_above(const double* cdf, int lo, int hi, double t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) ancestor_indices_cluster_kernel(const K7Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = a.K, C = a.cluster, rank = static_cast<int>(cluster.block_rank());
  const int S = K / C, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double* cdf = reinterpret_cast<double*>(smem);  // [K]: the row's CDF
  double* dred = cdf + K;                         // [kWarps]
  double* total = dred + kWarps;                  // this slice's total, read by the other ranks
  float* lw = reinterpret_cast<float*>(total + 2);  // [S]: this slice's log-weights
  float* red = lw + S;                              // [kWarps]
  float* smax = red + kWarps;  // this slice's max, read by the other ranks
  const size_t row = (size_t)(blockIdx.x / C) * K;
  const int lo = rank * S;                           // this CTA's slice [lo, lo + S)
  const int per = S >= kThreads ? S / kThreads : 1;  // S < kThreads only at C = 1
  const int base = tid * per;                        // this thread's [lo + base, lo + base + per)
  const bool active = base < S;
  float4 p4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // its first four positions, loaded early
  if (active && a.vec) p4 = *reinterpret_cast<const float4*>(a.pos + row + lo + base);

  // 1. the slice in, its max; the row max over the cluster
  float m = __int_as_float(0xff800000);  // -inf
  if (active) {
    const float* src = a.logw + row + lo + base;
    if (a.vec) {
      for (int j = 0; j < per; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(src + j);
        *reinterpret_cast<float4*>(lw + base + j) = v;
        m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      }
    } else {
      for (int j = 0; j < per; ++j) {
        lw[base + j] = src[j];
        m = fmaxf(m, src[j]);
      }
    }
  }
  m = block_reduce<true>(m, red);
  if (tid == 0) *smax = m;
  cluster.sync();  // also: every CTA of the row has started before the first DSMEM access
  float ms[kMaxCluster];  // the ranks' maxima, the loads all issued at once
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) ms[q] = q < C ? *cluster.map_shared_rank(smax, q) : m;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) m = fmaxf(m, ms[q]);

  // 2. the slice's inclusive scan, as block_cdf takes it: a thread's weights
  // in order, the warp's shuffles, the warps in order
  double run = 0.0;
  if (active) {
    for (int j = 0; j < per; ++j) {
      run += static_cast<double>(expf(lw[base + j] - m));
      cdf[lo + base + j] = run;
    }
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) dred[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) excl += dred[w];
  if (active) {
    for (int j = 0; j < per; ++j) cdf[lo + base + j] += excl;
    if (base + per == S) *total = cdf[lo + S - 1];  // the slice's last value, as its owner holds it
  }
  cluster.sync();

  // 3. the offsets: the lower ranks' totals added in rank order; the row
  // total is all of them in that order, the last rank's offset plus its
  // total, so it equals C_{K-1} as the owner of K - 1 forms it
  double ts[kMaxCluster];  // the ranks' totals, the loads all issued at once
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) ts[q] = q < C ? *cluster.map_shared_rank(total, q) : 0.0;
  double acc = 0.0, off = 0.0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q == rank) off = acc;
    if (q < C) acc += ts[q];
  }
  const double row_total = acc;

  // 4. this slice, offset, into every CTA of the cluster (its own in
  // place): stores over DSMEM, which need no round trip, then a barrier
  if (C > 1 && active) {
    const int step = per % 2 == 0 ? 2 : 1;  // pairs where they stay 16-byte aligned
    for (int j = 0; j < per; j += step) {
      const int i = lo + base + j;
      if (step == 2) {
        const double2 v = make_double2(cdf[i] + off, cdf[i + 1] + off);
        for (int q = 0; q < C; ++q) {
          *reinterpret_cast<double2*>(q == rank ? cdf + i : cluster.map_shared_rank(cdf + i, q)) = v;
        }
      } else {
        const double v = cdf[i] + off;
        for (int q = 0; q < C; ++q) *(q == rank ? cdf + i : cluster.map_shared_rank(cdf + i, q)) = v;
      }
    }
  }
  cluster.sync();  // every slice in every CTA; no DSMEM access after this

  // 5. this thread's positions against the whole CDF: a binary search for the
  // first, a galloping one from the previous count for the rest (sorted)
  if (!active) return;
  const float* pos = a.pos + row + lo + base;
  int* out = a.idx + row + lo + base;
  int count = 0;
  double prev = 0.0;
  for (int j = 0; j < per; j += 4) {
    float p[4];
    if (a.vec) {
      if (j > 0) p4 = *reinterpret_cast<const float4*>(pos + j);
      p[0] = p4.x;
      p[1] = p4.y;
      p[2] = p4.z;
      p[3] = p4.w;
    }
    int got[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j + u >= per) break;
      const double t = static_cast<double>(a.vec ? p[u] : pos[j + u]) * row_total;
      if (j + u == 0 || t < prev) {
        count = first_above(cdf, 0, K, t);
      } else {
        int l = count, h = count, step = 1;
        while (h < K && cdf[h] <= t) {
          l = h + 1;
          h = min(K, h + step);
          step <<= 1;
        }
        count = first_above(cdf, l, h, t);
      }
      prev = t;
      got[u] = count < K - 1 ? count : K - 1;
    }
    if (a.vec) {
      *reinterpret_cast<int4*>(out + j) = make_int4(got[0], got[1], got[2], got[3]);
    } else {
      for (int u = 0; u < 4 && j + u < per; ++u) out[j + u] = got[u];
    }
  }
}

// ---- K11, the tiled design ----

struct K11Args {
  const float* g;  // [B, D, K]
  const int* idx;  // [B, K], nondecreasing along K
  float* out;      // [B, D, K]
  int D, K;
  int groups;   // ceil(D / rows): groups of state rows
  int cluster;  // tiles a row: C = ceil(K / tile)
  int vec;      // 16-byte loads and stores (K % 4 == 0, aligned)
};

// Dynamic shared memory of one CTA of P particles a thread: the stage of its
// sources [rows][tile], the warps' aggregates [rows][kWarps], their prefixes
// and the tile's aggregate [rows][kWarps + 1], the carry [rows]; the warps'
// flags and the tile's.
inline size_t k11_tiled_smem(int per) {
  const int rows = 32 / per;
  return sizeof(float) * (rows * kThreads * per + rows * (2 * kWarps + 2)) +
         sizeof(int) * (kWarps + 1);
}

template <int P>
__device__ __forceinline__ void load_run(const float* src, int q, int K, bool vec, float (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    if (vec) {
      const float4 x = q + j < K ? *reinterpret_cast<const float4*>(src + q + j)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[j] = x.x;
      v[j + 1] = x.y;
      v[j + 2] = x.z;
      v[j + 3] = x.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[j + u] = q + j + u < K ? src[q + j + u] : 0.0f;
    }
  }
}

template <int P>
__device__ __forceinline__ void load_run(const int* src, int q, int K, bool vec, int (&v)[P]) {
#pragma unroll
  for (int j = 0; j < P; j += 4) {
    if (vec) {
      const int4 x = q + j < K ? *reinterpret_cast<const int4*>(src + q + j) : make_int4(-1, -1, -1, -1);
      v[j] = x.x;
      v[j + 1] = x.y;
      v[j + 2] = x.z;
      v[j + 3] = x.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[j + u] = q + j + u < K ? src[q + j + u] : -1;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 3) segment_sum_tiled_kernel(const K11Args a) {
  constexpr int R = 32 / P, T = kThreads * P;  // state rows a CTA, particles a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [R][T]: d_x of the sources [q0, q0 + T)
  float* wtot = stage + R * T;                     // [R][kWarps]: the warps' aggregates
  float* pre = wtot + R * kWarps;  // [R][kWarps + 1]: the warps' prefixes, then the tile's
  float* carry = pre + R * (kWarps + 1);  // [R]: the earlier tiles' aggregate
  int* wflag = reinterpret_cast<int*>(carry + R);  // [kWarps]: a run starts in the warp
  int* aggf = wflag + kWarps;                      // a run starts in the tile
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster, rank = static_cast<int>(cluster.block_rank());
  const int K = a.K, D = a.D, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = blockIdx.x / C, b = cl / a.groups, d0 = (cl % a.groups) * R;
  const int q0 = rank * T, q = q0 + tid * P;  // the tile [q0, q0 + T), the thread's [q, q + P)
  const int* irow = a.idx + (size_t)b * K;
  const bool vec = a.vec != 0;

  // the indices, the loads of every row, and the stage zeroed
  int ai[P];
  load_run<P>(irow, q, K, vec, ai);
  float v[R][P];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (d0 + r < D) {
      load_run<P>(a.g + ((size_t)b * D + d0 + r) * K, q, K, vec, v[r]);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) v[r][j] = 0.0f;
    }
  }
  for (int i = 4 * tid; i < R * T; i += 4 * kThreads) {
    *reinterpret_cast<float4*>(stage + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // the run flags, once for the R rows: bit j of head (last) says that a run
  // starts (ends) at particle q + j; a particle past K is a head of value 0
  int prev = __shfl_up_sync(kFull, ai[P - 1], 1);
  int next = __shfl_down_sync(kFull, ai[0], 1);
  if (lane == 0) prev = q > 0 && q <= K ? irow[q - 1] : -1;
  if (lane == 31) next = q + P < K ? irow[q + P] : -1;
  unsigned head = 0, last = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int qj = q + j;
    const int pj = j == 0 ? prev : ai[j - 1];
    const int nj = j == P - 1 ? next : ai[j + 1];
    if (qj >= K || qj == 0 || ai[j] != pj) head |= 1u << j;
    if (qj < K && (qj == K - 1 || nj != ai[j]) && ai[j] >= 0 && ai[j] < K) last |= 1u << j;
  }
  // the warp's inclusive scan of the flags: bit i of add says that at step i
  // this lane adds the lower lane's sum (no run starts in between)
  int f = head != 0;
  unsigned add = 0;
#pragma unroll
  for (int i = 0, o = 1; o < 32; ++i, o <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) add |= 1u << i;
      f |= fo;
    }
  }
  const int fx = __shfl_up_sync(kFull, f, 1);  // exclusive, within the warp
  if (lane == 31) wflag[warp] = f;

  // each row: the thread's aggregate in particle order, the warp's scan
  float sx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = v[r][0];
#pragma unroll
    for (int j = 1; j < P; ++j) s = (head >> j & 1) ? v[r][j] : s + v[r][j];
#pragma unroll
    for (int i = 0, o = 1; o < 32; ++i, o <<= 1) {
      const float so = __shfl_up_sync(kFull, s, o);
      if (add >> i & 1) s = so + s;
    }
    sx[r] = __shfl_up_sync(kFull, s, 1);
    if (lane == 31) wtot[r * kWarps + warp] = s;
  }
  __syncthreads();

  // each row's warp prefixes, the warps in order, by (kWarps + 1)·R threads
  // (the last one of a row is the tile's aggregate, read by the later tiles)
  if (tid < R * (kWarps + 1)) {
    const int r = tid / (kWarps + 1), w = tid % (kWarps + 1);
    float tv = 0.0f;
    for (int u = 0; u < w; ++u) tv = wflag[u] ? wtot[r * kWarps + u] : tv + wtot[r * kWarps + u];
    pre[tid] = tv;
  }
  unsigned fmask = 0;  // bit w: a run starts in warp w
  for (int u = 0; u < kWarps; ++u) fmask |= (wflag[u] != 0) << u;
  if (tid == 0) *aggf = fmask != 0;
  __syncthreads();

  // the warp's prefix, then the lane's exclusive sum, then the thread's
  // particles: v becomes each particle's inclusive sum within the tile; bit j
  // of open says that no run starts in the tile up to q + j
  int pf = (fmask & ((1u << warp) - 1u)) != 0;
  if (lane > 0) pf |= fx;
  unsigned open = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    pf |= head >> j & 1;
    if (!pf) open |= 1u << j;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float pv = pre[r * (kWarps + 1) + warp];
    if (lane > 0) pv = fx ? sx[r] : pv + sx[r];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pv = (head >> j & 1) ? v[r][j] : pv + v[r][j];
      v[r][j] = pv;
    }
  }
  cluster.sync();  // the aggregates and the zeroed stages; every CTA has started

  // the carry into this tile: the earlier tiles' aggregates in tile order
  // (tile 0 starts a run at particle 0, so it needs none)
  if (rank > 0) {
    if (tid < R) {
      float tv[kMaxCluster];  // the loads all issued at once
      int tf[kMaxCluster];
#pragma unroll
      for (int u = 0; u < kMaxCluster; ++u) {
        tv[u] = u < rank ? *cluster.map_shared_rank(pre + tid * (kWarps + 1) + kWarps, u) : 0.0f;
        tf[u] = u < rank ? *cluster.map_shared_rank(aggf, u) : 0;
      }
      float cv = 0.0f;
#pragma unroll
      for (int u = 0; u < kMaxCluster; ++u) {
        if (u < rank) cv = tf[u] ? tv[u] : cv + tv[u];
      }
      carry[tid] = cv;
    }
    __syncthreads();
  }

  // each run's total, every row, into the stage of its source's owner (the
  // rows past D too: their stage is never written out)
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (!(last >> j & 1)) continue;
    const int owner = ai[j] / T;
    float* dst = stage + (ai[j] - owner * T);
    const bool far = owner != rank;
    if (far) dst = cluster.map_shared_rank(dst, owner);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float total = (open >> j & 1) ? carry[r] + v[r][j] : v[r][j];
      if (far)
        dst[r * T] = total;
      else
        stage[ai[j] - owner * T + r * T] = total;
    }
  }
  cluster.sync();  // every total staged; no DSMEM access after this

  // the stage out: this tile's sources of each row
  const int n = min(T, K - q0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (d0 + r >= D) continue;
    float* orow = a.out + ((size_t)b * D + d0 + r) * K + q0;
    const float* srow = stage + r * T;
    if (vec) {
      for (int i = 4 * tid; i < n; i += 4 * kThreads) {
        *reinterpret_cast<float4*>(orow + i) = *reinterpret_cast<const float4*>(srow + i);
      }
    } else {
      for (int i = tid; i < n; i += kThreads) orow[i] = srow[i];
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace psvo

// K7: design 0 the cluster design on clusters of `cluster` CTAs (K / cluster a
// whole number of kThreads-particle chunks, or cluster = 1), 1 the row design
// (one CTA a row; cluster ignored).
extern "C" int psvo_ancestor_indices_large(const float* logw, const float* pos, int* idx, int B,
                                           int K, int design, int cluster, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (cluster < 1 || cluster > psvo::kMaxCluster || K % cluster != 0 ||
        (cluster > 1 && (K / cluster) % psvo::kThreads != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int slice = K / cluster, per = slice >= psvo::kThreads ? slice / psvo::kThreads : 1;
    const int vec = per % 4 == 0 && psvo::aligned16(logw) && psvo::aligned16(pos) &&
                    psvo::aligned16(idx);
    const psvo::K7Args a{logw, pos, idx, K, cluster, vec};
    return static_cast<int>(psvo::launch_clusters(psvo::ancestor_indices_cluster_kernel, a, B,
                                                  cluster, psvo::k7_cluster_smem(K, cluster), s));
  }
  const size_t smem = sizeof(double) * (K + psvo::kWarps) + sizeof(float) * (K + psvo::kWarps);
  cudaError_t err = cudaFuncSetAttribute(psvo::ancestor_indices_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psvo::ancestor_indices_large_kernel<<<B, psvo::kThreads, smem, s>>>(logw, pos, K, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psvo_gather_particles(const float* x, const int* idx, float* out, int B, int D,
                                     int K, void* stream) {
  const dim3 grid((K + psvo::kThreads - 1) / psvo::kThreads,
                  (D + psvo::kGatherRows - 1) / psvo::kGatherRows, B);
  psvo::gather_particles_kernel<<<grid, psvo::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, D, K, out);
  return static_cast<int>(cudaGetLastError());
}

// K11: design 0 the tiled design, `per` particles a thread (4, 8 or 16) on
// clusters of `cluster` tiles (cluster = ceil(K / (kThreads·per)) <= 8); 1 the
// row design (one CTA a (b, d) row; per and cluster ignored).
extern "C" int psvo_segment_sum_scatter(const float* g, const int* idx, float* out, int B, int D,
                                        int K, int design, int per, int cluster, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    const int tile = psvo::kThreads * per;
    if ((per != 4 && per != 8 && per != 16) || cluster < 1 || cluster > psvo::kMaxCluster ||
        (cluster - 1) * tile >= K || cluster * tile < K) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rows = 32 / per, groups = (D + rows - 1) / rows;
    const int vec = K % 4 == 0 && psvo::aligned16(g) && psvo::aligned16(idx) && psvo::aligned16(out);
    const psvo::K11Args a{g, idx, out, D, K, groups, cluster, vec};
    const size_t smem = psvo::k11_tiled_smem(per);
    cudaError_t err;
    if (per == 4)
      err = psvo::launch_clusters(psvo::segment_sum_tiled_kernel<4>, a, B * groups, cluster, smem, s);
    else if (per == 8)
      err = psvo::launch_clusters(psvo::segment_sum_tiled_kernel<8>, a, B * groups, cluster, smem, s);
    else
      err = psvo::launch_clusters(psvo::segment_sum_tiled_kernel<16>, a, B * groups, cluster, smem, s);
    return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * K;
  cudaError_t err = cudaFuncSetAttribute(psvo::segment_sum_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  psvo::segment_sum_scatter_kernel<<<dim3(D, B), psvo::kThreads, smem, s>>>(g, idx, D, K, out);
  return static_cast<int>(cudaGetLastError());
}
