#!/usr/bin/env python3
"""Per-stage cycle profiles of the redesigned kernels on one GPU, and the
variants that show what holds K5 back.

    python3 tools/stage_profile.py            # every kernel below
    python3 tools/stage_profile.py resample   # K7 and K11 alone
    python3 tools/stage_profile.py ffbsi      # K6 alone

Builds the port's kernels as `chip_smoke.py` does, then copies of
`csrc/ffbsi.cu`, `csrc/svo_sweep.cuh` and `csrc/trunk_forward.cuh` patched
three ways, each with nvcc into `psvo_tpu_torch/_build/stage_profile/`
(gitignored):

- "marks": `clock64()` at the stage boundaries of `ffbsi_staged_kernel`,
  `svo_backward_split_kernel`, both designs of K12 (`svo_forward_split_kernel`,
  `svo_forward_kernel`) and of K9 (`trunk_forward_async_kernel`,
  `trunk_forward_kernel`), K7's cluster design (`ancestor_indices_cluster_kernel`),
  K11's tiled design (`segment_sum_tiled_kernel`) and K6's staged design
  (`ffbsi_bwd_staged_kernel`, whole rows, over every row its persistent CTA 0
  takes; `ffbsi_bwd_paths_kernel`); CTA 0's thread 0 adds
  each stage's cycles into a
  device array, read back after one launch (a stage's cycles include the
  barrier that closes it);
- "compute only": K5 staged without the copies inside its loop (the first
  chunks stay in their slots and are computed again and again: wrong
  results, the time of everything but the copies);
- "one copy a span": K5 staged with one bulk copy a span of a whole row
  (sixteen at P = 4) instead of seven.

Operands at the presets' shapes, drawn from a seed: K5 at
`lorenz63_psvo_k1024`'s (B=32, M=16, K=1024, T-1=99, Dx=3; support terms of
a transition near the support, normalized log-weights, Gumbels), K13 at
`lorenz63_svo_k256`'s (B=32, M=16, T-1=99, hidden (64, 64), random weights
nudged from init), K12 on the same operands, K9 at
`lorenz96_fivo_k8192_sharded`'s (B=8, K=8192, Dx=Dy=40, hidden (64, 64),
random weights; streamed ε and the in-kernel draw), K7 and K11 at its
resampling step's ([8, 8192] healthy log-weights; [8, 40, 8192] on their
ancestors and on rows of one ancestor), K6 on K5's selections at
`lorenz63_psvo_k1024`'s shape with every cotangent, the direct bound's and the
paths' alone (both designs). Times are device time
per call from torch.profiler over 20 calls, designs alternated. Exits non-zero without a card or if a patch's
anchor is missing from the sources. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MARK = ('__device__ long long g_prof{n}[32];\n'
        '#define PROF{n}(i) do {{ const long long now_ = clock64(); if (blockIdx.x == 0 && {cta}'
        'threadIdx.x == 0) g_prof{n}[i] += now_ - prof_t_; prof_t_ = now_; }} while (0)\n'
        'extern "C" int psvo_prof{n}(long long* out) {{ cudaMemcpyFromSymbol(out, g_prof{n}, '
        'sizeof(g_prof{n})); long long z[32] = {{0}}; return (int)cudaMemcpyToSymbol(g_prof{n}, z, '
        'sizeof(z)); }}\n')
K5_STAGES = ["wait for the chunk, barrier, next chunk's copies issued", "the logits",
             "butterflies", "barrier", "argmax merge, the pick, logp (lse window every 32 steps)"]
K13_STAGES = ["tile operands", "qb and f forward", "-", "f terms", "f backward", "g forward",
              "g terms", "g backward", "J_t", "the recurrence", "qb backward", "sc sums"]
K12_SPLIT_STAGES = ["chunk copies wait, barrier", "chain: registers loaded", "chain: qb's first layer, the path's barrier",
                    "chain: middle layers", "chain: head (16-deep sums, two shuffles)",
                    "chain: draw, stores, the path's barrier", "barrier after the chain",
                    "f and g over the rows, terms", "barrier, sums"]
K12_CHAIN_STAGES = ["operands, barrier", "qb's first layer, barrier", "qb's middle layers",
                    "qb's head, the draw, barrier", "f's and g's first layers, barrier",
                    "f's and g's middle layers", "f's and g's heads, barrier",
                    "terms (one thread), barrier"]
K9_ASYNC_STAGES = ["copy wait, barrier (the other warps' draw of this tile's ε)",
                   "q1 and f side by side, next copies started", "the draw, x_new out",
                   "g", "α"]
K9_TILE_STAGES = ["top barrier", "loads (x_res; ε or the draw), coefficients, barrier",
                  "q1, then f", "the draw, barrier, x_new out", "g", "α, barrier"]
K7_STAGES = ["the slice in, its max", "cluster barrier, the row max over DSMEM",
             "the slice's scan (exp, a thread's weights, the warp's shuffles)",
             "barrier, the warps' prefixes, cluster barrier", "the offsets over DSMEM",
             "the slice pushed to every CTA over DSMEM, cluster barrier",
             "the searches, the indices out"]
K6_STAGES = ["wait for the row's copies, barrier", "the next row's copies and zeros issued",
             "the logits (one pair evaluation a (m, j))", "max: reduce-scatter, barrier",
             "e = exp(logit - max)", "sums: reduce-scatter, barrier", "the sums merged over the warps",
             "the soft part of d_pair, per particle", "d_q, barriers", "the picks' part, the stores",
             "the patch (cotangents, barrier, owners)"]
K6_PATHS_STAGES = ["the zero stores issued", "wait for the batch's copies, barrier",
                   "the next batch's copies issued", "the patch"]
K11_STAGES = ["loads issued, the stage zeroed", "run flags (waits on idx), their warp scan",
              "each row's thread and warp scans (waits on g)", "barrier",
              "the warps' prefixes, barrier, each particle's sum in the tile", "cluster barrier",
              "the carry over DSMEM",
              "each run's total into its owner's stage", "cluster barrier", "the stage out"]


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        sys.exit(f"stage_profile: anchor not found: {old[:70]!r}")
    return text.replace(old, new, 1)


def marked_k5(src: str) -> str:
    s = sub(src, '#include "resample.cuh"\n', '#include "resample.cuh"\n' + MARK.format(cta="", n=5))
    s = sub(s, "  for (int s = 0; s < total; ++s) {\n    if (vec) {\n",
            "  long long prof_t_ = clock64();\n  for (int s = 0; s < total; ++s) {\n    if (vec) {\n")
    s = sub(s, "    const int t = T1 - 1 - s / NCH, ch = s % NCH, j0 = ch * KC;\n",
            "    PROF5(0);\n    const int t = T1 - 1 - s / NCH, ch = s % NCH, j0 = ch * KC;\n")
    s = sub(s, "    if (ch + 1 < NCH) continue;", "    PROF5(1);\n    if (ch + 1 < NCH) continue;")
    s = sub(s, "    __syncthreads();\n    // the argmax over the eight warps",
            "    PROF5(2);\n    __syncthreads();\n    PROF5(3);\n    // the argmax over the eight warps")
    return sub(s, "      }\n    }\n  }\n#pragma unroll\n  for (int p = 0; p < P; ++p) {\n"
               "    if (tid == 32 * p && m0 + p < M) {\n      const size_t pt",
               "      }\n    }\n    PROF5(4);\n  }\n#pragma unroll\n  for (int p = 0; p < P; ++p) {\n"
               "    if (tid == 32 * p && m0 + p < M) {\n      const size_t pt")


def marked_k6(src: str) -> str:
    """Stage marks in K6's staged design: the all-cotangents kernel (CTA 0
    of its persistent grid, whole rows, over all its rows) and the
    paths-only kernel (CTA 0's rows)."""
    s = sub(src, '#include "resample.cuh"\n',
            '#include "resample.cuh"\n' + MARK.format(cta="blockIdx.y == 0 && ", n=6)
            + MARK.format(cta="", n=60))
    s = sub(s, "  const int jt = tid * PT;  // this thread's first particle in a chunk\n",
            "  const int jt = tid * PT;  // this thread's first particle in a chunk\n"
            "  long long prof_t_ = clock64();\n")
    s = sub(s, "      __syncthreads();  // this row's buffer is in",
            "      __syncthreads();  PROF6(0);  // this row's buffer is in")
    s = sub(s, "        k6_zero_points<DX>(a, nx / B, nx % B, vec);\n      }\n      clear();\n",
            "        k6_zero_points<DX>(a, nx / B, nx % B, vec);\n      }\n      PROF6(1);\n      clear();\n")
    s = sub(s, "        logits(bf, g0, K);\n", "        logits(bf, g0, K);\n        PROF6(2);\n")
    s = sub(s, "redm[(lane / (32 / G)) * kWarps + warp] = wm;\n    __syncthreads();\n",
            "redm[(lane / (32 / G)) * kWarps + warp] = wm;\n    __syncthreads();\n    PROF6(3);\n")
    s = sub(s, "    exps(mx);\n    const float* st = bf + L.st;\n",
            "    exps(mx);\n    PROF6(4);\n    const float* st = bf + L.st;\n")
    s = sub(s, "      sums(std::false_type{});\n    }\n    __syncthreads();\n",
            "      sums(std::false_type{});\n    }\n    __syncthreads();\n    PROF6(5);\n")
    s = sub(s, "        q_out[qn] = s;\n      }\n    }\n  };", "        q_out[qn] = s;\n      }\n    }\n    PROF6(6);\n  };")
    s = sub(s, "        accumulate(bf, g0, K, inv, careful);\n",
            "        accumulate(bf, g0, K, inv, careful);\n        PROF6(7);\n")
    s = sub(s, "      dq_pass(bf, row);\n      __syncthreads();  // d_q and the picks' floors\n",
            "      dq_pass(bf, row);\n      __syncthreads();  // d_q and the picks' floors\n      PROF6(8);\n")
    s = sub(s, "      finish(bf, row, 0, K);\n", "      finish(bf, row, 0, K);\n      PROF6(9);\n")
    s = sub(s, "      patch_row(bf, t, b);\n    }\n  } else {",
            "      patch_row(bf, t, b);\n      PROF6(10);\n    }\n  } else {")
    # the paths-only kernel
    s = sub(s, "  if (batch < batches) issue(batch, sp);\n",
            "  if (batch < batches) issue(batch, sp);\n  long long prof_t_ = clock64();\n")
    s = sub(s, "    cp_async_wait<0>();\n    __syncthreads();  // the batch's operands in",
            "    PROF60(0);\n    cp_async_wait<0>();\n    __syncthreads();  PROF60(1);  // the batch's operands in")
    s = sub(s, "issue(batch + gridDim.x, sp + ((it + 1) & 1) * R * per_row);\n",
            "issue(batch + gridDim.x, sp + ((it + 1) & 1) * R * per_row);\n    PROF60(2);\n")
    return sub(s, "                      reinterpret_cast<const int*>(bf + r * per_row), first, kThreads);\n    }\n",
               "                      reinterpret_cast<const int*>(bf + r * per_row), first, kThreads);\n    }\n"
               "    PROF60(3);\n")


def marked_k13(src: str) -> str:
    s = sub(src, "#include <cstdint>\n", "#include <cstdint>\n" + MARK.format(cta="", n=13))
    s = sub(s, "  const int NP = a.B * a.M, groups = (NP + P - 1) / P, CH = rows / P;\n",
            "  const int NP = a.B * a.M, groups = (NP + P - 1) / P, CH = rows / P;\n"
            "  long long prof_t_ = clock64();\n")
    for anchor, i in (("      // 1. qb's hidden layers and f's forward", 0),
                      ("      // 2. the f and noise terms' cotangents", 1),
                      ("      split_net_backward<DX, H, DX, true>(wf", 3),
                      ("      // 3. g likewise\n", 4),
                      ("      split_net_backward<DX, H, DY, true>(wg", 6),
                      ("      // 4. J_t", 7),
                      ("      // 5. the recurrence, one thread per path, t ascending\n", 8),
                      ("      // 6. qb's VJP from dmb\n", 9),
                      ("      // 7. the tile's sc sums, rows in order\n", 10)):
        s = sub(s, anchor, f"      PROF13({i});\n" + anchor)
    s = sub(s, "      split_net_forward<DX, H, DY>(wg, xt, 4, af, rows, n_mid, dmn, nr);\n",
            "      split_net_forward<DX, H, DY>(wg, xt, 4, af, rows, n_mid, dmn, nr);\n"
            "      PROF13(5);\n")
    return sub(s, "s += sg[r * 12 + e];\n        gsum[a.n_weights + e] += s;\n      }\n"
               "      __syncthreads();\n",
               "s += sg[r * 12 + e];\n        gsum[a.n_weights + e] += s;\n      }\n"
               "      __syncthreads();\n      PROF13(11);\n")


def marked_k12(src: str) -> str:
    """Stage marks in both K12 designs (thread 0 of CTA 0: a chain lane of
    the split design)."""
    s = sub(src, '#include "async_copy.cuh"\n',
            '#include "async_copy.cuh"\n' + MARK.format(cta="", n=12) + MARK.format(cta="", n=120))
    s = sub(s, "  float lp = 0.0f, lq = 0.0f;  // thread p < P: path p's sums\n",
            "  float lp = 0.0f, lq = 0.0f;  // thread p < P: path p's sums\n"
            "  long long prof_t_ = clock64();\n")
    s = sub(s, "    cp_async_wait<0>();\n    __syncthreads();\n    if (chain) {\n",
            "    cp_async_wait<0>();\n    __syncthreads();\n    PROF12(0);\n    if (chain) {\n")
    s = sub(s, "      const float b3 = w3p[H * DX + ho];\n",
            "      const float b3 = w3p[H * DX + ho];\n      PROF12(1);\n")
    s = sub(s, "          h0[gl] = v < 0.0f ? 0.0f : v;\n        }\n        path_sync<H>(p);\n",
            "          h0[gl] = v < 0.0f ? 0.0f : v;\n        }\n        path_sync<H>(p);\n"
            "        PROF12(2);\n")
    s = sub(s, "        // the head: lane (ho, hk) adds the terms j = hk mod 4 of output ho\n",
            "        PROF12(3);\n        // the head: lane (ho, hk) adds the terms j = hk mod 4 of output ho\n")
    s = sub(s, "        s = s + __shfl_xor_sync(0xffffffffu, s, 2);\n",
            "        s = s + __shfl_xor_sync(0xffffffffu, s, 2);\n        PROF12(4);\n")
    s = sub(s, "the head's reads are done\n      }\n    }\n    __syncthreads();\n",
            "the head's reads are done\n        PROF12(5);\n      }\n"
            "    }\n    __syncthreads();\n    PROF12(6);\n")
    s = sub(s, "    __syncthreads();\n    if (tid < P) {  // t descending",
            "    PROF12(7);\n    __syncthreads();\n    if (tid < P) {  // t descending")
    s = sub(s, "        lq += tl[(c * P + tid) * 2 + 1];\n      }\n    }\n  }\n",
            "        lq += tl[(c * P + tid) * 2 + 1];\n      }\n    }\n    PROF12(8);\n  }\n")
    # the chain design
    s = sub(s, "  float lp = 0.0f, lq = 0.0f;  // thread j == 0 of each path\n",
            "  float lp = 0.0f, lq = 0.0f;  // thread j == 0 of each path\n  long long prof_t_ = clock64();\n")
    s = sub(s, "    if (j < DX) ep[j] = live ? a.eps[((size_t)t * NP + path) * DX + j] : 0.0f;\n    __syncthreads();\n",
            "    if (j < DX) ep[j] = live ? a.eps[((size_t)t * NP + path) * DX + j] : 0.0f;\n    __syncthreads();\n"
            "    PROF120(0);\n")
    s = sub(s, "    hq[j] = hidden_unit<DQ, H>(wq, qin, j);\n    __syncthreads();\n",
            "    hq[j] = hidden_unit<DQ, H>(wq, qin, j);\n    __syncthreads();\n    PROF120(1);\n")
    s = sub(s, "    if (j < DX) {\n      const float mb = head_unit",
            "    PROF120(2);\n    if (j < DX) {\n      const float mb = head_unit")
    s = sub(s, "      if (live) a.xtilde[((size_t)t * NP + path) * DX + j] = x;\n    }\n    __syncthreads();\n",
            "      if (live) a.xtilde[((size_t)t * NP + path) * DX + j] = x;\n    }\n    __syncthreads();\n"
            "    PROF120(3);\n")
    s = sub(s, "    hg[j] = hidden_unit<DX, H>(wg, xt, j);\n    __syncthreads();\n",
            "    hg[j] = hidden_unit<DX, H>(wg, xt, j);\n    __syncthreads();\n    PROF120(4);\n")
    s = sub(s, "    if (j < DX) {\n      mf[j] = head_unit", "    PROF120(5);\n    if (j < DX) {\n      mf[j] = head_unit")
    s = sub(s, "hg + n_mid * H, j - DX);\n    }\n    __syncthreads();\n",
            "hg + n_mid * H, j - DX);\n    }\n    __syncthreads();\n    PROF120(6);\n")
    return sub(s, "    __syncthreads();  // thread 0 is done with qin and ep\n",
               "    __syncthreads();  // thread 0 is done with qin and ep\n    PROF120(7);\n")


def marked_k9(src: str) -> str:
    """Stage marks in both K9 designs (CTA 0's thread 0)."""
    s = sub(src, '#include "trunk_tile.cuh"\n',
            '#include "trunk_tile.cuh"\n' + MARK.format(cta="", n=9) + MARK.format(cta="", n=90))
    # the tile design
    s = sub(s, "  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {\n",
            "  long long prof_t_ = clock64();\n"
            "  for (int tile = blockIdx.x; tile < a.B * tiles_per_row; tile += gridDim.x) {\n")
    s = sub(s, "weights are in)\n    move_tile<true, kTile>(xa,",
            "weights are in)\n    PROF90(0);\n    move_tile<true, kTile>(xa,")
    s = sub(s, "    for (int i = tid; i < NC; i += kTrunkThreads) cf[i] = a.coef[(size_t)b * NC + i];\n"
               "    __syncthreads();\n",
            "    for (int i = tid; i < NC; i += kTrunkThreads) cf[i] = a.coef[(size_t)b * NC + i];\n"
            "    __syncthreads();\n    PROF90(1);\n")
    s = sub(s, "    tile_net<DX, H, DX>(wts + a.off_f, a.n_mid, xa, mf, h0, h1);\n",
            "    tile_net<DX, H, DX>(wts + a.off_f, a.n_mid, xa, mf, h0, h1);\n    PROF90(2);\n")
    s = sub(s, "    move_tile<false, kTile>(xb, nullptr, a.x_new + row, DX, K, k0);\n",
            "    move_tile<false, kTile>(xb, nullptr, a.x_new + row, DX, K, k0);\n    PROF90(3);\n")
    s = sub(s, "    tile_net<DX, H, DY>(wts + a.off_g, a.n_mid, xb, xa, h0, h1);\n",
            "    tile_net<DX, H, DY>(wts + a.off_g, a.n_mid, xb, xa, h0, h1);\n    PROF90(4);\n")
    s = sub(s, "-3e30f);\n    }\n  }\n}\n\n// ----",
            "-3e30f);\n    }\n    PROF90(5);\n  }\n}\n\n// ----")
    # the async design (thread 0 is in the compute group)
    s = sub(s, "  int slot = 0;\n", "  int slot = 0;\n  long long prof_t_ = clock64();\n")
    s = sub(s, "      operands(tile, ep, cf, tid, NT);\n    }\n    __syncthreads();\n",
            "      operands(tile, ep, cf, tid, NT);\n    }\n    __syncthreads();\n    PROF9(0);\n")
    s = sub(s, "    // the fused draw, in place of q1's mean, and x_new out\n",
            "    PROF9(1);\n    // the fused draw, in place of q1's mean, and x_new out\n")
    s = sub(s, "    // g on the drawn particles\n", "    PROF9(2);\n    // g on the drawn particles\n")
    s = sub(s, "    // α: kParts threads per particle, each over every kParts-th row\n    {",
            "    PROF9(3);\n    // α: kParts threads per particle, each over every kParts-th row\n    {")
    return sub(s, "-3e30f);\n    }\n  }\n}\n\ntemplate <int DX, int DY, int H>\ncudaError_t launch_trunk_async",
               "-3e30f);\n    }\n    PROF9(4);\n  }\n}\n\ntemplate <int DX, int DY, int H>\n"
               "cudaError_t launch_trunk_async")


def marked_resample(src: str) -> str:
    """Stage marks in K7's cluster design and K11's tiled design (CTA 0's
    thread 0: rank 0 of the first row's cluster)."""
    s = sub(src, '#include "resample.cuh"\n',
            '#include "resample.cuh"\n' + MARK.format(cta="", n=7) + MARK.format(cta="", n=11))
    s = sub(s, "  // 1. the slice in, its max; the row max over the cluster\n",
            "  long long prof_t_ = clock64();\n  // 1. the slice in, its max; the row max over the cluster\n")
    s = sub(s, "  if (tid == 0) *smax = m;\n", "  PROF7(0);\n  if (tid == 0) *smax = m;\n")
    s = sub(s, "  // 2. the slice's inclusive scan", "  PROF7(1);\n  // 2. the slice's inclusive scan")
    s = sub(s, "  __syncthreads();\n  for (int w = 0; w < warp; ++w) excl += dred[w];\n",
            "  PROF7(2);\n  __syncthreads();\n  for (int w = 0; w < warp; ++w) excl += dred[w];\n")
    s = sub(s, "  // 3. the offsets:", "  PROF7(3);\n  // 3. the offsets:")
    s = sub(s, "  // 4. this slice, offset,", "  PROF7(4);\n  // 4. this slice, offset,")
    s = sub(s, "  cluster.sync();  // every slice in every CTA; no DSMEM access after this\n",
            "  cluster.sync();  // every slice in every CTA; no DSMEM access after this\n  PROF7(5);\n")
    s = sub(s, "\n  }\n}\n\n// ---- K11, the tiled design ----",
            "\n  }\n  PROF7(6);\n}\n\n// ---- K11, the tiled design ----")
    s = sub(s, "  // the indices, the loads of every row, and the stage zeroed\n",
            "  long long prof_t_ = clock64();\n  // the indices, the loads of every row, and the stage zeroed\n")
    for anchor, i in (("  // the run flags, once for the R rows", 0),
                      ("  // each row: the thread's aggregate", 1),
                      ("  __syncthreads();\n\n  // each row's warp prefixes", 2),
                      ("  cluster.sync();  // the aggregates and the zeroed stages", 4),
                      ("  // each run's total, every row, into the stage", 6),
                      ("  cluster.sync();  // every total staged", 7)):
        s = sub(s, anchor, f"  PROF11({i});\n" + anchor)
    s = sub(s, "  __syncthreads();\n\n  // each row's warp prefixes",
            "  __syncthreads();\n  PROF11(3);\n\n  // each row's warp prefixes")
    s = sub(s, "  cluster.sync();  // the aggregates and the zeroed stages; every CTA has started\n",
            "  cluster.sync();  // the aggregates and the zeroed stages; every CTA has started\n"
            "  PROF11(5);\n")
    s = sub(s, "  cluster.sync();  // every total staged; no DSMEM access after this\n",
            "  cluster.sync();  // every total staged; no DSMEM access after this\n  PROF11(8);\n")
    return sub(s, "\n    }\n  }\n}\n\ninline bool aligned16",
               "\n    }\n  }\n  PROF11(9);\n}\n\ninline bool aligned16")


def compute_only_k5(src: str) -> str:
    i0 = src.index("    if (vec) {\n      mbar_wait(&s_bar[s % NS]")
    tail = "    } else {\n      cp_async_wait<0>();\n    }\n"
    i1 = src.index(tail, i0) + len(tail)
    s = (src[:i0] + "    if (s < NS - 1) {\n      if (vec) mbar_wait(&s_bar[s], 0);\n"
         "      else cp_async_wait<0>();\n    }\n" + src[i1:])
    return sub(s, "    if (s + NS - 1 < total) {  // into chunk s - 1's slot\n      stage(s + NS - 1);\n"
               "      if (!vec) cp_async_commit();\n    }\n", "")


def one_copy_a_span_k5(src: str) -> str:
    return sub(src, "    if (n == K) {\n      const unsigned row_bytes", "    if (false) {\n      const unsigned row_bytes")


# K12/K13's control build, which the marked copies leave out: its entry points answer
# cudaErrorInvalidValue, so that the library links without a second copy of the marks
CTRL_STUB = """#include <cuda_runtime.h>
namespace psvo {
namespace svo {
struct FwdArgs;
struct BwdArgs;
int forward_ctrl(const FwdArgs&, int, int, int, int, int, int, cudaStream_t) {
  return static_cast<int>(cudaErrorInvalidValue);
}
int backward_ctrl(const BwdArgs&, int, int, int, int, int, int, float*, cudaStream_t) {
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace svo
}  // namespace psvo
"""


def build_variant(name: str, files: dict, out_root: Path, nvcc: str, flags, arch) -> Path:
    """Compile `files` (name -> source text) with the csrc headers into a
    shared library; a name ending in ".cuh" replaces that header instead of
    being compiled. Returns the library's path."""
    from psvo_tpu_torch.ops import _build

    d = out_root / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    files = dict(files)
    for header in [n for n in files if n.endswith(".cuh")]:
        (d / header).write_text(files.pop(header))
    files = dict(files, err='#include <cuda_runtime.h>\nextern "C" const char* '
                            'psvo_error_string(int e) { return cudaGetErrorString('
                            '(cudaError_t)e); }\n')
    procs = []
    for stem, text in files.items():
        (d / f"{stem}.cu").write_text(text)
        procs.append(subprocess.Popen([nvcc, *flags, "-I", str(d), "-c", "-o", str(d / f"{stem}.o"),
                                       str(d / f"{stem}.cu")], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            sys.exit(f"stage_profile: nvcc failed for {name}:\n{out[-4000:]}")
    lib = d / "lib.so"
    subprocess.run([nvcc, *arch, "-shared", "-o", str(lib), *[str(d / f"{s}.o") for s in files]],
                   check=True)
    return lib


def load(path: Path, names):
    from psvo_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    for n in names:
        fn = getattr(lib, n)
        fn.argtypes = _build.SIGNATURES[n] if n in _build.SIGNATURES else [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.psvo_error_string.argtypes = [ctypes.c_int]
    lib.psvo_error_string.restype = ctypes.c_char_p
    return lib


def device_ms(fn, n: int = 20) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):  # a window now and then records no device events (chip_smoke.py)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:  # a kernel's mean event times its launches a call: windows drop some events
            total, count = {}, {}
            for e in ev:
                total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
                count[e.name] = count.get(e.name, 0) + 1
            return sum(total[k] / count[k] * max(1, round(count[k] / n)) for k in total) / 1e3
    sys.exit("stage_profile: torch.profiler recorded no device time in 8 windows")


def show(label: str, names, cyc) -> None:
    print(f"{label}: " + "; ".join(f"{n} {v} ({100 * v / max(sum(cyc), 1):.1f}%)"
                                   for n, v in zip(names, cyc)) + f"; total {sum(cyc)}", flush=True)


def k12_profiles(marks, prof, with_lib, so, consts) -> None:
    """K12's two designs on the SVO operands: alternated times, then one
    marked launch of each."""
    from psvo_tpu_torch.ops import svo

    pairs = [tuple(device_ms(lambda: svo.svo_sweep_forward(*so, consts, design=d))
                   for d in svo.K12_DESIGNS) for _ in range(3)]
    b, m = so[0].shape[:2]
    print(f"K12 B={b} M={m} T-1={so[1].shape[0]} hidden (64, 64), plan "
          f"{svo.k12_plan(3, 3, 64, 1, b * m, 132, so[1].shape[0])}: (split, chain) ms "
          + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in pairs), flush=True)
    for design, name, stages in (("split", "psvo_prof12", K12_SPLIT_STAGES),
                                 ("chain", "psvo_prof120", K12_CHAIN_STAGES)):
        prof(marks, name)
        with_lib(marks, lambda: svo.svo_sweep_forward(*so, consts, design=design))
        import torch
        torch.cuda.synchronize()
        show(f"K12 {design}, CTA 0 thread 0, cycles over the sweep", stages,
             prof(marks, name)[:len(stages)])


def k9_profiles(marks, prof, with_lib, dev, g) -> None:
    """K9's two designs at the Lorenz-96 preset's shape (B=8, K=8192, hidden
    (64, 64), random weights), both noise modes: alternated times, then one
    marked launch of each."""
    import torch
    from psvo_tpu_torch.config import PRESETS, NetConfig
    from psvo_tpu_torch.models.ssm import init_ssm
    from psvo_tpu_torch.ops import fused_step, trunk

    net = NetConfig(hidden=(64, 64))
    cfg = PRESETS["lorenz96_fivo_k8192_sharded"].with_nets(q0=net, q1=net, q2=net, f=net, g=net)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        x_res = torch.randn((8, 40, 8192), generator=g, device=dev) * 3.0
        coef = torch.rand((8, 161), generator=g, device=dev) + 0.1
        eps = torch.randn((8, 40, 8192), generator=g, device=dev)
        for mode, noise in (("RNG", {"seed": (5, 6), "t": 3}), ("stream", {"eps": eps})):
            pairs = [tuple(device_ms(lambda: trunk.trunk_forward(x_res, coef, consts, **noise,
                                                                  design=d))
                           for d in trunk.K9_DESIGNS) for _ in range(3)]
            print(f"K9 B=8 K=8192 hidden (64, 64) {mode}, (pair, prefetch) "
                  f"{trunk.k9_plan(40, 40, 64, 1)}: (async, tile) ms "
                  + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in pairs), flush=True)
            for design, name, stages in (("async", "psvo_prof9", K9_ASYNC_STAGES),
                                         ("tile", "psvo_prof90", K9_TILE_STAGES)):
                prof(marks, name)
                with_lib(marks, lambda: trunk.trunk_forward(x_res, coef, consts, **noise,
                                                            design=design))
                torch.cuda.synchronize()
                show(f"K9 {design} {mode}, CTA 0 thread 0, cycles over its tiles", stages,
                     prof(marks, name)[:len(stages)])


def ffbsi_operands(dev, g):
    """K5's operands at `lorenz63_psvo_k1024`'s shape (B=32, M=16, K=1024,
    T-1=99, Dx=3): support terms of a transition near the support, normalized
    log-weights, Gumbels, anchors."""
    import torch

    t1, b, m, k, dx = 99, 32, 16, 1024, 3
    xs = torch.randn((t1, b, dx, k), generator=g, device=dev) * 8.0
    mean = xs + torch.randn(xs.shape, generator=g, device=dev)
    scale = 0.5 + 1.5 * torch.rand(xs.shape, generator=g, device=dev)
    r = 1.0 / (scale * scale)
    c = -0.5 * (mean * mean * r).sum(2) - torch.log(scale).sum(2) - dx * 0.9189385332
    lwn = torch.log_softmax(torch.randn((t1, b, k), generator=g, device=dev) * 2.0, dim=-1)
    lg = torch.randn((t1, b, k), generator=g, device=dev)
    u = torch.rand((t1, b, m, k), generator=g, device=dev).clamp_min(1e-30)
    return [v.contiguous() for v in (xs[-1, :, :, :m].transpose(1, 2), xs, r, mean * r, c, lwn, lg,
                                     -torch.log(-torch.log(u)))]


def ffbsi_profiles(marks, prof, with_lib, dev, g) -> None:
    """K6's two designs on K5's selections at the PSVO preset's shape, the
    three cotangent patterns (all four outputs; the direct bound's d logq and
    d x~ with d_lg not wanted; the paths alone): alternated times, then one
    marked launch of the staged design on each branch."""
    import torch
    from psvo_tpu_torch.ops import ffbsi

    ops = ffbsi_operands(dev, g)
    with torch.no_grad():
        fwd = ffbsi.ffbsi_forward(*ops)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in fwd[:4]]
    args = (*ops[:7], fwd[4], fwd[3])
    modes = {"all cotangents": dict(d_x_first=cots[0], d_logp=cots[1], d_logq=cots[2],
                                    d_xtilde=cots[3], needs=(True,) * 5),
             "direct bound": dict(d_logq=cots[2], d_xtilde=cots[3],
                                  needs=(True, True, True, True, False)),
             "paths only": dict(d_x_first=cots[0], d_xtilde=cots[3], needs=(False,) * 5)}
    for mode, kw in modes.items():
        pairs = [tuple(device_ms(lambda: ffbsi.ffbsi_backward(*args, **kw, design=d))
                       for d in ffbsi.K6_DESIGNS) for _ in range(3)]
        print(f"K6 B=32 M=16 K=1024 T-1=99 Dx=3, {mode}: (staged, row) ms "
              + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in pairs), flush=True)
        name, stages = (("psvo_prof60", K6_PATHS_STAGES) if mode == "paths only"
                        else ("psvo_prof6", K6_STAGES))
        prof(marks, name)
        with_lib(marks, lambda: ffbsi.ffbsi_backward(*args, **kw))
        torch.cuda.synchronize()
        show(f"K6 staged, {mode}, CTA 0 thread 0, cycles", stages, prof(marks, name)[:len(stages)])


def resample_profiles(marks, prof, with_lib, dev, g) -> None:
    """K7's and K11's designs at the Lorenz-96 preset's shapes: alternated
    times, K11's tiled design at every (P, C) its kernel admits, then one
    marked launch of each new design."""
    import torch
    from psvo_tpu_torch.ops import _build, fused_step
    from psvo_tpu_torch.ops import resample_gather as rg

    k = 8192
    lw = torch.randn((8, k), generator=g, device=dev) * 3.0
    pos = fused_step.systematic_positions(torch.rand(8, generator=g, device=dev), k).contiguous()
    pairs = [tuple(device_ms(lambda: rg.ancestor_indices_large(lw, pos, design=d))
                   for d in rg.K7_DESIGNS) for _ in range(3)]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"K7 B=8 K={k}, C = {rg.k7_cluster(8, k, n_sms)}: (cluster, row) ms "
          + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in pairs), flush=True)
    prof(marks, "psvo_prof7")
    with_lib(marks, lambda: rg.ancestor_indices_large(lw, pos))
    torch.cuda.synchronize()
    show("K7 cluster, CTA 0 thread 0, cycles", K7_STAGES, prof(marks, "psvo_prof7")[:len(K7_STAGES)])
    one = torch.full((8, k), -50.0, device=dev)
    one[torch.arange(8, device=dev), torch.randint(0, k, (8,), generator=g, device=dev)] = 0.0
    x = torch.randn((8, 40, k), generator=g, device=dev)
    lib = _build.load_library()

    def tiled(ix, per, c):  # K11's tiled design at a given (P, C), through its C entry point
        out = torch.empty_like(x)
        err = lib.psvo_segment_sum_scatter(x.data_ptr(), ix.data_ptr(), out.data_ptr(), 8, 40, k,
                                           0, per, c, torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "segment_sum_scatter")
        return out

    plans = [(per, -(-k // (256 * per))) for per in rg.K11_PER if -(-k // (256 * per)) <= 8]
    for rows, logw in (("healthy", lw), ("one ancestor", one)):
        idx = rg.ancestor_indices_large(logw, pos)
        order = plans + plans[::-1]  # each (P, C) twice, in turns
        times = {}
        for pc in order:
            times.setdefault(pc, []).append(device_ms(lambda: tiled(idx, *pc)))
        print(f"K11 [8, 40, {k}] {rows}, tiled by (P, C), two turns: "
              + ", ".join(f"{pc} " + " / ".join(f"{v:.4f}" for v in ts) for pc, ts in times.items()),
              flush=True)
        pairs = [tuple(device_ms(lambda: rg.segment_sum_scatter(x, idx, design=d))
                       for d in rg.K11_DESIGNS) for _ in range(3)]
        print(f"K11 [8, 40, {k}] {rows}, (P, tiles) {rg.k11_plan(k)}: (tiled, row) ms "
              + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in pairs), flush=True)
        prof(marks, "psvo_prof11")
        with_lib(marks, lambda: rg.segment_sum_scatter(x, idx))
        torch.cuda.synchronize()
        show(f"K11 tiled {rows}, CTA 0 thread 0, cycles", K11_STAGES,
             prof(marks, "psvo_prof11")[:len(K11_STAGES)])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 1
    from psvo_tpu_torch.config import PRESETS, NetConfig
    from psvo_tpu_torch.models.ssm import init_ssm
    from psvo_tpu_torch.ops import _build, ffbsi, svo

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    real = _build.load_library()
    out_root = _build.BUILD_ROOT / "stage_profile"
    args = (out_root, _build.nvcc(), _build.NVCC_FLAGS, _build.ARCH_FLAGS)
    fr = marked_resample((_build.CSRC / "resample_gather.cu").read_text())
    rg_names = ("psvo_ancestor_indices_large", "psvo_segment_sum_scatter", "psvo_prof7",
                "psvo_prof11")

    def prof(lib, name):
        buf = (ctypes.c_longlong * 32)()
        getattr(lib, name)(ctypes.cast(buf, ctypes.c_void_p))
        return list(buf)

    def with_lib(lib, fn):
        _build.load_library = lambda: lib
        try:
            return fn()
        finally:
            _build.load_library = lambda: real

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    f5 = (_build.CSRC / "ffbsi.cu").read_text()
    k6_names = ("psvo_ffbsi_forward", "psvo_ffbsi_backward", "psvo_prof6", "psvo_prof60")
    if sys.argv[1:] in (["resample"], ["ffbsi"]):
        if sys.argv[1] == "resample":
            marks = load(build_variant("marks_resample", {"resample_gather": fr}, *args), rg_names)
            resample_profiles(marks, prof, with_lib, dev, g)
        else:
            marks = load(build_variant("marks_ffbsi", {"ffbsi": marked_k6(f5)}, *args), k6_names)
            ffbsi_profiles(marks, prof, with_lib, dev, g)
        print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
        return 0
    f13 = (_build.CSRC / "svo_sweep.cuh").read_text()
    f9 = (_build.CSRC / "trunk_forward.cuh").read_text()
    # K9's two translation units as one, so that the marked header's counters are defined once
    k9_tu = (_build.CSRC / "trunk_forward.cu").read_text().replace(
        "extern template int dispatch_trunk_forward<true>", "template int dispatch_trunk_forward<true>")
    k5_names = ("psvo_ffbsi_forward",)
    marks = load(build_variant("marks", {"ffbsi": marked_k6(marked_k5(f5)),
                                         "svo_sweep.cuh": marked_k13(marked_k12(f13)),
                                         "svo_sweep": (_build.CSRC / "svo_sweep.cu").read_text(),
                                         "svo_sweep_ctrl": CTRL_STUB,
                                         "trunk_forward.cuh": marked_k9(f9),
                                         "trunk_forward": k9_tu,
                                         "resample_gather": fr}, *args),
                 k5_names + ("psvo_ffbsi_backward", "psvo_prof6", "psvo_prof60",
                             "psvo_svo_forward", "psvo_svo_backward", "psvo_trunk_forward",
                             "psvo_prof5", "psvo_prof13", "psvo_prof12", "psvo_prof120",
                             "psvo_prof9", "psvo_prof90") + rg_names)
    variants = {name: load(build_variant(name, {"ffbsi": patch(f5)}, *args), k5_names)
                for name, patch in (("compute only", compute_only_k5),
                                    ("one copy a span", one_copy_a_span_k5))}
    t1, b, m, k, dx = 99, 32, 16, 1024, 3
    ops = ffbsi_operands(dev, g)
    p5 = ffbsi.k5_paths(b, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.no_grad():
        staged, path = ffbsi.ffbsi_forward(*ops), ffbsi.ffbsi_forward(*ops, design="path")
        equal = all(torch.equal(x, y) for x, y in zip(staged, path))
        pairs = [(device_ms(lambda: ffbsi.ffbsi_forward(*ops)),
                  device_ms(lambda: ffbsi.ffbsi_forward(*ops, design="path"))) for _ in range(3)]
        print(f"K5 B={b} M={m} K={k} T-1={t1} Dx={dx}, {p5} paths a CTA: staged equal to path in "
              f"every output {equal}; (staged, path) ms " + ", ".join(f"({x:.4f}, {y:.4f})"
                                                                       for x, y in pairs), flush=True)
        for name, lib in variants.items():
            print(f"K5 staged, {name}: " + ", ".join(
                f"{with_lib(lib, lambda: device_ms(lambda: ffbsi.ffbsi_forward(*ops))):.4f}"
                for _ in range(2)) + " ms", flush=True)
        prof(marks, "psvo_prof5")
        with_lib(marks, lambda: ffbsi.ffbsi_forward(*ops))
        torch.cuda.synchronize()
        cyc = prof(marks, "psvo_prof5")[:len(K5_STAGES)]
        print(f"K5 staged, CTA 0 thread 0, cycles over the sweep ({t1} steps): " + "; ".join(
            f"{n} {v} ({100 * v / sum(cyc):.1f}%)" for n, v in zip(K5_STAGES, cyc))
            + f"; total {sum(cyc)}", flush=True)

    net = NetConfig(hidden=(64, 64))
    cfg = PRESETS["lorenz63_svo_k256"].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                                 g=dataclasses.replace(net, sigma_init=0.5))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        for prm in ssm.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=g, device=dev))
        consts = svo.prepare(ssm)
        so = (torch.randn((b, m, 3), generator=g, device=dev) * 3.0,
              torch.randn((t1, b, m, 3), generator=g, device=dev),
              torch.randn((t1, b, 3), generator=g, device=dev) * 3.0)
        xt = svo.svo_sweep_forward(*so, consts)[3]
        cots = [torch.randn(s, generator=g, device=dev)
                for s in ((b, m, 3), (b, m), (b, m), tuple(xt.shape))]
        pairs = [(device_ms(lambda: svo.svo_sweep_backward(*so, consts, xt, *cots)),
                  device_ms(lambda: svo.svo_sweep_backward(*so, consts, xt, *cots, design="chain")))
                 for _ in range(3)]
        print(f"K13 B={b} M={m} T-1={t1} hidden (64, 64): (split, chain) ms "
              + ", ".join(f"({x:.4f}, {y:.4f})" for x, y in pairs), flush=True)
        prof(marks, "psvo_prof13")
        with_lib(marks, lambda: svo.svo_sweep_backward(*so, consts, xt, *cots))
        torch.cuda.synchronize()
        cyc = [v for v, n in zip(prof(marks, "psvo_prof13"), K13_STAGES) if n != "-"]
        names = [n for n in K13_STAGES if n != "-"]
        print("K13 split, CTA 0 thread 0, cycles over its tiles: " + "; ".join(
            f"{n} {v} ({100 * v / sum(cyc):.1f}%)" for n, v in zip(names, cyc))
            + f"; total {sum(cyc)}", flush=True)
        k12_profiles(marks, prof, with_lib, so, consts)
    k9_profiles(marks, prof, with_lib, dev, g)
    resample_profiles(marks, prof, with_lib, dev, g)
    ffbsi_profiles(marks, prof, with_lib, dev, g)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
