"""Large-K resampling kernels and their plain versions (counterpart of
`psvo_tpu/ops/pallas_resample.py::resample_and_gather` above its fused cap,
and of its VJP `_rg_bwd` at every K).

Three hand-written CUDA kernels (`csrc/resample_gather.cu`), each behind a
wrapper that launches it for CUDA tensors and runs its plain PyTorch version
for CPU tensors — never the plain version on the card:

- K7 `ancestor_indices_large` (replaces `pallas_resample._indices_large`):
  logw [B, K] and sorted positions [B, K] -> int32 ancestors, the count form
  of `fused_step.count_form_indices` on an fp64 CDF. Two designs: "cluster"
  (the default, the one the paths run: a row on a cluster of `k7_cluster`
  CTAs, each scanning a slice, pushing it to every CTA over DSMEM and
  searching its slice's positions against the whole CDF) and "row" (the
  previous design, one CTA a row, kept as its yardstick). Both hold K up to
  `MAX_K` = 19200. Plain version: `ancestor_indices_large_reference`.
- K8 `gather_particles` (replaces the gather half of
  `pallas_resample._win_pallas_call`, with the compact branch and the XLA
  fallback of `_win_gather`): x [B, D, K] -> x[b, d, idx[b, k]]. Plain
  version: `gather_particles_reference` (`resampling.gather_particles`).
- K11 `segment_sum_scatter` (replaces `_rg_bwd`'s fused `_scatter_kernel`,
  the scatter half of `_win_pallas_call` and `_sorted_segsum` with its
  `_rank_of_positions` and `_lane_cumsum`): the transpose of K8, g [B, D, K]
  summed into the ancestors of nondecreasing indices by a segmented scan.
  Two designs: "tiled" (the default, the one the paths run: a CTA per (b,
  tile of particles, group of state rows), the tiles of a row one cluster
  that hands a run crossing a tile edge over in tile order and stages each
  tile's sources in shared memory, `k11_plan`) and "row" (the previous
  design, one CTA per (b, d) row, kept as its yardstick). Plain version:
  `segment_sum_scatter_reference` (`scatter_add_`).

`GatherParticles` joins K8 and K11 as one `torch.autograd.Function`, and
`gather_particles` goes through it when autograd records: as in the
reference's custom VJP, the gradient reaches x only, never the indices, the
log-weights or the positions. `resample_and_gather` runs K7 and the gather.
Launch counts are `<wrapper>.launches` (K7's and K11's by design
`.launches_by_design`), plain-version call counts `.calls`. The reference's
index branch (an MXU cumsum in float32 and a two-level count) can land one
index away from the count form at a CDF boundary tie; K7 and K8 agree with
their plain versions exactly.
"""

from __future__ import annotations

import functools

import torch

from psvo_tpu_torch.ops import _build
from psvo_tpu_torch.ops.fused_step import CLUSTER_SIZES, SMEM_LIMIT, _require, count_form_indices
from psvo_tpu_torch.ops.resampling import gather_particles as _gather_plain

_THREADS = 256
_WARPS = _THREADS // 32
K7_DESIGNS = ("cluster", "row")  # K7's designs: the one the paths run, the previous one
K11_DESIGNS = ("tiled", "row")  # K11's designs: the one the paths run, the previous one
K11_PER = (4, 8, 16)  # particles a thread of K11's tiled design


def k7_smem_bytes(k: int) -> int:
    """Dynamic shared memory of K7's row design: the fp64 CDF and the fp32
    log-weights, plus one reduction slot per warp for each."""
    return 12 * (k + _WARPS)


def k7_cluster_smem_bytes(k: int, cluster: int) -> int:
    """Dynamic shared memory of one CTA of K7's cluster design
    (csrc/resample_gather.cu::k7_cluster_smem): the row's fp64 CDF, a slot
    per warp and the slice total (two slots: the log-weights after them are
    read 16 bytes at a time); the slice's fp32 log-weights, a slot per warp
    and the slice max."""
    return 8 * (k + _WARPS + 2) + 4 * (k // cluster + _WARPS + 1)


MAX_K = 19200  # the largest K with K % 256 == 0 and k7_smem_bytes(K) <= SMEM_LIMIT


def k_ok(k: int) -> bool:
    """K7's class, either design: K <= threads, or whole chunks of K / threads
    per thread, and the row in shared memory."""
    return k >= 1 and (k <= _THREADS or k % _THREADS == 0) and k7_smem_bytes(k) <= SMEM_LIMIT


def k7_cluster(batch: int, k: int, n_sms: int) -> int:
    """C, the CTAs a row of K7's cluster design: the largest C in
    `CLUSTER_SIZES` whose slices K/C are whole chunks of 256 particles and
    whose B clusters of C CTAs fit the card's n_sms SMs in one wave; 1 at
    K <= 256 (a cluster of one, the same code)."""
    return max(c for c in CLUSTER_SIZES
               if c == 1 or (k % (c * _THREADS) == 0 and batch * c <= n_sms))


def k11_plan(k: int) -> tuple[int, int]:
    """(P, C) of K11's tiled design: P particles a thread (a tile of 256·P,
    32/P state rows a CTA), the fewest that cover K in at most 4 tiles, else
    in at most 8, and C = ceil(K / (256·P)) tiles a row, one cluster. Four
    tiles keep the carry chain and the cluster short (`tools/stage_profile.py
    resample` times every (P, C) at K = 8192): P = 8, C = 4 there (8 × 4 ×
    10 = 320 CTAs at B = 8, D = 40); P = 16, C = 5 at K = MAX_K."""
    for most in (4, CLUSTER_SIZES[-1]):
        for per in K11_PER:
            tiles = -(-k // (_THREADS * per))
            if tiles <= most:
                return per, tiles
    raise ValueError(f"segment_sum_scatter: no tiled plan for K={k}")


def k11_smem_bytes(per: int) -> int:
    """Dynamic shared memory of one CTA of K11's tiled design
    (csrc/resample_gather.cu::k11_tiled_smem): the stage of its sources
    [32/P rows][256·P]; per row the warps' aggregates, their prefixes with
    the tile's aggregate, and the carry; the warps' flags and the tile's."""
    rows = 32 // per
    return 4 * (rows * _THREADS * per + rows * (2 * _WARPS + 2)) + 4 * (_WARPS + 1)


@functools.cache
def _n_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ancestor_indices_large_reference(logw, positions):
    """Plain version of K7: the count form on an fp64 CDF."""
    ancestor_indices_large_reference.calls += 1
    return count_form_indices(logw, positions)


ancestor_indices_large_reference.calls = 0


def ancestor_indices_large(logw, positions, design: str = "cluster"):
    """K7: logw [B, K] f32, sorted positions [B, K] f32 in [0, 1) -> int32
    ancestors [B, K], nondecreasing along K. CUDA tensors launch the kernel
    of `design` ("cluster", the default and the only one the paths run;
    "row", the previous design, kept as its yardstick)."""
    if design not in K7_DESIGNS:
        raise ValueError(f"ancestor_indices_large: no design {design!r} (one of {K7_DESIGNS})")
    if logw.device.type == "cpu":
        return ancestor_indices_large_reference(logw, positions)
    if logw.device.type != "cuda":
        raise ValueError(f"ancestor_indices_large: unsupported device {logw.device}")
    batch, k = logw.shape
    _require(logw, (batch, k), "logw", logw.device)
    _require(positions, (batch, k), "positions", logw.device)
    if not k_ok(k):
        raise ValueError(f"ancestor_indices_large: no kernel for K={k} (K <= {_THREADS} or a "
                         f"multiple of it, at most {MAX_K})")
    cluster = k7_cluster(batch, k, _n_sms(logw.device.index)) if design == "cluster" else 1
    lib = _build.load_library()
    idx = torch.empty((batch, k), dtype=torch.int32, device=logw.device)
    stream = torch.cuda.current_stream(logw.device).cuda_stream
    err = lib.psvo_ancestor_indices_large(logw.data_ptr(), positions.data_ptr(), idx.data_ptr(),
                                          batch, k, K7_DESIGNS.index(design), cluster, stream)
    ancestor_indices_large.launches += 1
    ancestor_indices_large.launches_by_design[design] += 1
    _build.check(lib, err, "ancestor_indices_large")
    return idx


ancestor_indices_large.launches = 0
ancestor_indices_large.launches_by_design = dict.fromkeys(K7_DESIGNS, 0)


def gather_particles_reference(x, idx):
    """Plain version of K8."""
    gather_particles_reference.calls += 1
    return _gather_plain(x, idx)


gather_particles_reference.calls = 0


def gather_particles(x, idx):
    """K8: x [B, D, K] f32, idx int32 [B, K] in [0, K) -> [B, D, K], through
    `GatherParticles` (K11 its backward) when autograd records."""
    if torch.is_grad_enabled() and x.requires_grad:
        return GatherParticles.apply(x, idx)
    if x.device.type == "cpu":
        return gather_particles_reference(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_particles: unsupported device {x.device}")
    batch, d, k = x.shape
    _require(x, (batch, d, k), "x", x.device)
    _require(idx, (batch, k), "idx", x.device, torch.int32)
    lib = _build.load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.psvo_gather_particles(x.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, d, k,
                                    stream)
    gather_particles.launches += 1
    _build.check(lib, err, "gather_particles")
    return out


gather_particles.launches = 0


def segment_sum_scatter_reference(g, idx):
    """Plain version of K11: d_x[b, d, s] = Σ_{q : idx[b,q] = s} g[b, d, q]."""
    segment_sum_scatter_reference.calls += 1
    index = idx.long()[:, None, :].expand(-1, g.shape[1], -1)
    return torch.zeros_like(g).scatter_add_(-1, index, g)


segment_sum_scatter_reference.calls = 0


def segment_sum_scatter(g, idx, design: str = "tiled"):
    """K11: g [B, D, K] f32, idx int32 [B, K] nondecreasing along K, in
    [0, K) (as K7 draws them) -> d_x [B, D, K], the VJP of K8 with respect to
    x. Every source's children are summed in a fixed order: the same bits on
    every launch. CUDA tensors launch the kernel of `design` ("tiled", the
    default and the only one the paths run; "row", the previous design, kept
    as its yardstick)."""
    if design not in K11_DESIGNS:
        raise ValueError(f"segment_sum_scatter: no design {design!r} (one of {K11_DESIGNS})")
    if g.device.type == "cpu":
        return segment_sum_scatter_reference(g, idx)
    if g.device.type != "cuda":
        raise ValueError(f"segment_sum_scatter: unsupported device {g.device}")
    batch, d, k = g.shape
    _require(g, (batch, d, k), "g", g.device)
    _require(idx, (batch, k), "idx", g.device, torch.int32)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"segment_sum_scatter: no kernel for K={k} (at most {MAX_K})")
    per, cluster = k11_plan(k) if design == "tiled" else (0, 0)
    lib = _build.load_library()
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.psvo_segment_sum_scatter(g.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, d, k,
                                       K11_DESIGNS.index(design), per, cluster, stream)
    segment_sum_scatter.launches += 1
    segment_sum_scatter.launches_by_design[design] += 1
    _build.check(lib, err, "segment_sum_scatter")
    return out


segment_sum_scatter.launches = 0
segment_sum_scatter.launches_by_design = dict.fromkeys(K11_DESIGNS, 0)


class GatherParticles(torch.autograd.Function):
    """K8 with K11 as its VJP (the counterpart of `pallas_resample.
    resample_and_gather`'s custom VJP): apply(x, idx) -> x[b, d, idx[b, k]];
    the backward sums each offspring's cotangent into its ancestor. idx gets
    no gradient: stop-gradient through the ancestor choice."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        return gather_particles(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum_scatter(g.contiguous(), idx), None


def resample_and_gather(u, logw, x):
    """Ancestors and resampled particles of one step: u [B, K] sorted
    positions, logw [B, K], x [B, D, K] -> (idx int32 [B, K], x_res [B, D, K]),
    through K7 and K8 (their plain versions for CPU tensors); when autograd
    records, x_res carries x's gradient through `GatherParticles`."""
    idx = ancestor_indices_large(logw.contiguous(), u.contiguous())
    return idx, gather_particles(x.contiguous(), idx)
