"""Resampling across the particle axis of a mesh (counterpart of
`psvo_tpu/ops/sharded_resampling.py`).

When K is split over the P ranks of a particle row, the inverse CDF needs a
global view of the weights. As in the reference, only [b, P] row scalars
are replicated, never a K-wide tensor:

1. each rank's weight sum under the row's global max (`pmax`), all-gathered
   (`collectives.all_gather_rows`): every rank gets the global total and the
   mass before each shard; the ESS is a psum;
2. each rank owns its K / P output slots; a slot's global position locates
   its source shard among the P offsets;
3. a ring of P − 1 shifts (`collectives.ring_shift`) rotates (log-weights,
   particles) around the row, and at each step a shard-local inverse CDF and
   gather (`_local_lookup`) picks the slots whose source is the shard held.

`_local_lookup` runs `resample_gather.resample_and_gather`: K7 (the
indices) and K8 (the gather; K11 its VJP through `GatherParticles`) for
CUDA tensors, their plain versions for CPU tensors, as
`resampling.maybe_resample(use_kernel=True)` does. The reference's kernel
call there (`sharded_resampling.py:84-92`) feeds positions rel / s_r that
fall outside [0, 1) for the slots other shards own, masked afterwards.
K7's contract is sorted positions in [0, 1), so they are clamped to
[0, 1 − 2⁻²⁴] first: a monotone map, so the positions stay sorted, the
indices nondecreasing (K11's precondition, the masked slots included), and
an in-range position keeps its index.

The global mass bookkeeping (the totals, the offsets, the slots' positions
and their shard-relative fractions) is kept in float64, as K7 keeps its
CDF; the reference keeps it in float32. Equivalence with the single-rank
inverse CDF is then exact up to CDF-boundary ties: each shard's CDF is its
own, under its own max.

Gradients follow `resampling.maybe_resample`: the particles reach their
ancestors through the gathers and the ring's backward; the indices carry no
gradient. With `lwn` (the normalized log-weights, for the full FIVO
gradient's score term) each slot also picks its ancestor's log-weight,
which travels the ring with its particle; that pick is differentiable.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.ops import resample_gather
from psvo_tpu_torch.parallel import collectives, context

# The largest float32 below 1: the top of K7's position range.
ONE_BELOW = 1.0 - 2.0 ** -24


def sharded_maybe_resample(u, logw, x, *, ess_threshold: float = 1.0, lwn=None):
    """ESS-adaptive resampling step under the active particle mesh.

    u [b, Ks] this rank's slots' sorted global positions, logw [b, Ks], x
    [b, D, Ks] channel-major, lwn [b, Ks] or None. Returns (x_out, logw_out,
    did [b], ess [b], idx [b, Ks] global ancestors, picked [b, Ks] the
    ancestors' lwn or None); resampled rows restart at log-weight 0.
    """
    mesh = context.particle_mesh()
    n_shards, p_idx = mesh.particle, mesh.particle_index
    b, ks = logw.shape
    with torch.no_grad():
        m = collectives.pmax(torch.amax(logw, dim=-1, keepdim=True))
        w = torch.exp(logw - m)
        totals = collectives.all_gather_rows(torch.sum(w.double(), dim=-1))  # [b, P]
        total = torch.sum(totals, dim=-1, keepdim=True)
        offsets = torch.cumsum(totals, dim=-1) - totals  # mass before each shard
        sumsq = collectives.psum(torch.sum(w * w, dim=-1))
        ess = ((total[:, 0] ** 2) / torch.clamp(sumsq.double(), min=1e-37)).float()
        big_u = u.double() * total  # [b, Ks] global mass positions
        src = torch.sum(big_u[:, :, None] >= offsets[:, None, :], dim=-1) - 1  # [b, Ks]
    if ess_threshold >= 1.0:
        do = torch.ones((b,), dtype=torch.bool, device=logw.device)
    else:
        do = ess / (ks * n_shards) < ess_threshold

    out = torch.zeros_like(x)
    idx = torch.zeros((b, ks), dtype=torch.int32, device=logw.device)
    picked = None if lwn is None else torch.zeros_like(lwn)
    held = (logw.detach(), x) if lwn is None else (logw.detach(), x, lwn)
    for r in range(n_shards):
        src_shard = (p_idx - r) % n_shards  # whose particles this rank holds now
        rel = big_u - offsets[:, src_shard:src_shard + 1]
        a, got = _local_lookup(rel, held[0], held[1], totals[:, src_shard:src_shard + 1])
        mask = src == src_shard
        out = torch.where(mask[:, None, :], got, out)
        idx = torch.where(mask, a + src_shard * ks, idx)
        if picked is not None:
            picked = torch.where(mask, torch.gather(held[2], 1, a.long()), picked)
        if r < n_shards - 1:
            held = collectives.ring_shift(*held)

    x_out = torch.where(do[:, None, None], out, x)
    logw_out = torch.where(do[:, None], torch.zeros_like(logw), logw)
    return x_out, logw_out, do, ess, idx, picked


def _local_lookup(rel, logw_r, x_r, s_r):
    """The inverse CDF and gather against the shard held: rel [b, Ks] mass
    positions relative to its offset (float64, sorted), logw_r [b, Ks] and
    x_r [b, D, Ks] its log-weights and particles, s_r [b, 1] its weight sum
    (in the row's max units). K7 scales positions by the shard's own total,
    which differs from s_r only by exp(m − m_r): the fraction rel / s_r is
    the position it takes. Returns (local indices int32 [b, Ks], the
    gathered particles [b, D, Ks])."""
    frac = torch.clamp(rel / torch.clamp(s_r, min=1e-37), 0.0, ONE_BELOW).float()
    return resample_gather.resample_and_gather(frac, logw_r, x_r)
