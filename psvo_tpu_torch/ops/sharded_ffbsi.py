"""FFBSi across the particle axis of a mesh (counterpart of
`psvo_tpu/ops/sharded_ffbsi.py`).

The anchors and every reverse step keep the K-wide work on the rank that
holds its particles; per (row, path) only scalars and the selected particle
cross the particle row, never a K-wide tensor:

1. the categorical draw is a global Gumbel-argmax (`global_first_argmax`):
   each rank takes the max of its slice of logits + Gumbel, a pmax finds the
   global max, and a pmin over shard·K_loc + local argmax among the ranks
   that attain it picks the lowest global index: `torch.argmax`'s
   first-maximum rule, bit for bit, on the same values;
2. the selected particle and densities are psums of owner-masked local
   gathers (`psum_select`), [b, M, Dx] and [b, M];
3. the backward-weight normalizer is a max-shifted psum logsumexp
   (`collectives.logsumexp`).

Gradients: the index path is discrete, the selected values carry their
gradients through the psum (whose backward lands on the owner), and the
normalizer's shift is detached. Without a particle mesh each step is the
local one (`torch.argmax`'s pick, the gathers, `torch.logsumexp`), bit for
bit: the same functions are FFBSi's eager route and its anchors on one
device (`objectives._plain_ffbsi_sweep`, `_sample_final_particles`). Under
a particle mesh the sweep is the eager route: K5/K6 hold whole rows of K.
"""

from __future__ import annotations

import torch

from psvo_tpu_torch.parallel import collectives, context

_BIG = 2**31 - 1


def global_first_argmax(z):
    """argmax over the particle-sharded last axis with the first maximum's
    tie rule. z [..., K_loc] this rank's slice. Returns (gidx [...] the
    global index, aloc [...] the local index on this rank, own [...] bool,
    true on exactly one rank of the row); without a particle mesh
    (torch.argmax, the same, all true)."""
    mesh = context.particle_mesh()
    z = z.detach()
    aloc = torch.argmax(z, dim=-1)
    if mesh is None:
        return aloc, aloc, torch.ones_like(aloc, dtype=torch.bool)
    vloc = torch.amax(z, dim=-1)
    gmax = collectives.pmax(vloc)
    # exact equality: the owner's local max is the pmax's value
    cand = torch.where(vloc == gmax, aloc + mesh.particle_index * z.shape[-1],
                       torch.full_like(aloc, _BIG))
    gidx = collectives.pmin(cand)
    return gidx, aloc, cand == gidx


def psum_select(val, own):
    """The owner rank's value on every rank: the psum of the owner-masked
    local value. Differentiable: the cotangent lands on the owner. The value
    itself without a particle mesh."""
    if context.particle_mesh() is None:
        return val
    return collectives.psum(val * own.to(val.dtype))


def _select_particles(x, aloc, own):
    """x [b, Dx, K_loc] at the local indices aloc [b, M], the owner's on
    every rank: [b, M, Dx]."""
    sel = torch.gather(x, 2, aloc[:, None, :].expand(-1, x.shape[1], -1)).transpose(1, 2)
    return psum_select(sel, own[..., None])


def sharded_anchor(logw_norm, x_last, gum):
    """The M anchors from the last filtering distribution: logw_norm [b, K_loc]
    (globally normalized), x_last [b, Dx, K_loc], gum [b, M, K_loc] this
    rank's slice of the Gumbels. Returns (x_anchor [b, M, Dx], the anchors'
    normalized log-weights [b, M]), replicated over the particle row."""
    _, aloc, own = global_first_argmax(logw_norm[:, None, :] + gum)
    lwn_sel = psum_select(torch.gather(logw_norm, 1, aloc), own)
    return _select_particles(x_last, aloc, own), lwn_sel


def sharded_ffbsi_sweep(query_fn, xs, sup: dict, lwn, gum, x_query):
    """The reverse sweep over t = n−1 … 0 on this rank's particles (the
    reference's scan body, `objectives._make_ffbsi_body`, on one device).

    query_fn(sup_t, x) -> [b, M, K_loc], the pairwise density of the queries
    x [b, M, Dx] against one step's support terms; xs [n, b, Dx, K_loc], sup
    the support terms ([n, b, ..., K_loc] leaves; "chol" [Dx, Dx] shared),
    lwn [n, b, K_loc] the globally normalized log-weights, gum [n, b, M,
    K_loc] and x_query [b, M, Dx] (replicated over the row). Returns what
    `ffbsi.FFBSiSweep` returns: (x_first, logp (zeros: the log-joint is
    recomputed on the selected paths), logq, xtilde [n, b, M, Dx])."""
    x = x_query
    logq = torch.zeros(x_query.shape[:2], dtype=x_query.dtype, device=x_query.device)
    paths = [None] * xs.shape[0]
    for t in reversed(range(xs.shape[0])):
        sup_t = {n: (v if n == "chol" else v[t]) for n, v in sup.items()}
        pair = query_fn(sup_t, x)
        logits = pair + lwn[t][:, None, :]
        _, aloc, own = global_first_argmax(logits + gum[t])
        pair_sel = psum_select(torch.gather(pair, 2, aloc[..., None])[..., 0], own)
        lwn_sel = psum_select(torch.gather(lwn[t], 1, aloc), own)
        logq = logq + pair_sel + lwn_sel - collectives.logsumexp(logits)
        x = paths[t] = _select_particles(xs[t], aloc, own)
    return x, torch.zeros_like(logq), logq, torch.stack(paths)
