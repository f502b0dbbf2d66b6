"""Variational SMC objectives (counterpart of `psvo_tpu/objectives.py`).

Ported: the IWAE/FIVO branch of `make_objective` — IWAE log Ẑ =
lse_k(Σ_t α_t) − log K without resampling, FIVO with per-step resampling —
and PSVO: FFBSi backward simulation of M smoothed trajectories over the
cached forward particles, the model's log-joint along them, and the two
bounds (`smc.psvo_bound`). The reported ELBO of PSVO is the forward log Ẑ (the
Rao-Blackwellized bound collapses to it); "forward" trains on it plus a
zero-valued EM surrogate whose gradient is the log-joint's on the smoothed
paths, "direct" on the sampled-trajectory bound
lse_m(log p(x̃^m, y) − log q̃(x̃^m)) − log M with q̃ the discrete backward path
pmf. The module docstring of the reference derives both.

SVO draws M trajectories backwards from anchors at the last filtering step
with the learned proposal q_b and trains on
lse_m(log p(x̃^m, y) − log q(x̃^m)) − log M, q's last term being the
filter-density surrogate ρ_T (the reference's module docstring). With
smc.qb_rnn, q_b also reads h_t, a GRU's summary of y_{t:T}
(`SSM.backward_rnn_summaries`), computed once a call outside the path loop.

Controls [B, T, Di] (data.di > 0) reach every objective through the filter
(`smc.forward_filter`). PSVO's support terms and selected-path log-joint take
u_{t+1}, the control into the step after the support's (the reference's
`ctrl_tm[1:]`); SVO's predictive mixture takes u_T and its sweep runs f on
[x̃_t; u_{t+1}] (`ops.svo.run_svo_sweep`, K12/K13's control mode).

The model modes (known dynamics, "head"/"tril"/"tril_head" scales, Poisson
and Dirac emissions, bootstrap mode) reach every objective, on CPU and CUDA
tensors: the forward runs whatever path `smc.forward_filter` takes (on the
card, the general path where the reference runs its plain scan).

Each sweep is dispatched by `smc.smoothing_route`: the port's kernel class
first (FFBSi: `ops.ffbsi.FFBSiSweep`, K5/K6; SVO: `ops.svo.SVOSweep`,
K12/K13; their plain versions on CPU tensors), else the reference's plain
sweep as tensor ops (`_plain_ffbsi_sweep`, `_svo_scan`), on CPU tensors
always and on CUDA tensors wherever the reference's own gate
(`smc.reference_ffbsi_path`, `smc.reference_svo_path`) runs its plain code:
a full-covariance f, K > 2048 or not a multiple of 128, M not a multiple of
8; the qb GRU, known dynamics, Poisson/Dirac, tril scales, uneven hidden
widths, max(Dx + Di, Dy) > 7, M < 32. Where the reference runs a sweep
kernel that the port's class does not cover (SVO widths above 64, FFBSi at
Dx above 908; ROADMAP queue 2 B), a CUDA call raises NotImplementedError
before the forward filter runs.

Long T (`smc.ffbsi_segments` = S > 1, PSVO): the forward keeps only the
carries at S segment boundaries (`smc.forward_filter_segmented`); the
backward sweep walks the segments in reverse, each one replayed
(`smc.recompute_segment`), given its own Gumbels and swept by one
`FFBSiSweep`, under one checkpoint, so no O(T·B·K) tensor persists; t = 0
is a one-step sweep of its own. The selected-path log-joint runs in
512-step chunks, each under a checkpoint, whenever T − 1 is a multiple of
512 with at least two chunks, segmented or not.

Under a particle mesh (`parallel.context.particle_mesh`, the reference's
`_particle_mesh`) the anchors and every FFBSi sweep, segmented or not,
t = 0's included, run on each rank's K / P particles
(`ops.sharded_ffbsi`), and SVO's predictive mixture normalizes across the
row (`parallel.collectives`); the paths and everything computed on them are
replicated over the row. Every rank draws the global Gumbels and noise and
keeps its rows and, for the Gumbels, its particles.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.distributions import (
    _HALF_LOG_2PI, _MIN_LOGP, log_normalize, mvn_diag_log_prob,
)
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import ffbsi, sharded_ffbsi, svo
from psvo_tpu_torch.parallel import collectives, context
from psvo_tpu_torch.smc import (
    FilterResult, SegmentedCache, _checkpointed, _controls_tm, _segment_seeds, forward_filter,
    forward_filter_segmented, recompute_segment, reference_ffbsi_path, reference_svo_path,
    smoothing_route,
)

# Time steps per chunk of the support terms when they take no gradient: the
# transition trunk's activations of a chunk, not of all T − 1 steps, are live
# (at B=32, K=1024, hidden 64: 67 MB per activation tensor).
_SUPPORT_CHUNK = 8


@dataclass
class ObjectiveOutput:
    loss: torch.Tensor  # scalar, to minimize
    elbo: torch.Tensor  # [B] per-trajectory bound
    metrics: dict  # scalars for logging
    smoothed: Optional[torch.Tensor] = None  # [T, B, M, Dx] backward trajectories
    filter_result: Optional[FilterResult] = None


def _pairwise_support_terms(ssm: SSM, x_support, u=None):
    """Support-side terms of the pairwise transition density f(q | x_j) on
    x_support [..., Dx, K] with controls u [..., Di] (None: zeros; the
    reference's `_pairwise_support_terms`), a dict that `_pairwise_query_logp`
    contracts with the queries:

    - diagonal f: r = 1/s², mr = m·r [..., Dx, K] and
      c = −½Σ_d m²r − Σ_d log s − Dx·½log 2π [..., K] (`ops.ffbsi.pair_logp`);
    - a constant Cholesky factor L ("tril"): the whitened mean L⁻¹m as mr,
      r = 1, c likewise, and L itself, which whitens the queries;
    - a per-state factor ("tril_head"): the precision P = L⁻ᵀL⁻¹ row-major
      as pflat [..., Dx², K], w = P·m [..., Dx, K] and c = −½ mᵀPm −
      Σ log diag − Dx·½log 2π, with L⁻¹ unrolled over the small Dx."""
    d = x_support.shape[-2]
    if ssm.f_tril_head:
        mean, diag, off = ssm.transition_tril_cm(x_support, u)

        def chol(i, j):  # packed lower-triangular entry, i >= j
            return diag[..., i, :] if i == j else off[..., i * (i - 1) // 2 + j, :]

        linv = [[None] * d for _ in range(d)]
        for i in range(d):
            linv[i][i] = 1.0 / diag[..., i, :]
            for j in range(i - 1, -1, -1):
                acc = sum(chol(i, kk) * linv[kk][j] for kk in range(j, i))
                linv[i][j] = -acc * linv[i][i]
        m_w = [sum(linv[i][j] * mean[..., j, :] for j in range(i + 1)) for i in range(d)]
        t3 = sum(v * v for v in m_w)
        w = torch.stack([sum(linv[i][j] * m_w[i] for i in range(j, d)) for j in range(d)],
                        dim=-2)
        pflat = torch.stack([sum(linv[i][a] * linv[i][b] for i in range(max(a, b), d))
                             for a in range(d) for b in range(d)], dim=-2)
        logdet = torch.sum(torch.log(diag), dim=-2)
        return {"pflat": pflat, "w": w, "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI}
    if ssm.f_tril:
        mean, chol_f = ssm.transition_full_cm(x_support, u)
        mean = torch.linalg.solve_triangular(chol_f.expand(*mean.shape[:-2], d, d), mean,
                                             upper=False)
        logdet = torch.sum(torch.log(torch.diagonal(chol_f)))
        t3 = torch.sum(mean * mean, dim=-2)
        return {"r": torch.ones_like(mean), "mr": mean,
                "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI, "chol": chol_f}
    mean, scale = ssm.transition_params_cm(x_support, u)
    r = 1.0 / (scale * scale)
    logdet = torch.sum(torch.log(scale), dim=-2)
    t3 = torch.sum(mean * mean * r, dim=-2)
    return {"r": r, "mr": mean * r, "c": -0.5 * t3 - logdet - d * _HALF_LOG_2PI}


def _pairwise_query_logp(ssm: SSM, sup: dict, x_query):
    """The pairwise log f(q_m | x_j), floored: one step's support terms
    (`_pairwise_support_terms` of [B, Dx, K]) against the queries x_query
    [B, M, Dx] -> [B, M, K]."""
    if ssm.f_tril_head:
        qq = (x_query[..., :, None] * x_query[..., None, :]).flatten(-2)
        t1 = torch.einsum("bmp,bpk->bmk", qq, sup["pflat"])
        t2 = torch.einsum("bmd,bdk->bmk", x_query, sup["w"])
        logp = -0.5 * t1 + t2 + sup["c"][:, None, :]
    else:
        if ssm.f_tril:
            d = x_query.shape[-1]
            chol = sup["chol"].expand(*x_query.shape[:-2], d, d)
            x_query = torch.linalg.solve_triangular(chol, x_query.transpose(-1, -2),
                                                    upper=False).transpose(-1, -2)
        logp = ffbsi.pair_logp(x_query, sup["r"], sup["mr"], sup["c"])
    return torch.clamp(logp, min=_MIN_LOGP)


def _support_terms(ssm: SSM, x_support, differentiable: bool, u=None):
    """(r, mr, c) of every support step [T−1, B, ·, K] of a diagonal f with
    its controls u [T−1, B, Di] (or None), contiguous, for K5/K6. Without a
    gradient they are computed in chunks of time steps, into their
    outputs."""
    names = ("r", "mr", "c")
    if differentiable:
        sup = _pairwise_support_terms(ssm, x_support, u)
        return tuple(sup[n].contiguous() for n in names)
    r, mr = torch.empty_like(x_support), torch.empty_like(x_support)
    t_len, batch, _, k = x_support.shape
    c = x_support.new_empty((t_len, batch, k))
    with torch.no_grad():
        for i in range(0, x_support.shape[0], _SUPPORT_CHUNK):
            sup = _pairwise_support_terms(ssm, x_support[i:i + _SUPPORT_CHUNK],
                                          None if u is None else u[i:i + _SUPPORT_CHUNK])
            for out, n in zip((r, mr, c), names):
                out[i:i + _SUPPORT_CHUNK] = sup[n]
    return r, mr, c


def _plain_ffbsi_sweep(ssm: SSM, x_query, xs, logws, gum, differentiable: bool, u=None):
    """The reference's FFBSi scan body (`objectives._make_ffbsi_body`) as a
    loop over t = n−1 … 0, the sweep's "eager" route (`_ffbsi_route`): any f
    (a full covariance too), on the tensors' device, and on each rank's
    particles under a particle mesh (`ops.sharded_ffbsi.sharded_ffbsi_sweep`).
    The support terms are computed for all steps at once, as the reference
    hoists them; per step one [B, M, K] pairwise density of the queries
    against the support, the Gumbel-argmax draw and the path pmf. Returns
    what `ffbsi.FFBSiSweep` returns (x_first, logp (zeros: the log-joint is
    recomputed on the selected paths), logq, xtilde)."""
    with torch.set_grad_enabled(differentiable and torch.is_grad_enabled()):
        sup = _pairwise_support_terms(ssm, xs, u)
        lwn, _ = collectives.log_normalize(logws)
    return sharded_ffbsi.sharded_ffbsi_sweep(functools.partial(_pairwise_query_logp, ssm), xs,
                                             sup, lwn, gum, x_query)


def _sample_final_particles(gum, fwd: FilterResult):
    """M trajectory anchors from the final filtering distribution by
    Gumbel-argmax over gum [B, M, K] (`ops.sharded_ffbsi.sharded_anchor`:
    across the particle row under a particle mesh). Returns (x̃_{T−1}
    [B, M, Dx], the anchors' normalized log-weights [B, M])."""
    return sharded_ffbsi.sharded_anchor(collectives.log_normalize(fwd.logw_last)[0],
                                        fwd.x_last, gum)


def _path_controls(ctrl, m: int):
    """Controls [L, B, Di] broadcast over the M paths, [L, B, M, Di]; None
    stays None."""
    if ctrl is None:
        return None
    return ctrl[:, :, None, :].expand(-1, -1, m, -1)


def _selected_path_log_joint(ssm: SSM, x_tilde, ys_tm, ctrl_tm=None):
    """log p_θ(x̃, y) [B, M] on the selected trajectories x_tilde [T, B, M, Dx]
    (the direct form; equal in value and gradient to gathering full-support
    densities, since the selected particle is the support atom); with
    controls ctrl_tm [T, B, Di] the step into x̃_t sees u_t. Chunked
    (`_logjoint_chunked`) when T − 1 is a multiple of _LOGJOINT_CHUNK with at
    least two chunks."""
    t_steps = x_tilde.shape[0]
    if t_steps - 1 >= 2 * _LOGJOINT_CHUNK and (t_steps - 1) % _LOGJOINT_CHUNK == 0:
        return _logjoint_chunked(ssm, x_tilde, ys_tm, ctrl_tm)
    u = None if ctrl_tm is None else _path_controls(ctrl_tm[1:], x_tilde.shape[2])
    lp_f = ssm.transition_log_prob(x_tilde[:-1], x_tilde[1:], u)
    lp_g = ssm.emission_log_prob(x_tilde, ys_tm[:, :, None, :])
    return torch.sum(lp_f, dim=0) + torch.sum(lp_g, dim=0) + ssm.prior_log_prob(x_tilde[0])


# Time steps per chunk of the long-T log-joint (the reference's
# `_LOGJOINT_CHUNK`): each chunk's transition and emission heads run under a
# checkpoint, so their activations on [L, B, M, ·] exist one chunk at a time.
_LOGJOINT_CHUNK = 512


def _chunk_log_joint(ssm: SSM, x_prev, x_chunk, ys_chunk, u_chunk=None):
    """Σ over one chunk's steps of log f(x_t | x_{t−1}, u_t) + log g(y_t | x_t):
    x_prev [B, M, Dx] the step before the chunk, x_chunk [L, B, M, Dx],
    ys_chunk [L, B, Dy], u_chunk [L, B, Di] or None -> [B, M]."""
    pairs_prev = torch.cat([x_prev[None], x_chunk[:-1]], dim=0)
    lp_f = ssm.transition_log_prob(pairs_prev, x_chunk, _path_controls(u_chunk, x_chunk.shape[2]))
    lp_g = ssm.emission_log_prob(x_chunk, ys_chunk[:, :, None, :])
    return torch.sum(lp_f, dim=0) + torch.sum(lp_g, dim=0)


def _logjoint_chunked(ssm: SSM, x_tilde, ys_tm, ctrl_tm=None):
    """The selected-path log-joint in chunks of _LOGJOINT_CHUNK steps, each
    under a checkpoint (the reference's `_logjoint_chunked`): the direct
    form's value and gradient with its sums reassociated, and only one
    chunk's activations live."""
    length = _LOGJOINT_CHUNK
    x0 = x_tilde[0]
    lp0 = ssm.prior_log_prob(x0) + ssm.emission_log_prob(x0, ys_tm[0][:, None, :])
    parts = [_checkpointed(True, functools.partial(_chunk_log_joint, ssm), x_tilde[lo - 1],
                           x_tilde[lo:lo + length], ys_tm[lo:lo + length],
                           *(() if ctrl_tm is None else (ctrl_tm[lo:lo + length],)))
             for lo in range(1, x_tilde.shape[0], length)]
    return lp0 + torch.sum(torch.stack(parts), dim=0)


def _ffbsi_route(ssm: SSM, k: int, m: int, cuda: bool) -> str:
    """The FFBSi sweep's dispatch (`smc.smoothing_route`): "kernel" in
    K5/K6's class (`ffbsi.usable`), "eager" where the reference runs its scan
    body or the tensors are on the CPU, else "raise". Under a particle mesh
    "eager", on the row's slices (`ops.sharded_ffbsi`): K5/K6 hold whole
    rows of K."""
    if context.particle_mesh() is not None:
        return "eager"
    return smoothing_route(ffbsi.usable(ssm.dx, m, k, ssm.f_tril),
                           reference_ffbsi_path(ssm, k, m), cuda)


def _svo_route(ssm: SSM, m: int, cuda: bool) -> str:
    """The q_b sweep's dispatch (`smc.smoothing_route`): "kernel" in
    K12/K13's class (`svo.usable`), "eager" where the reference runs its scan
    body or the tensors are on the CPU, else "raise"."""
    return smoothing_route(svo.usable(ssm, m), reference_svo_path(ssm, m), cuda)


def _require_cuda_sweep(ssm: SSM, objective: str, k: int, m: int) -> None:
    """For CUDA tensors, before the forward filter runs: raise
    NotImplementedError where the reference runs the objective's sweep (K
    particles, m paths) through a kernel whose class the port's kernels do
    not cover."""
    if objective == "svo":
        if _svo_route(ssm, m, True) == "raise":
            raise NotImplementedError(
                "svo with this model has no CUDA kernel yet: the reference runs its q_b sweep "
                "through its SVO kernel (pallas_svo), but the port's K12/K13 stop at "
                f"{svo.cap_reached(ssm, m)} (outside ops.svo.usable; ROADMAP queue 2 B); run "
                "it on CPU tensors")
    elif _ffbsi_route(ssm, k, m, True) == "raise":
        raise NotImplementedError(
            "psvo with this model has no CUDA kernel yet: the reference runs its FFBSi sweep "
            "through its FFBSi kernel (pallas_ffbsi), but the port's K5/K6 stop at Dx = 908 "
            "(K6 wide's shared memory, outside ops.ffbsi.usable; ROADMAP queue 2 B); run it on "
            "CPU tensors")


def _ffbsi_sweep(ssm: SSM, x_query, xs, logws, gum, differentiable: bool, u=None):
    """One FFBSi sweep from the queries x_query [B, M, Dx] over the support
    xs [n, B, Dx, K] with the cumulative log-weights logws [n, B, K], Gumbels
    gum [n, B, M, K] and the controls into the step after each support step,
    u [n, B, Di] (or None). Dispatched by `_ffbsi_route`: in K5/K6's class
    the support terms and the normalized weights, which carry no gradient
    unless `differentiable`, then one `ffbsi.FFBSiSweep`; else
    `_plain_ffbsi_sweep` (the card's route where the reference runs its scan
    body). Returns (x_first, logp, logq, xtilde)."""
    k, m = xs.shape[-1], x_query.shape[1]
    route = _ffbsi_route(ssm, k, m, x_query.is_cuda)
    if route == "raise":
        _require_cuda_sweep(ssm, "psvo", k, m)
    if route == "eager":
        return _plain_ffbsi_sweep(ssm, x_query, xs, logws, gum, differentiable, u)
    r, mr, c = _support_terms(ssm, xs, differentiable, u)
    lwn, _ = log_normalize(logws, dim=-1)
    if not differentiable:
        lwn = lwn.detach()
    # the in-sweep logp is discarded (the log-joint is recomputed on the
    # selected paths), so its emission stream is zeros
    return ffbsi.FFBSiSweep.apply(x_query.contiguous(), xs.contiguous(), r, mr, c,
                                  lwn.contiguous(), torch.zeros_like(lwn), gum.contiguous())


def _ffbsi_backward(ssm: SSM, gum_anchor, gum_scan, ys_tm, fwd: FilterResult, ctrl_tm=None, *,
                    differentiable_sweep: bool):
    """FFBSi backward simulation over the forward support; with controls
    ctrl_tm [T, B, Di] support step t pairs with u_{t+1}. Returns (smoothed
    [T, B, M, Dx], log p(smoothed, y) [B, M], log q̃ [B, M]).

    The sweep only selects; the log-joint is evaluated afterwards on the
    selected paths. Unless the direct bound needs them, the support terms and
    normalized weights carry no gradient (the reference's stop_gradient), so
    only the selected particles' cotangents reach the filter.
    """
    x_anchor, lwn_anchor = _sample_final_particles(gum_anchor, fwd)
    _, _, lq_sweep, xtilde = _ffbsi_sweep(ssm, x_anchor, fwd.xs[:-1], fwd.logws[:-1], gum_scan,
                                          differentiable_sweep,
                                          None if ctrl_tm is None else ctrl_tm[1:])
    smoothed = torch.cat([xtilde, x_anchor[None]], dim=0)
    logp = _selected_path_log_joint(ssm, smoothed, ys_tm, ctrl_tm)
    return smoothed, logp, lwn_anchor + lq_sweep


def _ffbsi_backward_segmented(ssm: SSM, smc_cfg, gum_anchor, gumbels, ys_tm,
                              fwd: FilterResult, cache: SegmentedCache, ctrl_tm=None, *,
                              differentiable_sweep: bool):
    """FFBSi over a segmented forward (the reference's
    `_ffbsi_backward_segmented`). Returns what `_ffbsi_backward` returns.

    Segment s holds the support t = 1 + s·L … s·L + L; the sweep consumes
    t ≤ T − 2, so the last segment drops its final step (the anchors' time).
    In reverse over segments: replay segment s (`smc.recompute_segment`),
    form its support terms and normalized weights, draw its Gumbels
    (`gumbels(s, lo, n)`: [n, B, M, K] for steps lo … lo + n − 1), and run
    one `ffbsi.FFBSiSweep` (K5, K6 in the backward) from the previous
    segment's x_first, under `smc._checkpointed`: only the carries and the
    sweep's [L, B, M, Dx] paths persist. logq adds up across segments, and
    the anchor's cotangent reaches the next segment through K6's d_x_anchor.
    t = 0 is a one-step sweep through the same Function. With controls
    ctrl_tm [T, B, Di], support step t pairs with u_{t+1}: a segment's slice
    ctrl_tm[lo + 1 : lo + n + 1], and t = 0 u_1 (the reference's `ctrl_sup`
    and its t = 0 step).
    """
    t_steps = ys_tm.shape[0]
    seg_len = cache.seg_len
    x_q, lwn_anchor = _sample_final_particles(gum_anchor, fwd)
    x_anchor, logq = x_q, lwn_anchor

    def controls(lo, n):
        return None if ctrl_tm is None else ctrl_tm[lo + 1:lo + 1 + n]

    def segment_sweep(x_query, s, lo, n_sup):
        xs_seg, logws_seg = recompute_segment(cache, s)
        return _ffbsi_sweep(ssm, x_query, xs_seg[:n_sup], logws_seg[:n_sup],
                            gumbels(s, lo, n_sup), differentiable_sweep, controls(lo, n_sup))

    pieces = []  # the segments' paths, in reverse time order
    for s in reversed(range(len(cache.seg_x))):
        lo = 1 + s * seg_len
        n_sup = min(s * seg_len + seg_len, t_steps - 2) - lo + 1
        if n_sup <= 0:
            continue
        x_q, _, lq, xtilde = _checkpointed(
            smc_cfg.remat, lambda xq, s=s, lo=lo, n=n_sup: segment_sweep(xq, s, lo, n), x_q)
        logq = logq + lq
        pieces.append(xtilde)
    _, _, lq0, x0_tilde = _ffbsi_sweep(ssm, x_q, cache.x0[None], cache.alpha0[None],
                                       gumbels(None, 0, 1), differentiable_sweep, controls(0, 1))
    smoothed = torch.cat([x0_tilde, *reversed(pieces), x_anchor[None]], dim=0)
    logp = _selected_path_log_joint(ssm, smoothed, ys_tm, ctrl_tm)
    return smoothed, logp, logq + lq0


def _segment_gumbels(generator, noise, n_segments: int, batch: int, m: int, k: int):
    """gumbels(s, lo, n) -> the Gumbels [n, B, M, K] of support steps lo …
    lo + n − 1: the slice of the given gum_scan (noise[4]), else segment s's
    own, from a fresh generator seeded with its seed (drawn here, from the
    run's generator, after the anchors' Gumbels), and for t = 0 (s None)
    one more draw from the run's generator."""
    if noise is not None and len(noise) == 5:
        gum_scan = context.local_draw(noise[4], 1, True)
        return lambda s, lo, n: gum_scan[lo:lo + n]
    seeds = _segment_seeds(generator, n_segments, False)
    dev = generator.device

    def gumbels(s, lo, n):
        gen = generator if s is None else torch.Generator(device=dev).manual_seed(seeds[s])
        return _gumbel_share(gen, (n,), batch, m, k)

    return gumbels


def _predictive_mixture_logp(ssm: SSM, x_prev, logw_prev, x_query, u=None):
    """log p̂(x_query | y_{1:t}) = lse_j [log Ŵ_t^j + log f(x_query | X_t^j, u)]:
    x_prev [B, Dx, K], logw_prev [B, K], x_query [B, M, Dx], the controls
    into the query's step u [B, Di] (or None) -> [B, M]; the pairwise density
    of `_pairwise_query_logp`."""
    logw_norm, _ = collectives.log_normalize(logw_prev)
    pair = _pairwise_query_logp(ssm, _pairwise_support_terms(ssm, x_prev, u), x_query)
    return collectives.logsumexp(pair + logw_norm[:, None, :])


def _svo_scan(ssm: SSM, ys_tm, eps, x_anchor, ctrl_tm=None):
    """The reference's lax.scan body over t = T−2 … 0 on the model's heads,
    f on [x̃_t; u_{t+1}] with controls ctrl_tm [T, B, Di]: the q_b sweep's
    "eager" route (`_svo_route`), on the tensors' device. With smc.qb_rnn
    the GRU's summaries h_t of y_{t:T} are computed once, outside the path
    loop, and q_b reads h_t broadcast over the paths. Returns what
    `svo.run_svo_sweep` returns."""
    x = x_anchor
    lp = x_anchor.new_zeros(x_anchor.shape[:2])
    lq = torch.zeros_like(lp)
    h_scan = ssm.backward_rnn_summaries(ys_tm)[:-1] if ssm.qb_rnn else None  # [T−1, B, H]
    xts = [None] * eps.shape[0]
    for t in reversed(range(eps.shape[0])):
        y_t = ys_tm[t][:, None, :]
        h_t = None if h_scan is None else h_scan[t][:, None, :]
        mean_b, scale_b = ssm.backward_propose(x, y_t, h_t)
        x_t = mean_b + scale_b * eps[t]
        u = None if ctrl_tm is None else ctrl_tm[t + 1]
        lp = lp + ssm.transition_log_prob(x_t, x, u) + ssm.emission_log_prob(x_t, y_t)
        lq = lq + mvn_diag_log_prob(x_t, mean_b, scale_b)
        x = xts[t] = x_t
    return x, lp, lq, torch.stack(xts)


def _svo_backward(ssm: SSM, gum_anchor, eps, ys_tm, fwd: FilterResult, ctrl_tm=None):
    """Backward simulation with the learned proposal q_b; with controls
    ctrl_tm [T, B, Di] the mixture takes u_T and the sweep's f u_{t+1}.
    Returns (log w̃ [B, M], x̃ [T, B, M, Dx]).

    The anchors x̃_{T−1} come from the last filtering distribution; the q
    side's T-term is the continuous filter-density surrogate
    ρ_T = log g(y_T | x̃_T) + log p̂(x̃_T | y_{1:T−1}) − ℓ_T, the p side's
    log g(y_T | x̃_T); the sweep adds the rest, and the prior is taken at x̃_0.
    """
    x_anchor, _ = _sample_final_particles(gum_anchor, fwd)
    log_g_t = ssm.emission_log_prob(x_anchor, ys_tm[-1][:, None, :])
    log_pred = _predictive_mixture_logp(ssm, fwd.xs[-2], fwd.logws[-2], x_anchor,
                                        None if ctrl_tm is None else ctrl_tm[-1])
    log_rho_t = log_g_t + log_pred - fwd.increments[-1][:, None]
    m = x_anchor.shape[1]
    route = _svo_route(ssm, m, x_anchor.is_cuda)
    if route == "raise":
        _require_cuda_sweep(ssm, "svo", fwd.x_last.shape[-1], m)
    if route == "kernel":
        x_first, lp, lq, xtilde = svo.run_svo_sweep(ssm, ys_tm, eps, x_anchor, ctrl_tm)
    else:
        x_first, lp, lq, xtilde = _svo_scan(ssm, ys_tm, eps, x_anchor, ctrl_tm)
    logp = log_g_t + lp + ssm.prior_log_prob(x_first)
    logq = log_rho_t + lq
    return logp - logq, torch.cat([xtilde, x_anchor[None]], dim=0)


def _gumbel_share(generator, lead: tuple, batch: int, m: int, k: int):
    """Gumbels [*lead, B, M, K] from the generator; under a mesh the global
    draw (all rows) and this rank's share: its rows and its particles."""
    gum = _gumbel(generator, (*lead, context.global_rows(batch), m, k))
    return context.local_draw(gum, len(lead), True)


def _gumbel(generator, shape):
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1), as
    jax.random.gumbel makes them; in place, so the largest tensor of the
    PSVO step (gum_scan, 208 MB at the preset) has no temporaries."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u.clamp_(min=torch.finfo(u.dtype).tiny).log_().neg_().log_().neg_()


def _controls_kw(controls) -> dict:
    """forward_filter's controls= only when there are some: an uncontrolled
    call keeps the filter's call as it was."""
    return {} if controls is None else {"controls": controls}


def make_objective(ssm: SSM, cfg: Config):
    """Return objective(generator, ys, encoder_inputs=None, noise=None,
    controls=None); controls [B, T, Di] are a di > 0 model's exogenous inputs.

    noise is the testing hook: the filter's draws (eps0, eps_scan, u_scan)
    (`smc.forward_filter`), and for PSVO also the backward Gumbels
    (gum_anchor [B, M, K], gum_scan [T−1, B, M, K]) after them, for SVO the
    anchor Gumbels and the backward proposal's noise (gum_anchor, eps_svo
    [T−1, B, M, Dx]). Whatever it leaves out is drawn from the generator, the
    filter's noise first, then in that order. Segmented PSVO
    (smc.ffbsi_segments > 1) takes the same hook, each segment its slices;
    from the generator it draws eps0 and one seed per forward segment, then
    gum_anchor, one seed per segment's Gumbels and t = 0's Gumbels
    (`_segment_gumbels`), and never the whole [T−1, B, M, K] stack. Under
    the active mesh ys, encoder_inputs and controls are this rank's rows and
    noise holds the global draws: each rank takes its share of them, as of
    the generator's, and the loss and the metrics are its particle row's.
    """
    smc_cfg = cfg.smc
    if smc_cfg.objective == "iwae":
        smc_cfg = dataclasses.replace(smc_cfg, resampling="none")
    if not smc_cfg.use_stop_gradient and smc_cfg.resampling == "systematic":
        # the full FIVO gradient's score term is the product-categorical
        # log-prob of the ancestors, which systematic resampling does not have
        raise ValueError(
            "use_stop_gradient=False (the full FIVO gradient) requires "
            "resampling='multinomial'; systematic resampling has no "
            "product-categorical ancestor density"
        )
    if smc_cfg.objective not in ("iwae", "fivo", "svo", "psvo"):
        raise ValueError(f"unknown objective {smc_cfg.objective!r}")
    segmented = smc_cfg.objective == "psvo" and smc_cfg.ffbsi_segments > 1
    smoothing = smc_cfg.objective in ("svo", "psvo")
    m = smc_cfg.n_smoothing_particles

    def objective(generator, ys, encoder_inputs=None, noise=None,
                  controls=None) -> ObjectiveOutput:
        filter_noise = None if noise is None else tuple(noise[:3])
        if smoothing and ys.is_cuda:
            _require_cuda_sweep(ssm, smc_cfg.objective, smc_cfg.n_particles, m)
        if segmented:
            fwd, seg_cache = forward_filter_segmented(
                ssm, generator, ys, smc_cfg, smc_cfg.ffbsi_segments,
                encoder_inputs=encoder_inputs, noise=filter_noise, **_controls_kw(controls),
            )
        else:
            fwd = forward_filter(
                ssm, generator, ys, smc_cfg, cache=smoothing, encoder_inputs=encoder_inputs,
                noise=filter_noise, **_controls_kw(controls),
            )
        metrics = {
            "log_z_fwd": torch.mean(fwd.log_z),
            "ess_mean": torch.mean(fwd.ess),
            "ess_min": torch.min(fwd.ess),
        }
        elbo = fwd.log_z
        if not smoothing:
            loss = -torch.mean(elbo)
            if fwd.score_surrogate is not None:
                # the full FIVO gradient: the resampling distribution's
                # REINFORCE term at zero value (use_stop_gradient=False)
                sur = torch.mean(fwd.score_surrogate)
                loss = loss - (sur - sur.detach())
            return ObjectiveOutput(loss, elbo, metrics, filter_result=fwd)

        batch, t_steps, _ = ys.shape
        k = smc_cfg.n_particles
        # time-major controls for the backward pass (zeros when absent), or None at di = 0
        ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di, ys.device) if ssm.di else None
        if smc_cfg.objective == "svo":
            if noise is not None and len(noise) == 5:
                gum_anchor = context.local_draw(noise[3], 0, True)
                eps = context.local_draw(noise[4], 1, False)
            elif generator is None:
                raise ValueError("svo: pass a generator or the backward noise in noise")
            else:
                gum_anchor = _gumbel_share(generator, (), batch, m, k)
                eps = torch.randn((t_steps - 1, context.global_rows(batch), m, ssm.dx),
                                  generator=generator, device=generator.device)
                eps = context.local_draw(eps, 1, False)
            logw_traj, x_tilde = _svo_backward(ssm, gum_anchor, eps, ys.transpose(0, 1), fwd,
                                               ctrl_tm)
            elbo = torch.logsumexp(logw_traj, dim=-1) - math.log(m)
            metrics["elbo_svo"] = torch.mean(elbo)
            return ObjectiveOutput(-torch.mean(elbo), elbo, metrics, x_tilde, fwd)

        given = noise is not None and len(noise) == 5
        if not given and generator is None:
            raise ValueError("psvo: pass a generator or the backward Gumbels in noise")
        gum_anchor = (context.local_draw(noise[3], 0, True) if given
                      else _gumbel_share(generator, (), batch, m, k))
        direct_bound = smc_cfg.psvo_bound == "direct"
        if segmented:
            gumbels = _segment_gumbels(generator, noise, smc_cfg.ffbsi_segments, batch, m, k)
            x_tilde, logp_joint, logq_pmf = _ffbsi_backward_segmented(
                ssm, smc_cfg, gum_anchor, gumbels, ys.transpose(0, 1), fwd, seg_cache, ctrl_tm,
                differentiable_sweep=direct_bound,
            )
        else:
            gum_scan = (context.local_draw(noise[4], 1, True) if given
                        else _gumbel_share(generator, (t_steps - 1,), batch, m, k))
            x_tilde, logp_joint, logq_pmf = _ffbsi_backward(
                ssm, gum_anchor, gum_scan, ys.transpose(0, 1), fwd, ctrl_tm,
                differentiable_sweep=direct_bound,
            )
        # the sampled-trajectory bound; log q̃ is a pmf over the K-particle
        # support, so it carries a support-size offset (reference docstring)
        direct = torch.logsumexp(logp_joint - logq_pmf, dim=-1) - math.log(m)
        em_term = torch.mean(logp_joint)
        if direct_bound:
            loss = -torch.mean(direct)
        else:
            # forward bound + zero-valued EM surrogate carrying the
            # smoothed-path model gradient
            loss = -torch.mean(elbo) - (em_term - em_term.detach())
        metrics["log_joint_smoothed"] = em_term
        metrics["elbo_psvo_direct"] = torch.mean(direct)
        return ObjectiveOutput(loss, elbo, metrics, x_tilde, fwd)

    return objective
