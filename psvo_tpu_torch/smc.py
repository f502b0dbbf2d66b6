"""Forward particle filter (counterpart of `psvo_tpu/smc.py`, forward only).

Per step: resample ancestors, propose K particles from the fused proposal,
add the incremental log-weight log f + log g − log q, and accumulate
logZ += lse(logw + α) − lse(logw); with resampling at every step each term is
the FIVO increment lse(α) − log K.

Three paths, chosen from what the call can observe (`filter_route`):

- the whole-scan class (`ops.fused_step.usable`: diagonal models with
  max(Dx + Di, Dy) <= 7 and relu nets of one width, a multiple of 8, as wide
  and as deep as the kernels' plans hold in shared memory (at K = 2048 two
  hidden layers up to width 856 to 1344 by Dx and Dy, ten to twelve of
  width 64), systematic or multinomial resampling at every step,
  stop-gradient) runs
  `_forward_filter_fused`, whose steps t = 1..T−1 are one call of
  `fused_step.scan_forward` — the CUDA kernel K1 for CUDA tensors, its
  plain version for CPU tensors — and, when autograd records, one
  `fused_step.ScanForward`, whose backward is the CUDA kernel K4 (or its
  plain version); with `fused_step.SCAN_FUSED` off, a loop of one
  `fused_step.StepForward` per step instead (K14 forward, K15 backward);
- the trunk class (`ops.trunk.usable`: the reference's trunk class at the
  instantiated (Dx, Dy) of FHN, Lorenz-63 and Lorenz-96 — the wide state up
  to K = 19200, and at the small widths what the whole-scan class leaves:
  ESS-adaptive resampling, no resampling (IWAE), the full FIVO gradient)
  runs `_forward_filter_trunk`, a Python loop over t of the large-K
  resample (K7 indices, K8 gather; none without resampling) and the trunk
  kernel K9, with the weight bookkeeping in tensor ops between them; when
  autograd records, the gather goes through `resample_gather.GatherParticles`
  (backward: the segment-sum scatter K11) and the trunk through
  `trunk.TrunkForward` (backward: K10), so the loss's gradient runs K10 and
  K11 once per step (no K11 without resampling);
- everything else runs the plain step body in a Python loop over t, the
  counterpart of the reference's plain scan (`psvo_tpu/smc.py:671-760`). On
  CUDA tensors it serves the configurations that the reference's own gates
  send to that scan (`reference_path`): bootstrap mode, known dynamics,
  full-covariance or state-dependent heads, Poisson and Dirac emissions,
  and shapes outside the reference's kernels (IWAE at K = 16). There it
  resamples through K7 and K8 (`resampling.maybe_resample`), and its
  backward runs K11 (`resample_gather.GatherParticles`); without
  resampling it launches no kernel. A configuration that the reference
  sends to one of its kernels, but that no port kernel class takes (a net
  wider or deeper than the whole-step kernels' plans hold, a width above 64
  or a net deeper than K10's tiles hold for the trunk kernels), raises
  NotImplementedError on CUDA tensors rather than run plain PyTorch where
  the reference runs a kernel.

Under a mesh (`parallel.context`; the reference's `psvo_tpu/smc.py:113-134`)
a data mesh runs the dispatch above on each rank's rows; a particle mesh
runs the plain step body on each rank's K / P particles, its resampling the
sharded island (`ops.sharded_resampling`: K7/K8 per shard and ring step,
K11 in the backward) and every reduction over K (ℓ's logsumexps, the
filtered mean, the ESS, the score term's normalizer) through
`parallel.collectives`. Every rank draws the run's global streams and keeps
its share.

Bootstrap mode (smc.use_bootstrap) proposes from the prior at t = 0 and
from f after, so α0 = log g and α_t = log g (with a full-covariance f, the
correlated draw mean + L·ε).

Long T: `forward_filter_segmented` keeps only the carries entering each of
S segments (`SegmentedCache`). In the whole-scan class (with
`fused_step.SCAN_FUSED` on) each segment is one `fused_step.ScanForward`
(K1, K4 in the backward) from its carry over its rows of the coefficient
tensor; otherwise the plain body runs per segment, as the reference's does,
on CUDA tensors with K7/K8 resampling (K11 in the backward). Under smc.remat
each segment runs under `torch.utils.checkpoint`, and draws its noise from a
seed of its own inside the checkpoint, so that only the carries persist.
`recompute_segment` replays a segment through the same code, bit for bit.

Controls [B, T, Di] (data.di > 0) are exogenous inputs: step t's q1 and f
see [x_{t−1}; u_t], so the carry into step t holds u_t (`controls=`; zeros
when None, as the reference's `_controls_tm`). The plain body concatenates
them; the kernel paths fold them into the coefficient rows
(`fused_step.control_term`), whose first-layer terms K1, K14 and K9 add to
q1's and f's first-layer bias.

Public shapes follow the reference: particles are channel-major
[B, Dx, K], `FilterResult.xs` is [T, B, Dx, K] and `filtered_means`
[T, B, Dx]. Gradients follow the reference: with smc.use_stop_gradient
none goes through the ancestor choice; without it (the full FIVO gradient,
multinomial resampling) the plain body and the trunk path also return
`FilterResult.score_surrogate`, the REINFORCE term of the resampling
distribution (`_score_surrogate`), which the FIVO objective adds at zero
value.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from psvo_tpu_torch.config import SMCConfig
from psvo_tpu_torch.distributions import (
    effective_sample_size, log_normalize, mvn_diag_log_prob_cm, mvn_tril_sample_cm,
)
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import fused_step, resample_gather, resampling, sharded_resampling, trunk
from psvo_tpu_torch.parallel import collectives, context


def _lse(logw):
    """logsumexp over K (across the particle axis of the active mesh)."""
    return collectives.logsumexp(logw)


def _ancestor_score(logw_pre, did, idx):
    """The score-function term of one resample (the full FIVO gradient,
    Maddison et al. 2017): Σ_k log Ŵ[a_k], the categorical log-prob of the
    chosen ancestors idx [B, K] under the normalized incoming weights
    logw_pre [B, K], differentiable through them; 0 on the rows that the ESS
    test kept (did [B] false). The reference's `smc.py:161-169`."""
    logw_norm, _ = log_normalize(logw_pre, dim=-1)
    picked = torch.gather(logw_norm, -1, idx.long())
    return torch.where(did, torch.sum(picked, dim=-1), torch.zeros_like(picked[:, 0]))


def _score_surrogate(ells, scores):
    """Σ_t stopgrad(Σ_{s>=t} ℓ_s) · score_t over the steps t = 1..T−1 (ells,
    scores [T−1, B]): the REINFORCE term of the resampling distribution, the
    return-to-go from step t (its own increment included) weighting the
    log-prob of its ancestors. Its value means nothing; the objective adds
    (surrogate − surrogate.detach()), so only its gradient acts. The
    reference's `smc._score_surrogate` (`smc.py:759-767`)."""
    future = torch.flip(torch.cumsum(torch.flip(ells, [0]), dim=0), [0])
    return torch.sum(future.detach() * scores, dim=0)


@dataclass
class FilterResult:
    """Everything downstream objectives need from one forward pass."""

    log_z: torch.Tensor  # [B]
    increments: torch.Tensor  # [T, B] per-step logZ increments ℓ_t
    ess: torch.Tensor  # [T, B] effective sample size before resampling
    x_last: torch.Tensor  # [B, Dx, K]
    logw_last: torch.Tensor  # [B, K]
    xs: Optional[torch.Tensor] = None  # [T, B, Dx, K] (cache only)
    logws: Optional[torch.Tensor] = None  # [T, B, K] (cache only)
    filtered_means: Optional[torch.Tensor] = None  # [T, B, Dx]
    # zero-valued-gradient carrier of the resampling score-function term
    # (use_stop_gradient=False, the full FIVO gradient); None otherwise
    score_surrogate: Optional[torch.Tensor] = None  # [B]


def _init_t0(ssm: SSM, eps0, y0, enc0):
    """t=0: x0 = mean0 + scale0·eps0 ~ q0(·|y0), weighted against the prior:
    α0 = log p(x0) + log g(y0|x0) − log q0(x0); in bootstrap mode q0 is the
    prior, the two cancel and α0 = log g(y0|x0)."""
    mean0, scale0 = ssm.propose_initial(enc0)  # [B, Dx]
    x0 = mean0[:, :, None] + scale0[:, :, None] * eps0  # [B, Dx, K]
    log_g0 = ssm.emission_log_prob_cm(x0, y0)
    if ssm.use_bootstrap:
        return x0, log_g0
    alpha0 = (
        ssm.prior_log_prob_cm(x0)
        + log_g0
        - mvn_diag_log_prob_cm(x0, mean0[:, :, None], scale0[:, :, None])
    )
    return x0, alpha0


def _controls_tm(controls, batch: int, t_steps: int, di: int, device):
    """Time-major [T, B, Di] control inputs; zeros when absent (Di may be 0)."""
    if controls is not None:
        return controls.transpose(0, 1)
    return torch.zeros((t_steps, batch, di), device=device)


def _q2_tm(ssm: SSM, cfg: SMCConfig, enc_tm):
    """The encoder proposal q2 for all T in one batched call, or None (also
    in bootstrap mode, which proposes from f)."""
    if cfg.use_2q and not cfg.use_bootstrap:
        return ssm.q2_mean_scale(enc_tm)  # 2x [T, B, Dx]
    return None


def _make_step_body(ssm: SSM, cfg: SMCConfig, remat: bool = False):
    """One plain filtering step t: (maybe) resample -> propose -> weight.

    body((x, logw), (y_t, q2_t, ctrl_t, eps_t, u_t)) -> ((x_new, logw_new),
    (ell, ess, fmean, score)); q2_t is the step's precomputed q2 (mean, scale)
    or None, ctrl_t its controls [B, Di], u_t the resampling uniforms; score
    [B] the resample's score-function term (`_ancestor_score`) without
    smc.use_stop_gradient, else zeros.

    The proposal, by model (the reference's `smc._make_step_body`): in
    bootstrap mode with a full-covariance f the correlated draw
    x = mean_f + L·ε (a constant L, or the per-state packed factor) and
    α = log g; with a full-covariance f the diagonal proposal, weighted by
    f's full density; otherwise the diagonal path, q1 (⊗ q2) and f from
    `ssm.step_heads_cm`.

    With `remat` (the reference's smc.remat) the propose-and-weight part runs
    under `torch.utils.checkpoint` when autograd records, so that the
    backward recomputes it from its inputs. The resampling stays outside,
    as the reference's policy saves the resampled particles and the
    ancestors: the backward never repeats the resample (K7 and K8 on the
    card), and the gather's own backward (K11) runs once a step. The
    checkpoint is the reentrant one: its forward records no graph, so the
    host does less work a step than with the non-reentrant form on this
    eager loop; it takes tensors only (q2_t goes in as its two halves), and
    the parameters read inside get their gradients from its backward.
    """
    resample_on = cfg.resampling != "none"
    score_on = resample_on and not cfg.use_stop_gradient
    sharded = context.particle_mesh() is not None

    def propose_weight(x, logw, y_t, q2_t, ctrl_t, eps_t):
        if ssm.f_tril and ssm.use_bootstrap:
            if ssm.f_tril_head:
                x_new = mvn_tril_sample_cm(eps_t, *ssm.transition_tril_cm(x, ctrl_t))
            else:
                mean_f, chol_f = ssm.transition_full_cm(x, ctrl_t)
                x_new = mean_f + torch.einsum("de,...ek->...dk", chol_f, eps_t)
            alpha = ssm.emission_log_prob_cm(x_new, y_t)
        elif ssm.f_tril:
            mean_q, scale_q = ssm.propose_cm(x, y_t, q2_t, ctrl_t)
            x_new = mean_q + scale_q * eps_t
            alpha = (
                ssm.transition_log_prob_cm(x, x_new, ctrl_t)
                + ssm.emission_log_prob_cm(x_new, y_t)
                - mvn_diag_log_prob_cm(x_new, mean_q, scale_q)
            )
        else:
            mean_q, scale_q, mean_f, scale_f = ssm.step_heads_cm(x, y_t, q2_t, ctrl_t)
            x_new = mean_q + scale_q * eps_t  # [B, Dx, K]
            log_g = ssm.emission_log_prob_cm(x_new, y_t)
            if ssm.use_bootstrap:  # q = f: the densities cancel
                alpha = log_g
            else:
                alpha = (
                    mvn_diag_log_prob_cm(x_new, mean_f, scale_f)
                    + log_g
                    - mvn_diag_log_prob_cm(x_new, mean_q, scale_q)
                )
        logw_new = logw + alpha
        lse_new = _lse(logw_new)
        ell = lse_new - _lse(logw)
        fmean = collectives.weighted_mean(logw_new, x_new, lse=lse_new)
        return x_new, logw_new, ell, fmean

    def flat_propose_weight(x, logw, y_t, m2, s2, ctrl_t, eps_t):
        return propose_weight(x, logw, y_t, None if m2 is None else (m2, s2), ctrl_t, eps_t)

    def body(carry, inputs):
        x, logw = carry
        y_t, q2_t, ctrl_t, eps_t, u_t = inputs
        score = torch.zeros_like(logw[:, 0])
        if resample_on and sharded:
            # the sharded island (`ops.sharded_resampling`): the ancestors'
            # normalized log-weights travel the ring with their particles
            lwn = collectives.log_normalize(logw)[0] if score_on else None
            x, logw, did, ess, _, picked = sharded_resampling.sharded_maybe_resample(
                u_t, logw, x, ess_threshold=cfg.ess_threshold, lwn=lwn)
            if score_on:
                score = collectives.psum(torch.where(did, torch.sum(picked, dim=-1), score))
        elif resample_on:
            logw_pre = logw
            x, logw, did, ess, idx = resampling.maybe_resample(
                u_t, logw, x, method=cfg.resampling, ess_threshold=cfg.ess_threshold
            )
            if score_on:
                score = _ancestor_score(logw_pre, did, idx)
        else:
            ess = collectives.effective_sample_size(logw)
        if remat and torch.is_grad_enabled():
            m2, s2 = q2_t if q2_t is not None else (None, None)
            x_new, logw_new, ell, fmean = torch.utils.checkpoint.checkpoint(
                flat_propose_weight, x, logw, y_t, m2, s2, ctrl_t, eps_t, use_reentrant=True,
                preserve_rng_state=False)
        else:
            x_new, logw_new, ell, fmean = propose_weight(x, logw, y_t, q2_t, ctrl_t, eps_t)
        return (x_new, logw_new), (ell, ess, fmean, score)

    return body


def _draw_noise(generator, cfg: SMCConfig, t_steps: int, batch: int, dx: int):
    """(eps0 [B, Dx, K], eps_scan [T−1, B, Dx, K], u_scan [T−1, B, K]) from
    the run's generator, in that order; under a mesh the global draws and
    this rank's share (`_local_noise`)."""
    k, dev = cfg.n_particles, generator.device
    rows = context.global_rows(batch)
    eps0 = torch.randn((rows, dx, k), generator=generator, device=dev)
    eps_scan = torch.randn((t_steps - 1, rows, dx, k), generator=generator, device=dev)
    if cfg.resampling != "none":
        u_scan = resampling.bulk_positions(generator, t_steps - 1, rows, k, cfg.resampling)
    else:
        u_scan = torch.zeros((t_steps - 1, rows, 1), device=dev)
    return _local_noise((eps0, eps_scan, u_scan))


def _local_noise(noise):
    """This rank's share of the filter's global draws (eps0, eps_scan,
    u_scan): its rows, and on a particle mesh its particles (the positions
    of its own output slots); the draws themselves without a mesh."""
    eps0, eps_scan, u_scan = noise
    return (context.local_draw(eps0, 0, True), context.local_draw(eps_scan, 1, True),
            context.local_draw(u_scan, 1, u_scan.shape[-1] > 1))


def _draw_eps0(generator, batch: int, dx: int, k: int):
    """eps0 [B, Dx, K] alone (the segmented paths' first draw), this rank's
    share under a mesh."""
    eps0 = torch.randn((context.global_rows(batch), dx, k), generator=generator,
                       device=generator.device)
    return context.local_draw(eps0, 0, True)


def _mesh_cfg(cfg: SMCConfig) -> SMCConfig:
    """The filter's settings under the active mesh: no in-kernel draw, since
    K1, K9 and K14 key their Philox counters by the local row and so would
    draw other noise than the same rows of an unsharded run; every rank
    draws the global streams instead. Unchanged without a mesh."""
    if context.get_mesh() is None or not cfg.kernel_rng:
        return cfg
    return dataclasses.replace(cfg, kernel_rng=False)


def _fused_preamble(ssm: SSM, generator, ys, cfg: SMCConfig, encoder_inputs, streams,
                    controls=None, segmented: bool = False):
    """What both kernel paths compute before their steps (the reference's
    `smc._fused_preamble`): the packed heads, t = 0 and each step's
    coefficients, in plain tensor code, and the noise. With controls
    (ssm.di > 0) each step's coefficient row also carries u_t's first-layer
    terms of q1 and f (`fused_step.control_term`; zeros for None).

    Noise: `streams` = (eps0, eps_scan, u_scan) replays given draws (u_scan
    the sorted positions); otherwise eps0 comes from `generator` and, with
    cfg.kernel_rng, a two-word seed taken from the generator for the kernel
    to draw from (eps_scan and u_scan None), else the streams are drawn too;
    `segmented` draws eps0 alone (each segment draws its own noise).
    Returns (consts, coef, x0, alpha0, eps_scan, u_scan, seed).
    """
    batch, t_steps, _ = ys.shape
    k, dx, dy = cfg.n_particles, ssm.dx, ssm.dy
    ys_tm = ys.transpose(0, 1)  # [T, B, Dy]
    enc_tm = encoder_inputs.transpose(0, 1) if encoder_inputs is not None else ys_tm

    consts = fused_step.prepare(ssm)
    aq, cq, sq, logsq_sum = fused_step.fusion_coeffs(ssm, cfg, consts, enc_tm)

    seed = eps_scan = u_scan = None
    if streams is not None:
        eps0, eps_scan, u_scan = streams
    elif segmented:
        eps0 = _draw_eps0(generator, batch, dx, k)
    elif cfg.kernel_rng:
        dev = generator.device
        eps0 = torch.randn((batch, dx, k), generator=generator, device=dev)
        seed = tuple(
            int(v) for v in torch.randint(0, 2**32, (2,), generator=generator, device=dev)
        )
    else:
        eps0, eps_scan, u_scan = _draw_noise(generator, cfg, t_steps, batch, dx)

    x0, alpha0 = _init_t0(ssm, eps0, ys_tm[0], enc_tm[0])
    # α's K-independent part: −log q's log-scale sum, log f's and log g's,
    # and g's Gaussian constant (f's and q's cancel)
    ab = (
        logsq_sum[1:]
        - consts["log_sf_sum"]
        - consts["log_sg_sum"]
        - dy * 0.5 * math.log(2.0 * math.pi)
    )
    ctrl_bias = None
    if ssm.di:
        ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di, ys.device)
        ctrl_bias = fused_step.control_term(consts, ctrl_tm[1:])
    coef = fused_step.pack_coef(aq[1:], cq[1:], sq[1:], ys_tm[1:], ab, ctrl_bias)
    return consts, coef, x0, alpha0, eps_scan, u_scan, seed


def _forward_filter_fused(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    *,
    cache: bool,
    encoder_inputs=None,
    streams: Optional[tuple] = None,
    controls=None,
) -> FilterResult:
    """The kernel path: `_fused_preamble` (t = 0, the fusion coefficients,
    the controls' terms and the noise), then steps 1..T−1 as one
    `fused_step.scan_forward` call —
    through `fused_step.ScanForward` when autograd records, whose saved
    residuals take the place of the reference's remat, so gradients reach the
    t = 0 proposal, the fusion coefficients, ab and the packed head weights.
    With cfg.kernel_rng the kernel draws ε and the resampling offsets itself;
    multinomial resampling streams both (its sorted positions from
    `resampling.bulk_positions`).

    With `fused_step.SCAN_FUSED` off, the per-step path of the reference
    (`pallas_step._step_call` under lax.scan): a loop of T−1
    `fused_step.StepForward` calls (K14, and K15 in the backward), or of
    `fused_step.step_forward` under no_grad, on streamed noise only (the
    reference turns the in-kernel draw off there too). Nothing in the loop
    waits for the device.
    """
    per_step = not fused_step.SCAN_FUSED
    if per_step or cfg.resampling != "systematic":
        # the in-kernel draw makes systematic positions only: multinomial's
        # sorted iid positions would need a sort inside the kernel, so they
        # are streamed, with ε (the reference's `smc.py:419-429`)
        cfg = dataclasses.replace(cfg, kernel_rng=False)
    consts, coef, x0, alpha0, eps_scan, u_scan, seed = _fused_preamble(
        ssm, generator, ys, cfg, encoder_inputs, streams, controls
    )
    ell0 = _lse(alpha0) - math.log(cfg.n_particles)
    x0, alpha0 = x0.contiguous(), alpha0.contiguous()
    xs = logws = None
    if per_step:
        x_last, logw_last, stats, xs, logws = _filter_steps(x0, alpha0, coef, consts, eps_scan,
                                                            u_scan, cache)
    else:
        if torch.is_grad_enabled():
            outs = fused_step.ScanForward.apply(
                x0, alpha0, coef, consts["packed"], consts["sconst"], consts, eps_scan, u_scan,
                seed, cache,
            )
        else:
            outs = fused_step.scan_forward(x0, alpha0, coef, consts, eps=eps_scan,
                                           positions=u_scan, seed=seed, cache=cache)
        x_last, logw_last, stats = outs[:3]
        if cache:
            xs = torch.cat([x0[None], outs[3]], dim=0)
            logws = torch.cat([alpha0[None], outs[4]], dim=0)

    increments = torch.cat([ell0[None], stats[:, :, 0]], dim=0)
    ess = torch.cat([effective_sample_size(alpha0)[None], stats[:, :, 1]], dim=0)
    fmean0 = torch.einsum("bk,bdk->bd", torch.softmax(alpha0, dim=-1), x0)
    return FilterResult(
        log_z=torch.sum(increments, dim=0),
        increments=increments,
        ess=ess,
        x_last=x_last,
        logw_last=logw_last,
        xs=xs,
        logws=logws,
        filtered_means=torch.cat([fmean0[None], stats[:, :, 2:]], dim=0),
    )


def _filter_steps(x0, alpha0, coef, consts, eps_scan, u_scan, cache: bool):
    """Steps 1..T−1 of the per-step path, one K14 launch each. Returns
    (x_last, logw_last, stats [T−1, B, 2 + Dx], xs, logws), the last two
    [T, ...] stacks under `cache`, else None. The stacks are built once at
    the end: writing each step into a preallocated buffer under autograd
    would make every step's backward copy the whole buffer's gradient."""
    grad = torch.is_grad_enabled()
    x, logw = x0, alpha0
    xs, logws, stats = [x0], [alpha0], []
    for c, e, u in zip(coef.unbind(0), eps_scan.unbind(0), u_scan.unbind(0)):
        if grad:
            x, logw, st = fused_step.StepForward.apply(x, logw, c, consts["packed"],
                                                       consts["sconst"], consts, e, u)
        else:
            x, logw, st = fused_step.step_forward(x, logw, c, consts, e, u)[:3]
        stats.append(st)
        if cache:
            xs.append(x)
            logws.append(logw)
    if not cache:
        return x, logw, torch.stack(stats), None, None
    return x, logw, torch.stack(stats), torch.stack(xs), torch.stack(logws)


def _forward_filter_trunk(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    *,
    cache: bool,
    encoder_inputs=None,
    streams: Optional[tuple] = None,
    controls=None,
) -> FilterResult:
    """The trunk path, step for step the reference's trunk body
    (`psvo_tpu/smc.py:560-595`): `_fused_preamble` (t = 0, the fusion
    coefficients, the controls' first-layer terms and the noise), then per
    step t = 1..T−1 the resample (`resampling.maybe_resample` through K7/K8:
    every row at ess_threshold >= 1, else the rows whose ESS fell below it,
    the others keeping their particles and weights; no resample and the
    ESS of the current weights without resampling) and one
    `trunk.trunk_forward` (K9), with ℓ, the ESS and the filtered mean as
    tensor ops on [B, K]. Nothing inside the loop waits for the device. With
    cfg.kernel_rng K9 draws each step's ε from the seed, and the positions
    u_scan come from `generator` after it.

    Under autograd the gradient of ℓ = lse(logw + α) − lse(logw) reaches
    t = 0, the fusion coefficients, ab, the controls' terms and the packed
    head weights through the two autograd Functions; resampled rows restart
    at log-weight 0 (a constant), and the ESS and the filtered means are
    metrics that carry no gradient, as K4 drops their cotangents on the
    whole-scan path. Without smc.use_stop_gradient each resample's score
    term (`_ancestor_score`, from K7's indices) goes into
    `score_surrogate`.
    """
    batch, t_steps, _ = ys.shape
    k = cfg.n_particles
    resample_on = cfg.resampling != "none"
    score_on = not cfg.use_stop_gradient
    consts, coef, x0, alpha0, eps_scan, u_scan, seed = _fused_preamble(
        ssm, generator, ys, cfg, encoder_inputs, streams, controls
    )
    if seed is not None and resample_on:
        u_scan = resampling.bulk_positions(generator, t_steps - 1, batch, k, cfg.resampling)

    x, logw = x0.contiguous(), alpha0.contiguous()
    ells, esss, fmeans, scores = [], [], [], []
    xs, logws = [x0], [alpha0]
    for t in range(t_steps - 1):
        if resample_on:
            logw_pre = logw
            x, logw, did, ess, idx = resampling.maybe_resample(
                u_scan[t], logw, x, method=cfg.resampling, ess_threshold=cfg.ess_threshold,
                use_kernel=True,
            )
            if score_on:
                scores.append(_ancestor_score(logw_pre, did, idx))
        else:
            ess = effective_sample_size(logw, dim=-1)
            if score_on:
                scores.append(torch.zeros_like(ess))
        noise = {"seed": seed, "t": t} if seed is not None else {"eps": eps_scan[t]}
        x, alpha = trunk.trunk_forward(x, coef[t], consts, **noise)
        logw_new = logw + alpha
        ells.append(_lse(logw_new) - _lse(logw))
        esss.append(ess.detach())
        fmeans.append(torch.einsum("bk,bdk->bd", torch.softmax(logw_new.detach(), dim=-1),
                                   x.detach()))
        logw = logw_new
        if cache:
            xs.append(x)
            logws.append(logw)

    steps = torch.stack(ells)
    ell0 = _lse(alpha0) - math.log(k)
    increments = torch.cat([ell0[None], steps])
    alpha0 = alpha0.detach()
    fmean0 = torch.einsum("bk,bdk->bd", torch.softmax(alpha0, dim=-1), x0.detach())
    return FilterResult(
        log_z=torch.sum(increments, dim=0),
        increments=increments,
        ess=torch.stack([effective_sample_size(alpha0), *esss]),
        x_last=x,
        logw_last=logw,
        xs=torch.stack(xs) if cache else None,
        logws=torch.stack(logws) if cache else None,
        filtered_means=torch.stack([fmean0, *fmeans]),
        score_surrogate=_score_surrogate(steps, torch.stack(scores)) if score_on else None,
    )


# The reference's kernel gates, as constants of its TPU kernels: particles a
# tile (`pallas_resample.Q`), the whole-step kernel's K cap
# (`pallas_step.MAX_K`), the trunk kernel's tile and state rows
# (`pallas_trunk.K_TILE`, `MAX_PD`).
_REF_Q, _REF_STEP_MAX_K, _REF_K_TILE, _REF_MAX_PD = 128, 2048, 2048, 56
_REFERENCE_KERNELS = {"fused": "whole-step kernel (pallas_step)",
                      "trunk": "trunk kernel (pallas_trunk)"}


def _raise_reason(ssm: SSM, cfg: SMCConfig) -> str:
    """What stops the port's kernels where `filter_route` says "raise": the
    shape, for the reference's kernel of `reference_path`."""
    if reference_path(ssm, cfg) == "fused":
        return ("outside ops.fused_step.usable: a net wider or deeper than the whole-step "
                "kernels' plans hold in shared memory, fused_step.shape_fits")
    return ("outside ops.trunk.usable: a width above 64, or a net deeper than the trunk "
            "kernels' tiles hold, trunk.shape_ok")


def reference_path(ssm: SSM, cfg: SMCConfig) -> str:
    """The path the reference's `forward_filter` takes for (ssm, cfg) on its
    accelerator: "fused" (`pallas_step.usable`), "trunk"
    (`pallas_trunk.usable`) or "scan", its plain scan, which resamples through
    its resampling kernel (`ops/resampling.py:176-183`). It mirrors the two
    gates mode by mode (pallas_step.py:131-169, pallas_trunk.py:81-121) with
    the reference's defaults (its kernels on) at a batch that is a whole
    number of its row blocks: the port's kernels have no row block, so the
    batch size never moves a configuration from one route to another. Under
    any mesh it is "scan": both gates turn the kernels off there
    (pallas_step.py:133-137, pallas_trunk.py:88-92).

    On CUDA tensors the port's plain loop, the counterpart of that scan
    (resampling through K7/K8, K11 in the backward), serves only "scan"
    configurations that no port kernel class takes; a configuration the
    reference sends to a kernel whose class the port does not cover for it
    raises (`filter_route`): for "fused", a net wider or deeper than the
    kernels' plans hold in shared memory (at K = 2048, two hidden layers
    wider than 1344 at Dx = Dy = 2 or 856 at Dx = Dy = 7, or more than 10 to
    12 hidden layers of width 64 by Dx and Dy; the port's whole-step class,
    `fused_step.usable`, takes every other shape of the reference's); for
    "trunk", a width above 64 (`trunk.MAX_WIDTH`) or a net deeper than K10's
    streamed tiles hold (at (55, 55) and width 64, more than eight hidden
    layers; `trunk.shape_ok`): the port's trunk class, `trunk.usable`, takes
    every other shape of the reference's, with ESS-adaptive resampling, no
    resampling (IWAE at a K the trunk kernel tiles), the full FIVO gradient
    and controls, at any K (the resample takes every K,
    `resample_gather.resample_and_gather`). Training a resampling filter
    above K = 32768 with K % 128 == 0 on CUDA tensors raises too, up front:
    K11, the resample's backward, holds K up to 32768, and above it the
    reference runs its sorted segment sum's kernels there (`backward_hole`;
    with K % 128 != 0 it runs a plain scatter-add, and so does the port).
    """
    if context.get_mesh() is not None:
        return "scan"  # the reference's kernels gate themselves off under any mesh
    k = cfg.n_particles
    nets = [ssm.nets[n] for n in ("q1", "f", "g")]
    hidden = nets[0].hidden
    common = (
        not (cfg.use_bootstrap or ssm.transition_known)
        and ssm.emission not in ("poisson", "dirac")
        and not (ssm.f_tril or ssm.g_tril)
        and k % _REF_Q == 0
        and len(hidden) >= 1
        and all(h == hidden[0] for h in hidden)
        and hidden[0] % 8 == 0
        and all(nc.hidden == hidden and nc.cov_type == "const" and nc.activation == "relu"
                for nc in nets)
    )
    if not common:
        return "scan"
    widest = max(ssm.dx + ssm.di, ssm.dy)
    if (cfg.resampling in ("systematic", "multinomial") and cfg.ess_threshold >= 1.0
            and cfg.use_stop_gradient and k <= _REF_STEP_MAX_K and widest <= 7):
        return "fused"
    pd = -(-(widest + 1) // 8) * 8
    tile = min(k, _REF_K_TILE if pd <= 16 else _REF_K_TILE // 2)
    if pd <= _REF_MAX_PD and not (k > tile and k % tile):
        return "trunk"
    return "scan"


# The reference's smoothing-sweep gates, as constants of its TPU kernels: the
# SVO kernel's M floor and lanes (`pallas_svo.MIN_M`, `pallas_step._LANES`) and
# row cap, and the FFBSi kernel's K cap (`pallas_ffbsi.MAX_K`).
_REF_SVO_MIN_M, _REF_LANES, _REF_SVO_MAX_ROWS, _REF_FFBSI_MAX_K = 32, 128, 7, 2048


def reference_svo_path(ssm: SSM, m: int) -> str:
    """The route of the reference's SVO sweep for (ssm, m paths) on its
    accelerator: "kernel" (`pallas_svo.usable`, pallas_svo.py:104-140) or
    "plain", its lax.scan body (`psvo_tpu/objectives.py:290-313`), mode by
    mode, with its defaults (kernels on) at a batch of whole row blocks;
    "plain" under any mesh (pallas_svo.py:106-110). Bootstrap mode does not
    enter it: the sweep reads q_b, f and g, never the forward proposal."""
    if context.get_mesh() is not None:
        return "plain"
    nets = [ssm.nets[n] for n in ("qb", "f", "g")]
    hidden = nets[0].hidden
    kernel = (
        not (ssm.qb_rnn or ssm.transition_known)
        and ssm.emission not in ("poisson", "dirac")
        and not (ssm.f_tril or ssm.g_tril)
        and m >= _REF_SVO_MIN_M
        and not (m > _REF_LANES and m % _REF_LANES)
        and max(ssm.dx + ssm.di, ssm.dy) <= _REF_SVO_MAX_ROWS
        and ssm.dx + ssm.dy <= _REF_SVO_MAX_ROWS
        and len(hidden) >= 1
        and all(h == hidden[0] for h in hidden)
        and hidden[0] % 8 == 0
        and all(nc.hidden == hidden and nc.cov_type == "const" and nc.activation == "relu"
                for nc in nets)
    )
    return "kernel" if kernel else "plain"


def reference_ffbsi_path(ssm: SSM, k: int, m: int) -> str:
    """The route of the reference's FFBSi sweep over K particles with m
    paths: "kernel" (`pallas_ffbsi.usable`, pallas_ffbsi.py:51-63: a
    diagonal f, K a multiple of 128 up to 2048, M a multiple of 8) or
    "plain", its scan body (`objectives._make_ffbsi_body`), with its
    defaults at a batch of whole row blocks; "plain" under any mesh
    (pallas_ffbsi.py:52-57)."""
    if context.get_mesh() is not None:
        return "plain"
    kernel = (not ssm.f_tril and k % _REF_Q == 0 and k <= _REF_FFBSI_MAX_K and m % 8 == 0)
    return "kernel" if kernel else "plain"


def filter_route(ssm: SSM, cfg: SMCConfig, t_steps: int, cuda: bool,
                 segmented: bool = False) -> str:
    """The dispatch of the forward filter over t_steps steps (the counterpart
    of `smoothing_route`): "fused" (the whole-scan class, `fused_step.usable`:
    K1/K4, or K14/K15 with `fused_step.SCAN_FUSED` off), "trunk"
    (`trunk.usable`: K9/K10), "plain" (the plain step loop, on CPU tensors
    also the counterpart of every kernel path the port has no class for), or
    "raise" (CUDA only: the reference runs a kernel, `reference_path`, whose
    class the port does not cover for this configuration). The segmented
    forward (`forward_filter_segmented`) takes "fused" only with SCAN_FUSED
    on and never "trunk"; on CUDA tensors it raises only where the reference
    runs its segments through its whole-step kernel (SCAN_FUSED on). Under a
    particle mesh the kernels are off: "plain". Both entry points call it
    before they launch anything."""
    if t_steps < 2:
        return "plain"
    if context.particle_mesh() is None:
        if fused_step.usable(ssm, cfg) and (fused_step.SCAN_FUSED or not segmented):
            return "fused"
        if not segmented and trunk.usable(ssm, cfg):
            return "trunk"
    if not cuda:
        return "plain"
    ref = reference_path(ssm, cfg)
    if ref == "scan" or (segmented and (ref != "fused" or not fused_step.SCAN_FUSED)):
        return "plain"
    return "raise"


def backward_hole(ssm: SSM, cfg: SMCConfig) -> bool:
    """Whether a gradient through this resampling filter on CUDA tensors
    needs K11 above its cap: autograd records, some parameter takes a
    gradient, the filter resamples and K > `resample_gather.MAX_K` with
    K % 128 == 0, where the reference's resample backward (`_rg_bwd`) runs
    its sorted segment sum's kernels and the port has none (ROADMAP queue 2
    B). Above the cap with K % 128 != 0 the reference runs a plain
    scatter-add, and so does the port's `GatherParticles` on the card
    (`resample_gather.eager_scatter`). The forward runs at every K."""
    k = cfg.n_particles
    return (k > resample_gather.MAX_K and not resample_gather.eager_scatter(k)
            and cfg.resampling != "none" and torch.is_grad_enabled()
            and any(p.requires_grad for p in ssm.parameters()))


def _refuse_backward_hole(ssm: SSM, cfg: SMCConfig) -> None:
    """Raise NotImplementedError before any launch where `backward_hole`."""
    if backward_hole(ssm, cfg):
        raise NotImplementedError(
            f"training at K={cfg.n_particles} has no CUDA kernel yet: the resample's backward "
            f"(K11, ops.resample_gather.segment_sum_scatter) holds K up to "
            f"{resample_gather.MAX_K}, and above it with K % 128 == 0 the reference runs "
            "kernels the port has not (ROADMAP queue 2 B); serve at this K, or train on CPU "
            "tensors")


def smoothing_route(port_class: bool, reference: str, cuda: bool) -> str:
    """The dispatch of a smoothing sweep (SVO's q_b sweep, FFBSi): "kernel"
    where the port's kernel class takes it (K12/K13, K5/K6 on CUDA tensors,
    their plain versions on CPU tensors), even where the reference runs its
    plain code; else "eager", the counterpart of the reference's plain code
    as tensor ops, on CPU tensors always and on CUDA tensors where the
    reference runs that code (`reference` "plain"); else "raise": the
    reference runs a kernel whose class the port has not widened to."""
    if port_class:
        return "kernel"
    if reference == "plain" or not cuda:
        return "eager"
    return "raise"


def forward_filter(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    *,
    cache: bool = False,
    encoder_inputs=None,
    noise: Optional[tuple] = None,
    controls=None,
) -> FilterResult:
    """Run the forward SMC pass on observations ys [B, T, Dy].

    encoder_inputs optionally replaces what the encoder proposal q2 sees.
    controls [B, T, Di] are the exogenous inputs of a di > 0 model: step t
    consumes controls[:, t] (zeros when None; ignored when di = 0).
    noise is the testing hook of the reference: (eps0 [B,Dx,K], eps_scan
    [T−1,B,Dx,K], u_scan [T−1,B,K]) replacing the generator's draws. On CPU
    tensors it forces the plain step body, as in the reference; on CUDA
    tensors the draws are replayed through the kernels of the path.
    Dispatch (the module docstring): the whole-scan class, the trunk class,
    then the plain loop, on CUDA tensors only where `reference_path` says
    "scan".

    Under the active mesh (`parallel.context`) ys, encoder_inputs and
    controls are this rank's rows, and `noise` the global draws, of which
    each rank takes its share, as it does of the generator's draws. A data
    mesh (particle axis 1) runs the same dispatch on its rows. A particle
    mesh runs the plain loop on its K / P particles, with the sharded
    resampling island (`ops.sharded_resampling`, K7/K8 per shard on the
    card, K11 in the backward) and every reduction over K through
    `parallel.collectives`, as the reference's mesh route
    (`psvo_tpu/smc.py:113-134`); its trunk kernel is off there too.
    """
    batch, t_steps, _ = ys.shape
    cfg = _mesh_cfg(cfg)
    if noise is not None and context.get_mesh() is not None:
        noise = _local_noise(noise)
    route = filter_route(ssm, cfg, t_steps, ys.is_cuda)
    if route == "raise":
        raise NotImplementedError(
            f"this configuration has no CUDA kernel yet: the reference runs it through its "
            f"{_REFERENCE_KERNELS[reference_path(ssm, cfg)]}, whose class the port's kernels do "
            f"not cover for it ({_raise_reason(ssm, cfg)}; ROADMAP queue 2 B); run it on CPU "
            "tensors"
        )
    if ys.is_cuda and route != "fused":
        _refuse_backward_hole(ssm, cfg)
    path = {"fused": _forward_filter_fused, "trunk": _forward_filter_trunk}.get(route)
    if path is not None and (ys.is_cuda or noise is None):
        return path(ssm, generator, ys, cfg, cache=cache, encoder_inputs=encoder_inputs,
                    streams=noise if ys.is_cuda else None, controls=controls)

    k = cfg.n_particles
    ys_tm = ys.transpose(0, 1)  # [T, B, Dy]
    enc_tm = encoder_inputs.transpose(0, 1) if encoder_inputs is not None else ys_tm
    q2 = _q2_tm(ssm, cfg, enc_tm)
    ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di, ys.device)
    if noise is not None:
        eps0, eps_scan, u_scan = noise
    else:
        eps0, eps_scan, u_scan = _draw_noise(generator, cfg, t_steps, batch, ssm.dx)

    x0, alpha0 = _init_t0(ssm, eps0, ys_tm[0], enc_tm[0])
    lse0 = _lse(alpha0)
    ell0 = lse0 - math.log(k)

    body = _make_step_body(ssm, cfg, remat=cfg.remat)
    carry = (x0, alpha0)
    xs, logws, ells, esss, fmeans, scores = [x0], [alpha0], [ell0], [], [], []
    for t in range(1, t_steps):
        q2_t = (q2[0][t], q2[1][t]) if q2 is not None else None
        carry, (ell, ess, fmean, score) = body(
            carry, (ys_tm[t], q2_t, ctrl_tm[t], eps_scan[t - 1], u_scan[t - 1]))
        if cache:
            xs.append(carry[0])
            logws.append(carry[1])
        ells.append(ell)
        esss.append(ess)
        fmeans.append(fmean)
        scores.append(score)

    increments = torch.stack(ells)
    fmean0 = collectives.weighted_mean(alpha0, x0, lse=lse0)
    return FilterResult(
        log_z=torch.sum(increments, dim=0),
        increments=increments,
        ess=torch.stack([collectives.effective_sample_size(alpha0), *esss]),
        x_last=carry[0],
        logw_last=carry[1],
        xs=torch.stack(xs) if cache else None,
        logws=torch.stack(logws) if cache else None,
        filtered_means=torch.stack([fmean0, *fmeans]),
        score_surrogate=(None if cfg.use_stop_gradient
                         else _score_surrogate(increments[1:],
                                               torch.stack(scores) if scores else increments[1:])),
    )


# ---------------------------------------------------------------------------
# Segmented filtering: the long-T path
#
# FFBSi needs the whole forward history, O(T·B·K·Dx). The segmented forward
# keeps only the carries entering each of S segments; `recompute_segment`
# replays a segment from its carry, on the same noise and through the same
# code, bit for bit, just before the backward sweep consumes it.
# ---------------------------------------------------------------------------


@dataclass
class SegmentedCache:
    """What replays any forward segment bit for bit (the reference's
    `smc.SegmentedCache`): the carries entering each segment and the
    segment's own function, which holds its noise (a seed per segment, or
    the slices of given streams) and, on the kernel path, its rows of the
    coefficient tensor."""

    x0: torch.Tensor  # [B, Dx, K] initial particles
    alpha0: torch.Tensor  # [B, K] t = 0 log-weights
    seg_x: list  # S x [B, Dx, K], the carry entering each segment
    seg_logw: list  # S x [B, K]
    seg_len: int  # L = (T − 1) / S steps a segment
    fused: bool  # the kernel path (K1/K4 per segment) or the plain step body
    segment: object  # segment(s, x, logw, cache) -> (x_last, logw_last, stats, xs, logws)


def _segment_seeds(generator, n_segments: int, kernel_rng: bool):
    """One seed per segment from the run's generator, in one draw: K1's
    two-word seed under kernel_rng (its Philox counter restarts at t = 0 in
    every launch, so segments sharing one seed would repeat segment 0's
    noise), else the seed of a fresh `torch.Generator` for the segment's
    streams (drawn inside the segment's function, so a checkpoint's replay
    draws them again; checkpointing restores only the default generators)."""
    dev = generator.device
    if kernel_rng:
        words = torch.randint(0, 2**32, (n_segments, 2), generator=generator, device=dev)
        return [tuple(int(v) for v in row) for row in words.tolist()]
    return torch.randint(0, 2**62, (n_segments,), generator=generator, device=dev).tolist()


def _segment_streams(cfg: SMCConfig, seed, seg_len: int, batch: int, dx: int, device):
    """A segment's (eps [L, B, Dx, K], u [L, B, K]) from its seed, drawn as
    `_draw_noise` draws the whole run's (the reference's
    `_segment_randomness`), this rank's share under a mesh."""
    k, rows = cfg.n_particles, context.global_rows(batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((seg_len, rows, dx, k), generator=gen, device=device)
    if cfg.resampling != "none":
        u = resampling.bulk_positions(gen, seg_len, rows, k, cfg.resampling)
    else:
        u = torch.zeros((seg_len, rows, 1), device=device)
    return (context.local_draw(eps, 1, True), context.local_draw(u, 1, u.shape[-1] > 1))


def _checkpointed(remat: bool, fn, *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant) when remat
    asks for it and autograd records: only the inputs persist, and the
    backward runs fn again. fn draws its noise from explicit generators, so
    the default generators' states need not be kept."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return fn(*args)


def _segmented_result(ell0, alpha0, x0, stats, x_last, logw_last) -> FilterResult:
    """The FilterResult of a segmented forward from its per-segment stats
    [T−1, B, 2 + Dx] (ℓ, ESS, filtered mean); no particle cache."""
    increments = torch.cat([ell0[None], stats[:, :, 0]], dim=0)
    fmean0 = collectives.weighted_mean(alpha0, x0)
    return FilterResult(
        log_z=torch.sum(increments, dim=0),
        increments=increments,
        ess=torch.cat([collectives.effective_sample_size(alpha0)[None], stats[:, :, 1]], dim=0),
        x_last=x_last,
        logw_last=logw_last,
        filtered_means=torch.cat([fmean0[None], stats[:, :, 2:]], dim=0),
    )


def _run_segments(cfg: SMCConfig, segment, x0, alpha0, n_segments: int):
    """Chain the segments from (x0, α0), each under `_checkpointed`. Returns
    (seg_x, seg_logw, stats [T−1, B, 2 + Dx], x_last, logw_last)."""
    x, logw = x0, alpha0
    seg_x, seg_logw, stats = [], [], []
    for s in range(n_segments):
        seg_x.append(x)
        seg_logw.append(logw)
        x, logw, st = _checkpointed(cfg.remat,
                                    lambda x_, lw_, s=s: segment(s, x_, lw_, False)[:3], x, logw)
        stats.append(st)
    return seg_x, seg_logw, torch.cat(stats, dim=0), x, logw


def _forward_filter_segmented_fused(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    n_segments: int,
    *,
    encoder_inputs=None,
    streams: Optional[tuple] = None,
    controls=None,
) -> tuple[FilterResult, SegmentedCache]:
    """The segmented forward of the whole-scan class: `_fused_preamble` for
    all T (t = 0 and the K-independent coefficient rows), then each segment
    one `fused_step.ScanForward` (K1, and K4 in the backward) from the
    segment's carry over its L rows of `coef`, under `_checkpointed`. What
    persists is the boundary carries, `coef` and the seeds: the kernel's
    O(L·B·K) residuals and the segment's streams live one segment at a time.

    Noise: `streams` = (eps0, eps_scan, u_scan) replays given draws, each
    segment its slice; otherwise eps0 comes from `generator`, then one seed
    per segment (`_segment_seeds`: K1's own under cfg.kernel_rng with
    systematic resampling, else the seed of the segment's streams, whose
    positions follow cfg.resampling).
    """
    batch, t_steps, _ = ys.shape
    dx = ssm.dx
    seg_len = (t_steps - 1) // n_segments
    kernel_rng = cfg.kernel_rng and streams is None and cfg.resampling == "systematic"
    consts, coef, x0, alpha0, _, _, _ = _fused_preamble(
        ssm, generator, ys, cfg, encoder_inputs, streams, controls, segmented=True
    )
    seeds = None if streams is not None else _segment_seeds(generator, n_segments, kernel_rng)
    x0, alpha0 = x0.contiguous(), alpha0.contiguous()
    packed, sconst = consts["packed"], consts["sconst"]

    def segment(s, x, logw, cache):
        rows = slice(s * seg_len, (s + 1) * seg_len)
        eps = pos = seed = None
        if streams is not None:
            eps, pos = streams[1][rows], streams[2][rows]
        elif kernel_rng:
            seed = seeds[s]
        else:
            eps, pos = _segment_streams(cfg, seeds[s], seg_len, batch, dx, x.device)
        if torch.is_grad_enabled():
            outs = fused_step.ScanForward.apply(x, logw, coef[rows], packed, sconst, consts, eps,
                                                pos, seed, cache)
        else:
            outs = fused_step.scan_forward(x, logw, coef[rows], consts, eps=eps, positions=pos,
                                           seed=seed, cache=cache)
        return (*outs[:3], *(outs[3:5] if cache else (None, None)))

    seg_x, seg_logw, stats, x_last, logw_last = _run_segments(cfg, segment, x0, alpha0,
                                                              n_segments)
    ell0 = _lse(alpha0) - math.log(cfg.n_particles)
    result = _segmented_result(ell0, alpha0, x0, stats, x_last, logw_last)
    return result, SegmentedCache(x0, alpha0, seg_x, seg_logw, seg_len, True, segment)


def _forward_filter_segmented_plain(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    n_segments: int,
    *,
    encoder_inputs=None,
    streams: Optional[tuple] = None,
    controls=None,
) -> tuple[FilterResult, SegmentedCache]:
    """The segmented forward of the plain step body, the reference's
    `forward_filter_segmented` outside its fused class: each segment runs
    `_make_step_body` from its carry, under `_checkpointed`; on CUDA tensors
    its resampling runs K7/K8 (K11 in the backward) and its draws come from
    the card's generator. Noise as in `_forward_filter_segmented_fused`
    without the kernel's own seed."""
    batch, t_steps, _ = ys.shape
    k, dx = cfg.n_particles, ssm.dx
    seg_len = (t_steps - 1) // n_segments
    ys_tm = ys.transpose(0, 1)
    enc_tm = encoder_inputs.transpose(0, 1) if encoder_inputs is not None else ys_tm
    q2 = _q2_tm(ssm, cfg, enc_tm)
    ctrl_tm = _controls_tm(controls, batch, t_steps, ssm.di, ys.device)
    if streams is not None:
        eps0, seeds = streams[0], None
    else:
        eps0 = _draw_eps0(generator, batch, dx, k)
        seeds = _segment_seeds(generator, n_segments, False)
    x0, alpha0 = _init_t0(ssm, eps0, ys_tm[0], enc_tm[0])
    body = _make_step_body(ssm, cfg)

    def segment(s, x, logw, cache):
        rows = slice(s * seg_len, (s + 1) * seg_len)
        if streams is not None:
            eps, u = streams[1][rows], streams[2][rows]
        else:
            eps, u = _segment_streams(cfg, seeds[s], seg_len, batch, dx, x.device)
        carry, stats, xs, logws = (x, logw), [], [], []
        for j in range(seg_len):
            t = 1 + s * seg_len + j
            q2_t = (q2[0][t], q2[1][t]) if q2 is not None else None
            carry, (ell, ess, fmean, _) = body(carry, (ys_tm[t], q2_t, ctrl_tm[t], eps[j], u[j]))
            stats.append(torch.cat([ell[:, None], ess[:, None], fmean], dim=-1))
            xs.append(carry[0])
            logws.append(carry[1])
        if not cache:
            return (*carry, torch.stack(stats), None, None)
        return (*carry, torch.stack(stats), torch.stack(xs), torch.stack(logws))

    seg_x, seg_logw, stats, x_last, logw_last = _run_segments(cfg, segment, x0, alpha0,
                                                              n_segments)
    ell0 = _lse(alpha0) - math.log(k)
    result = _segmented_result(ell0, alpha0, x0, stats, x_last, logw_last)
    return result, SegmentedCache(x0, alpha0, seg_x, seg_logw, seg_len, False, segment)


def forward_filter_segmented(
    ssm: SSM,
    generator: Optional[torch.Generator],
    ys,
    cfg: SMCConfig,
    n_segments: int,
    *,
    encoder_inputs=None,
    noise: Optional[tuple] = None,
    controls=None,
) -> tuple[FilterResult, SegmentedCache]:
    """Forward pass that keeps the carries at S = n_segments segment
    boundaries instead of the per-step cache; requires (T − 1) % S == 0.
    Returns (FilterResult without xs/logws, SegmentedCache).

    As the reference (`psvo_tpu/smc.py:818-870`): with `fused_step.SCAN_FUSED`
    on, the whole-scan class runs K1 per segment
    (`_forward_filter_segmented_fused`; their plain versions on CPU tensors);
    everything else runs the plain step body per segment
    (`_forward_filter_segmented_plain`), which on CUDA tensors resamples
    through K7/K8 (K11 in the backward), as the unsegmented plain loop does;
    the reference has no per-step kernel route for segments. A CUDA tensor
    that the reference sends to its whole-step kernel but the port's K1
    class does not take (`filter_route` "raise"; ROADMAP queue 2 B) raises
    before any launch. CPU tensors with the noise hook run the plain step
    body.
    noise = (eps0, eps_scan, u_scan) over all T replaces the draws. Under
    the active mesh as `forward_filter`: a particle mesh runs the plain body
    per segment, with the sharded island.
    """
    batch, t_steps, _ = ys.shape
    if (t_steps - 1) % n_segments:
        raise ValueError(f"T-1={t_steps - 1} not divisible by {n_segments} segments")
    cfg = _mesh_cfg(cfg)
    if noise is not None and context.get_mesh() is not None:
        noise = _local_noise(noise)
    route = filter_route(ssm, cfg, t_steps, ys.is_cuda, segmented=True)
    if route == "raise":
        raise NotImplementedError(
            "this configuration has no CUDA kernel yet: the reference runs its segments "
            "through its whole-step kernel (pallas_step), whose class the port's K1 does not "
            f"cover for it ({_raise_reason(ssm, cfg)}; ROADMAP queue 2 B); run it on CPU "
            "tensors"
        )
    if ys.is_cuda and route != "fused":
        _refuse_backward_hole(ssm, cfg)
    kw = dict(encoder_inputs=encoder_inputs, streams=noise, controls=controls)
    if route == "fused" and (ys.is_cuda or noise is None):
        return _forward_filter_segmented_fused(ssm, generator, ys, cfg, n_segments, **kw)
    return _forward_filter_segmented_plain(ssm, generator, ys, cfg, n_segments, **kw)


def recompute_segment(cache: SegmentedCache, s: int):
    """Re-run forward segment s from its stored carry, through the code that
    ran it (K1 with its cache on the kernel path) on the same noise. Returns
    (xs [L, B, Dx, K], logws [L, B, K]), the filter's cache at t = 1 + s·L …
    s·L + L, bit for bit the forward's. Differentiable; the caller
    checkpoints it (the objective checkpoints each segment's replay together
    with its sweep)."""
    out = cache.segment(s, cache.seg_x[s], cache.seg_logw[s], True)
    return out[3], out[4]
