"""Posterior inference on a trained model (counterpart of `psvo_tpu/infer.py`).

`filter_posterior` serves filtering means (and optionally the particle
cloud) and `smooth_posterior` smoothed trajectories, by FFBSi or by SVO's
learned backward proposal, for observations [B, T, Dy]. A model with
controls (data.di > 0) needs its exogenous inputs, controls=[B, T, Di];
both refuse a call that leaves them out, or passes them to a di = 0 model.

Under an active mesh (`parallel.context`) both take the global batch, as
the reference's callers pass it, run each rank's rows (`train.local_rows`)
and return global arrays, the ranks' rows gathered over the data axis
(`collectives.gather_rows`); `noise` is the global draws, as for
`smc.forward_filter`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import _controls_kw, make_objective
from psvo_tpu_torch.parallel import collectives, context
from psvo_tpu_torch.smc import forward_filter
from psvo_tpu_torch.train import filtered_means, local_rows
from psvo_tpu_torch.utils.rng import run_generator


def _check_controls(ssm: SSM, controls) -> None:
    """A di > 0 model inferred without its controls would silently run zeros
    through q1 and f: a wrong posterior with no error. Refuse instead, and
    refuse controls that a di = 0 model would never read."""
    if ssm.di and controls is None:
        raise ValueError(
            f"model conditions on di={ssm.di} control inputs; pass "
            "controls=[B, T, di] (the same exogenous inputs used in training)"
        )
    if not ssm.di and controls is not None:
        raise ValueError("model has di=0: controls were passed but never used")


def _local(*tensors):
    """The active mesh's rows of global [B, ...] tensors (all of them without one)."""
    mesh = context.get_mesh()
    return tensors if mesh is None else local_rows(mesh, *tensors)


def _gathered(*tensors):
    """Each rank's rows gathered over the data axis into the global batch
    (each tensor itself without a mesh)."""
    out = tuple(collectives.gather_rows(t) for t in tensors)
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def filter_posterior(
    ssm: SSM,
    ys,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    *,
    return_particles: bool = False,
    encoder_inputs=None,
    noise: Optional[tuple] = None,
    controls=None,
):
    """Filtering posterior: means [B, T, Dx]; with return_particles also the
    particles [B, T, K, Dx] and log-weights [B, T, K].

    Uses the config's particle count and resampling scheme; the generator
    defaults to the run's (seed + 17, on the device of ys). noise is the
    filter's replay hook (smc.forward_filter). controls [B, T, Di] are
    required when the model has di > 0, and refused when it has none. Under
    a mesh every argument is global and so is the result (the module
    docstring); on a particle mesh the particles and log-weights are this
    rank's K / P particles.
    """
    _check_controls(ssm, controls)
    if generator is None:
        generator = run_generator(cfg, 17, device=ys.device)
    ys, encoder_inputs, controls = _local(ys, encoder_inputs, controls)
    fwd = forward_filter(
        ssm, generator, ys, cfg.smc, cache=return_particles,
        encoder_inputs=encoder_inputs, noise=noise, **_controls_kw(controls),
    )
    means = filtered_means(fwd)
    if return_particles:
        return _gathered(means, fwd.xs.permute(1, 0, 3, 2), fwd.logws.transpose(0, 1))
    return _gathered(means)


@torch.no_grad()
def smooth_posterior(
    ssm: SSM,
    ys,
    cfg: Config,
    generator: Optional[torch.Generator] = None,
    *,
    n_samples: Optional[int] = None,
    method: Optional[str] = None,
    encoder_inputs=None,
    noise: Optional[tuple] = None,
    controls=None,
):
    """Smoothed posterior trajectories [B, M, T, Dx]: FFBSi over the forward
    support ("psvo", for any fitted model) or the learned backward proposal
    q_b ("svo", for a model trained with it), with M = n_samples or the
    config's smoothing-particle count. method defaults to the config's
    objective when that is a smoothing one, else "psvo". The generator
    defaults to the run's (seed + 18, on the device of ys); noise is the
    objective's replay hook (`objectives.make_objective`). controls as in
    `filter_posterior`: both methods take them (FFBSi's support terms and
    log-joint, SVO's f and predictive mixture see u_{t+1}). Under a mesh
    every argument is global and so is the result (the module docstring).
    """
    _check_controls(ssm, controls)
    method = method or (cfg.smc.objective if cfg.smc.objective in ("svo", "psvo") else "psvo")
    if generator is None:
        generator = run_generator(cfg, 18, device=ys.device)
    m = n_samples or cfg.smc.n_smoothing_particles
    run_cfg = dataclasses.replace(
        cfg, smc=dataclasses.replace(cfg.smc, objective=method, n_smoothing_particles=m)
    )
    ys, encoder_inputs, controls = _local(ys, encoder_inputs, controls)
    out = make_objective(ssm, run_cfg)(generator, ys, encoder_inputs, noise, controls)
    return _gathered(out.smoothed.permute(1, 2, 0, 3))  # [T, B, M, Dx] -> [B, M, T, Dx]
