"""Posterior inference on a trained model (counterpart of `psvo_tpu/infer.py`).

`filter_posterior` serves filtering means (and optionally the particle
cloud) for observations [B, T, Dy]. `smooth_posterior` waits for the
smoothing objectives.
"""

from __future__ import annotations

from typing import Optional

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.smc import forward_filter
from psvo_tpu_torch.train import filtered_means
from psvo_tpu_torch.utils.rng import run_generator


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
):
    """Filtering posterior: means [B, T, Dx]; with return_particles also the
    particles [B, T, K, Dx] and log-weights [B, T, K].

    Uses the config's particle count and resampling scheme; the generator
    defaults to the run's (seed + 17, on the device of ys). noise is the
    filter's replay hook (smc.forward_filter).
    """
    if generator is None:
        generator = run_generator(cfg, 17, device=ys.device)
    fwd = forward_filter(
        ssm, generator, ys, cfg.smc, cache=return_particles,
        encoder_inputs=encoder_inputs, noise=noise,
    )
    means = filtered_means(fwd)
    if return_particles:
        return means, fwd.xs.permute(1, 0, 3, 2), fwd.logws.transpose(0, 1)
    return means
