"""Variational SMC objectives (counterpart of `psvo_tpu/objectives.py`).

Ported: the IWAE/FIVO branch of `make_objective`, forward only —
IWAE log Ẑ = lse_k(Σ_t α_t) − log K without resampling, FIVO with per-step
resampling. SVO and PSVO (the smoothing objectives) wait for their slices.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.smc import FilterResult, forward_filter


@dataclass
class ObjectiveOutput:
    loss: torch.Tensor  # scalar, to minimize
    elbo: torch.Tensor  # [B] per-trajectory bound
    metrics: dict  # scalars for logging
    filter_result: Optional[FilterResult] = None


def make_objective(ssm: SSM, cfg: Config):
    """Return objective(generator, ys, encoder_inputs=None, noise=None)."""
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
    if smc_cfg.objective not in ("iwae", "fivo"):
        raise NotImplementedError(f"objective={smc_cfg.objective!r} is not ported yet")

    def objective(generator, ys, encoder_inputs=None, noise=None) -> ObjectiveOutput:
        fwd = forward_filter(
            ssm, generator, ys, smc_cfg, encoder_inputs=encoder_inputs, noise=noise
        )
        metrics = {
            "log_z_fwd": torch.mean(fwd.log_z),
            "ess_mean": torch.mean(fwd.ess),
            "ess_min": torch.min(fwd.ess),
        }
        elbo = fwd.log_z
        return ObjectiveOutput(-torch.mean(elbo), elbo, metrics, filter_result=fwd)

    return objective
