"""Evaluation (counterpart of `psvo_tpu/train.py`, the serving half).

The test ELBO and the k-step-ahead prediction R² of the reference's
evaluation. The optimizer, the train step and the Trainer come with the
backward kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.distributions import log_normalize
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective


def filtered_means(fwd):
    """Posterior filtering means [B, T, Dx] (from the filter's own output, or
    from the particle cache of a hand-built FilterResult)."""
    if fwd.filtered_means is not None:
        return fwd.filtered_means.transpose(0, 1)
    logw_norm, _ = log_normalize(fwd.logws, dim=-1)  # [T, B, K]
    means = torch.einsum("tbk,tbdk->tbd", torch.exp(logw_norm), fwd.xs)
    return means.transpose(0, 1)


def k_step_predictions(ssm: SSM, filt_means, k_max: int):
    """Roll the mean dynamics k steps from each filtered mean and emit.

    Returns ŷ [k_max, B, T, Dy]: ŷ[k-1, :, t] predicts y_{t+k} (valid for
    t + k < T; the caller masks)."""
    preds = []
    x = filt_means
    for _ in range(k_max):
        x = ssm.transition_mean(x)
        preds.append(ssm.emission_mean(x))
    return torch.stack(preds)


def make_eval_step(ssm: SSM, cfg: Config) -> Callable:
    """eval_step(generator, ys, encoder_inputs=None, noise=None) -> metrics:
    the objective's metrics plus elbo, mse_k and r2_k [k_max]."""
    objective = make_objective(ssm, cfg)
    k_max = cfg.train.mse_k_steps

    @torch.no_grad()
    def eval_step(generator, ys, encoder_inputs=None, noise=None):
        out = objective(generator, ys, encoder_inputs, noise)
        fm = filtered_means(out.filter_result)  # [B, T, Dx]
        # horizons beyond the trajectory have no targets
        k_max_eff = min(k_max, ys.shape[1] - 1)
        preds = k_step_predictions(ssm, fm, k_max_eff)
        t_steps = ys.shape[1]
        var_y = torch.var(ys, dim=(0, 1), unbiased=False).mean()
        mse = torch.stack(
            [
                torch.mean((preds[k - 1, :, : t_steps - k] - ys[:, k:]) ** 2)
                for k in range(1, k_max_eff + 1)
            ]
        )
        metrics = dict(out.metrics)
        metrics["elbo"] = torch.mean(out.elbo)
        metrics["mse_k"] = mse
        metrics["r2_k"] = 1.0 - mse / var_y
        return metrics

    return eval_step
