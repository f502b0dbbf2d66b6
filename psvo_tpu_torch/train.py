"""Training and evaluation (counterpart of `psvo_tpu/train.py`).

The optimizer (`make_optimizer`: zero_nans → global-norm clip → Adam, with
non-finite updates skipped, optax's semantics written out in tensor ops),
the train step (`make_train_step`), and the test ELBO and k-step-ahead
prediction R² of the reference's evaluation. The Trainer (epochs,
checkpoints, early stopping) and the step's `debug_checks` wait for their
slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Union

import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.distributions import log_normalize
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float) -> Callable:
    """optax.cosine_decay_schedule: count -> init·((1 − α)·½(1 + cos(π·min(count,
    decay_steps)/decay_steps)) + α), in float32 on the count's device."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule: decay_steps={decay_steps} must be positive")

    def schedule(count):
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ ||t||²) over a list of tensors (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclass
class OptState:
    mu: list  # Adam's first moments, one per parameter
    nu: list  # Adam's second moments
    count: torch.Tensor  # int32 []: updates applied (Adam's and the schedule's count)
    notfinite_count: torch.Tensor  # int32 []: consecutive steps with non-finite gradients


class Optimizer:
    """optax.apply_if_finite(chain(zero_nans(), clip_by_global_norm(clip_norm),
    adam(lr)), max_consecutive_errors=100), on a list of parameters in place.

    - A step whose raw gradients hold a NaN or an inf is skipped: the
      parameters, the moments and the count stay as they were, unless more
      than 100 steps in a row were non-finite.
    - NaNs are then zeroed, and the gradients scaled by clip_norm/norm only
      when norm >= clip_norm (no epsilon, unlike clip_grad_norm_).
    - Adam with b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0, bias-corrected;
      lr a float or a schedule of the count.
    Every branch is a `torch.where` on device values: a step never waits on
    the host. torch.optim.Adam cannot skip a step and keep its state.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8
    max_consecutive_errors = 100

    def __init__(self, lr: Union[float, Callable], clip_norm: float):
        self.lr = lr
        self.clip_norm = clip_norm

    def init(self, params) -> OptState:
        dev = params[0].device
        return OptState(
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            count=torch.zeros((), dtype=torch.int32, device=dev),
            notfinite_count=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @torch.no_grad()
    def update(self, params, grads, state: OptState) -> None:
        """Apply one step to `params` (in place) from the raw `grads`."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                state.notfinite_count + 1)
        apply = finite | (notfinite > self.max_consecutive_errors)
        g = [torch.where(torch.isnan(x), torch.zeros_like(x), x) for x in grads]
        norm = global_norm(g)
        keep = norm < self.clip_norm
        g = [torch.where(keep, x, (x / norm) * self.clip_norm) for x in g]
        count = state.count + 1
        bc1 = 1 - self.b1 ** count.to(torch.float32)
        bc2 = 1 - self.b2 ** count.to(torch.float32)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        for p, x, mu, nu in zip(params, g, state.mu, state.nu):
            mu_new = (1 - self.b1) * x + self.b1 * mu
            nu_new = (1 - self.b2) * (x * x) + self.b2 * nu
            step = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps) * -lr
            p.copy_(torch.where(apply, p + step, p))
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
        state.count = torch.where(apply, count, state.count)
        state.notfinite_count = notfinite


def make_optimizer(cfg: Config) -> Optimizer:
    """The reference's optimizer (`psvo_tpu.train.make_optimizer`): constant lr
    or the cosine schedule to 0.1·lr over n_steps, clip at clip_norm, and up
    to 100 consecutive non-finite steps skipped."""
    t = cfg.train
    lr = t.lr
    if t.lr_schedule == "cosine":
        lr = cosine_decay_schedule(t.lr, max(t.n_steps, 1), alpha=0.1)
    return Optimizer(lr, t.clip_norm)


def make_train_step(ssm: SSM, cfg: Config, optimizer: Optimizer) -> Callable:
    """train_step(generator, batch, encoder_inputs=None, noise=None,
    controls=None) -> metrics.

    One optimizer step on the objective's loss, updating ssm's parameters in
    place; each parameter's `.grad` keeps that step's raw gradient. With
    cfg.train.steps_per_call = N > 1, batch is [N, B, T, Dy] (encoder_inputs
    likewise, noise a sequence of N noise tuples) and the N steps run in
    order on the same generator, so N steps in one call equal N single
    calls; the metrics are the last step's. controls [B, T, Di] (with N > 1
    [N, B, T, Di]) are a di > 0 model's exogenous inputs. Metrics: the objective's, plus
    `loss` and `grad_norm` (the global norm of the raw gradients). The
    optimizer state is `train_step.opt_state`.
    """
    if cfg.train.debug_checks:
        raise NotImplementedError("train.debug_checks (checkify float checks) is not ported yet")
    objective = make_objective(ssm, cfg)
    params = list(ssm.parameters())
    opt_state = optimizer.init(params)
    n_per_call = max(int(cfg.train.steps_per_call), 1)

    def one_step(generator, ys, encoder_inputs, noise, controls):
        for p in params:
            p.grad = None
        out = objective(generator, ys, encoder_inputs, noise, controls)
        out.loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        optimizer.update(params, grads, opt_state)
        metrics = {name: v.detach() for name, v in out.metrics.items()}
        metrics["loss"] = out.loss.detach()
        metrics["grad_norm"] = global_norm(grads)
        return metrics

    def train_step(generator, batch, encoder_inputs=None, noise=None, controls=None):
        if n_per_call == 1:
            return one_step(generator, batch, encoder_inputs, noise, controls)
        if batch.shape[0] != n_per_call:
            raise ValueError(f"steps_per_call={n_per_call}: batch {tuple(batch.shape)} "
                             f"must be [{n_per_call}, B, T, Dy]")
        for i in range(n_per_call):
            metrics = one_step(
                generator, batch[i],
                None if encoder_inputs is None else encoder_inputs[i],
                None if noise is None else noise[i],
                None if controls is None else controls[i],
            )
        return metrics

    train_step.opt_state = opt_state
    return train_step


def filtered_means(fwd):
    """Posterior filtering means [B, T, Dx] (from the filter's own output, or
    from the particle cache of a hand-built FilterResult)."""
    if fwd.filtered_means is not None:
        return fwd.filtered_means.transpose(0, 1)
    logw_norm, _ = log_normalize(fwd.logws, dim=-1)  # [T, B, K]
    means = torch.einsum("tbk,tbdk->tbd", torch.exp(logw_norm), fwd.xs)
    return means.transpose(0, 1)


def k_step_predictions(ssm: SSM, filt_means, k_max: int, controls=None):
    """Roll the mean dynamics k steps from each filtered mean and emit.

    Returns ŷ [k_max, B, T, Dy]: ŷ[k-1, :, t] predicts y_{t+k} (valid for
    t + k < T; the caller masks). With controls [B, T, Di] (di > 0), rollout
    step j from time t consumes the known future control u_{t+j} (zeros past
    the horizon, masked anyway); a di > 0 model without them rolls on zeros."""
    preds = []
    x = filt_means
    for j in range(1, k_max + 1):
        u = None
        if ssm.di and controls is not None:
            u = torch.nn.functional.pad(controls[:, j:], (0, 0, 0, j))
        x = ssm.transition_mean(x, u)
        preds.append(ssm.emission_mean(x))
    return torch.stack(preds)


def make_eval_step(ssm: SSM, cfg: Config) -> Callable:
    """eval_step(generator, ys, encoder_inputs=None, noise=None, controls=None)
    -> metrics: the objective's metrics plus elbo, mse_k and r2_k [k_max].
    controls [B, T, Di] feed the filter and the k-step rollouts."""
    objective = make_objective(ssm, cfg)
    k_max = cfg.train.mse_k_steps

    @torch.no_grad()
    def eval_step(generator, ys, encoder_inputs=None, noise=None, controls=None):
        out = objective(generator, ys, encoder_inputs, noise, controls)
        fm = filtered_means(out.filter_result)  # [B, T, Dx]
        # horizons beyond the trajectory have no targets
        k_max_eff = min(k_max, ys.shape[1] - 1)
        preds = k_step_predictions(ssm, fm, k_max_eff, controls)
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
