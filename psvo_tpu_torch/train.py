"""Training and evaluation (counterpart of `psvo_tpu/train.py`).

The optimizer (`make_optimizer`: zero_nans → global-norm clip → Adam, with
non-finite updates skipped, optax's semantics written out in tensor ops),
the train step (`make_train_step`), and the test ELBO and k-step-ahead
prediction R² of the reference's evaluation, and the Trainer around them
(`TrainState`, `Trainer`: minibatches drawn as the reference draws them,
the eval cadence, early stopping, keep_best, checkpoints, metrics and a
profiler window). With `train.debug_checks` the step checks every tensor
it makes for finite values and names the first that is not.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.distributions import log_normalize
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective
from psvo_tpu_torch.parallel import collectives, context
from psvo_tpu_torch.utils.rng import run_generator


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


def _first_nonfinite(named) -> Optional[str]:
    """The name of the first tensor of (name, tensor) pairs holding a NaN or
    an inf, else None; one host sync for all of them."""
    named = list(named)
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    return next((name for (name, _), ok in zip(named, finite) if not ok), None)


def _require_finite(named, where: str) -> None:
    name = _first_nonfinite(named)
    if name is not None:
        raise FloatingPointError(f"debug_checks: {name} is not finite {where}")


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
    optimizer state is `train_step.opt_state`; `train_step.single_step`
    takes one step on a [B, T, Dy] batch whatever N is (the Trainer's tail
    chunk, when n_steps is not a multiple of N).

    With cfg.train.debug_checks (debug builds only) each step runs its
    forward and backward under `torch.autograd.detect_anomaly(check_nan=True)`
    and checks, in the order the step makes them, the parameters entering the
    step, the loss, each gradient and each updated parameter for finite
    values: the first that is not raises FloatingPointError naming it (a
    parameter by its `named_parameters()` name), the port's counterpart of
    the reference's checkify float checks; a NaN made inside the backward
    raises it with anomaly mode's report of the function that made it. The
    checks fetch values to the host, so a checked step syncs every time.

    Under the active mesh (`parallel.sharding.make_sharded_train_step`) the
    step takes the global batch (and encoder inputs and controls) and runs on
    this rank's rows; it back-propagates the loss scaled by 1 / (P·D), sums
    the gradients over every rank in one all-reduce (`.grad` then holds the
    sum) and averages the metrics over the data axis (ess_min: their min),
    so every rank takes the same optimizer step and reports the same metrics.
    """
    objective = make_objective(ssm, cfg)
    named = list(ssm.named_parameters())
    params = [p for _, p in named]
    opt_state = optimizer.init(params)
    n_per_call = max(int(cfg.train.steps_per_call), 1)
    debug = cfg.train.debug_checks

    def backward(loss):
        mesh = context.get_mesh()
        if mesh is None:
            loss.backward()
        else:
            (loss / mesh.size).backward()

    def loss_and_grads(generator, ys, encoder_inputs, noise, controls):
        out = objective(generator, ys, encoder_inputs, noise, controls)
        backward(out.loss)
        return out

    def checked_loss_and_grads(generator, ys, encoder_inputs, noise, controls):
        _require_finite(named, "entering the step")
        with torch.autograd.detect_anomaly(check_nan=True):
            out = objective(generator, ys, encoder_inputs, noise, controls)
            _require_finite([("the loss", out.loss.detach())], "after the forward")
            try:
                backward(out.loss)
            except RuntimeError as exc:
                if "nan" not in str(exc).lower():
                    raise
                raise FloatingPointError(f"debug_checks: the backward made a NaN: {exc}") from exc
        _require_finite([(f"the gradient of {name}", p.grad) for name, p in named
                         if p.grad is not None], "after the backward")
        return out

    forward_backward = checked_loss_and_grads if debug else loss_and_grads

    def one_step(generator, ys, encoder_inputs=None, noise=None, controls=None):
        mesh = context.get_mesh()
        if mesh is not None:
            ys, encoder_inputs, controls = local_rows(mesh, ys, encoder_inputs, controls)
        for p in params:
            p.grad = None
        out = forward_backward(generator, ys, encoder_inputs, noise, controls)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if mesh is not None:
            grads = collectives.all_reduce_grads(grads)
            for p, g in zip(params, grads):
                p.grad = g
        optimizer.update(params, grads, opt_state)
        if debug:
            _require_finite(named, "after the update")
        metrics = {name: v.detach() for name, v in out.metrics.items()}
        metrics["loss"] = out.loss.detach()
        if mesh is not None:
            metrics = _data_metrics(metrics)
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
    train_step.single_step = one_step
    return train_step


def local_rows(mesh, *tensors):
    """This rank's rows of global [B, ...] tensors (None stays None)."""
    for t in tensors:
        if t is not None and t.shape[0] % mesh.data:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split over mesh.data="
                             f"{mesh.data}")
    return tuple(None if t is None else mesh.local(t, 0) for t in tensors)


def _data_metrics(metrics: dict) -> dict:
    """Scalar metrics of a data shard -> their mean over the data axis (one
    all-reduce), ess_min's min."""
    names = [n for n, v in metrics.items() if v.dim() == 0 and n != "ess_min"]
    means = collectives.data_mean(torch.stack([metrics[n].float() for n in names]))
    out = dict(metrics, **dict(zip(names, means.unbind(0))))
    if "ess_min" in metrics:
        out["ess_min"] = collectives.data_min(metrics["ess_min"])
    return out


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
    controls [B, T, Di] feed the filter and the k-step rollouts. Under the
    active mesh it takes the global test batch and runs the objective on this
    rank's rows; the metrics are averaged over the data axis, and the
    rollouts run on the gathered filtering means of the whole batch, as on
    one device."""
    objective = make_objective(ssm, cfg)
    k_max = cfg.train.mse_k_steps

    @torch.no_grad()
    def eval_step(generator, ys, encoder_inputs=None, noise=None, controls=None):
        mesh = context.get_mesh()
        if mesh is None:
            out = objective(generator, ys, encoder_inputs, noise, controls)
            fm = filtered_means(out.filter_result)  # [B, T, Dx]
            metrics, elbo = dict(out.metrics), torch.mean(out.elbo)
        else:
            out = objective(generator, *local_rows(mesh, ys, encoder_inputs), noise,
                            *local_rows(mesh, controls))
            fm = collectives.gather_rows(filtered_means(out.filter_result))
            metrics = _data_metrics(dict(out.metrics, elbo=torch.mean(out.elbo)))
            elbo = metrics.pop("elbo")
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
        metrics["elbo"] = elbo
        metrics["mse_k"] = mse
        metrics["r2_k"] = 1.0 - mse / var_y
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

# objective-specific eval metrics kept in the history records when present:
# PSVO's direct smoothing bound and EM log-joint, SVO's backward bound
_EXTRA_METRICS = ("elbo_psvo_direct", "log_joint_smoothed", "elbo_svo")


@dataclass
class TrainState:
    """What a checkpoint saves. The parameters live in `model` (trained in
    place); `opt_state` is the train step's own `OptState`; `generator` feeds
    the train and eval steps in order."""

    model: SSM
    opt_state: OptState
    generator: torch.Generator
    step: int = 0
    best_elbo: float = -math.inf
    evals_since_best: int = 0
    best_params: Optional[dict] = None  # state_dict at the best test ELBO (keep_best)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`. To a card through pinned memory, without
    waiting for the work queued there (a pageable copy would)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _on_device(a, device: torch.device):
    return None if a is None else torch.as_tensor(a).to(device)


class Trainer:
    """The loop around the train and eval steps (`psvo_tpu.train.Trainer`):
    minibatches, the eval cadence, early stopping, keep_best, metric records,
    checkpoints and a profiler window. It runs on the device of the model's
    parameters. Between evals it never waits for the device: the minibatch
    indices go up asynchronously and no train metric is read; each eval
    fetches its record in one copy.

    Under a mesh (`mesh=`, from `parallel.sharding.maybe_mesh`) the train and
    eval steps are the sharded ones. Every rank draws the same minibatches
    from its own copy of the run's generators and steps on its rows; the
    replicas' parameters stay equal. Only rank 0 writes metrics,
    checkpoints and profiles, and prints; a restore reads the checkpoint on
    every rank, then takes rank 0's state (`sharding.place_replicated`)."""

    def __init__(self, cfg: Config, ssm: SSM, *, mesh=None, metrics_writer=None,
                 checkpointer=None, profile_dir=None):
        self.cfg = cfg
        self.ssm = ssm
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0  # the rank that writes and prints
        self.device = next(ssm.parameters()).device
        self.profile_dir = profile_dir if self.main else None  # torch.profiler trace target
        self.optimizer = make_optimizer(cfg)
        if mesh is None:
            self.train_step = make_train_step(ssm, cfg, self.optimizer)
            self.eval_step = make_eval_step(ssm, cfg)
        else:
            from psvo_tpu_torch.parallel import sharding

            self.train_step = sharding.make_sharded_train_step(ssm, cfg, self.optimizer, mesh)
            self.eval_step = sharding.make_sharded_eval_step(ssm, cfg, mesh)
        self.state = TrainState(ssm, self.train_step.opt_state,
                                run_generator(cfg, 1, self.device))
        self.metrics_writer = metrics_writer
        self.checkpointer = checkpointer
        self.history: list[dict] = []

    def restore(self) -> int:
        """Restore the newest checkpoint, if any, into the live state; return
        the step it leaves the run at."""
        if self.checkpointer is not None:
            restored = self.checkpointer.restore(self.state)
            if restored is not None:
                self.state = restored
                if self.mesh is not None:
                    from psvo_tpu_torch.parallel import sharding

                    opt = self.state.opt_state
                    sharding.place_replicated(self.mesh, [
                        *self.ssm.parameters(), *opt.mu, *opt.nu, opt.count,
                        opt.notfinite_count])
        return self.state.step

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {path}", flush=True)

    def run(
        self,
        obs_train,
        obs_test,
        n_steps: Optional[int] = None,
        hidden_train=None,
        hidden_test=None,
        controls_train=None,
        controls_test=None,
    ) -> list[dict]:
        cfg = self.cfg
        dev = self.device
        n_train = obs_train.shape[0]
        bsz = min(cfg.train.batch_size, n_train)
        steps_per_epoch = max(n_train // bsz, 1)
        if n_steps is None:
            # epoch accounting: each epoch one pass over shuffled
            # without-replacement minibatches
            if cfg.train.epochs > 0:
                n_steps = cfg.train.epochs * steps_per_epoch
            else:
                n_steps = cfg.train.n_steps
        obs_train = _on_device(obs_train, dev)
        obs_test = _on_device(obs_test, dev)
        # q_uses_true_x: the encoder proposal sees the true latents
        use_true_x = cfg.smc.q_uses_true_x
        if use_true_x and (hidden_train is None or hidden_test is None):
            raise ValueError("q_uses_true_x=True requires hidden_train/test latents")
        hidden_train = _on_device(hidden_train, dev) if use_true_x else None
        hidden_test = _on_device(hidden_test, dev) if use_true_x else None
        use_controls = self.ssm.di > 0
        if use_controls and (controls_train is None or controls_test is None):
            raise ValueError("data.di > 0 requires controls_train/test")
        controls_train = _on_device(controls_train, dev) if use_controls else None
        controls_test = _on_device(controls_test, dev) if use_controls else None
        # made anew in each run, as the reference's: a resumed run re-draws
        # the first minibatches of the run it continues
        rng = np.random.default_rng(cfg.seed + 2)
        epoch_perm = None

        st = self.state
        gen = st.generator
        t_start = time.perf_counter()
        steps_done_at = st.step
        stop = False
        spc = max(int(cfg.train.steps_per_call), 1)
        if spc > 1:
            # chunked stepping must land exactly on the eval/save boundaries
            for fname, cad in (("eval_every", cfg.train.eval_every),
                               ("save_every", cfg.train.save_every)):
                if cad % spc != 0:
                    raise ValueError(
                        f"train.{fname}={cad} must be a multiple of "
                        f"train.steps_per_call={spc}"
                    )
        profile_window, prof = None, None
        if self.profile_dir:
            # a steady-state window, past the first eval; aligned to chunks
            w0 = cfg.train.eval_every + spc if spc > 1 else cfg.train.eval_every + 1
            profile_window = (w0, w0 + max(10 // spc, 1) * spc)

        def _indices(step):
            nonlocal epoch_perm
            if cfg.train.epochs > 0:
                pos = step % steps_per_epoch
                if pos == 0 or epoch_perm is None:
                    epoch_perm = rng.permutation(n_train)
                return epoch_perm[pos * bsz : (pos + 1) * bsz]
            return rng.choice(n_train, size=bsz, replace=False)

        def _take(a, idx):
            return None if a is None else a[idx]

        while st.step < n_steps and not stop:
            chunk = min(spc, n_steps - st.step)
            if profile_window and st.step + chunk == profile_window[0]:
                prof = self._start_profile()
            idx = _upload(np.stack([_indices(st.step + j) for j in range(chunk)]), dev)
            batch, enc, ctrl = (_take(a, idx) for a in (obs_train, hidden_train, controls_train))
            if spc == 1:
                metrics = self.train_step(gen, batch[0], _take(enc, 0), None, _take(ctrl, 0))
            elif chunk == spc:
                metrics = self.train_step(gen, batch, enc, None, ctrl)
            else:
                # a tail chunk (n_steps not a multiple of N): the train step
                # takes exactly N, so its steps run one at a time, in the same
                # order on the same generator
                for j in range(chunk):
                    metrics = self.train_step.single_step(
                        gen, batch[j], _take(enc, j), None, _take(ctrl, j))
            st.step += chunk
            if prof is not None and st.step == profile_window[1]:
                self._stop_profile(prof)
                prof, profile_window = None, None

            if st.step % cfg.train.eval_every == 0 or st.step == n_steps:
                ev = self.eval_step(gen, obs_test, hidden_test, None, controls_test)
                extras = [k for k in _EXTRA_METRICS if k in ev]
                scalars = [metrics["loss"], metrics.get("log_z_fwd", -metrics["loss"]),
                           ev["elbo"], ev["ess_mean"], metrics["grad_norm"]]
                scalars += [ev[k] for k in extras]
                fetched = torch.cat([torch.stack(scalars).float(),
                                     ev["r2_k"].float()]).tolist()  # waits for the device
                dt = time.perf_counter() - t_start
                steps_s = (st.step - steps_done_at) / max(dt, 1e-9)
                t_start, steps_done_at = time.perf_counter(), st.step
                n_sc = len(scalars)
                r2_k = fetched[n_sc:]
                rec = {
                    "step": st.step,
                    "train_loss": fetched[0],
                    "train_elbo": fetched[1],
                    "test_elbo": fetched[2],
                    "r2_1": r2_k[0],
                    "r2_k": r2_k,
                    "ess_mean": fetched[3],
                    "grad_norm": fetched[4],
                    "steps_per_sec": steps_s,
                }
                rec.update(zip(extras, fetched[5:n_sc]))
                self.history.append(rec)
                if self.metrics_writer is not None and self.main:
                    self.metrics_writer.write(rec)
                self._say(
                    f"step {rec['step']:6d}  train_elbo {rec['train_elbo']:10.2f}  "
                    f"test_elbo {rec['test_elbo']:10.2f}  R²(1) {rec['r2_1']:6.3f}  "
                    f"{steps_s:6.1f} steps/s"
                )

                if rec["test_elbo"] > st.best_elbo + 1e-6:
                    st.best_elbo = rec["test_elbo"]
                    st.evals_since_best = 0
                    if cfg.train.keep_best:
                        st.best_params = {k: v.detach().clone()
                                          for k, v in self.ssm.state_dict().items()}
                else:
                    st.evals_since_best += 1
                    if st.evals_since_best >= cfg.train.patience:
                        self._say("early stopping: patience exhausted")
                        stop = True

            if self.checkpointer is not None and self.main and st.step % cfg.train.save_every == 0:
                self.checkpointer.save(st)

        if prof is not None:  # the run ended inside the window
            self._stop_profile(prof)
        if cfg.train.keep_best and st.best_params is not None:
            # model selection: end the run on the best-test-ELBO params
            self.ssm.load_state_dict(st.best_params)
        if self.checkpointer is not None and self.main:
            self.checkpointer.save(st, force=True)
        return self.history

    def _say(self, line: str) -> None:
        if self.main:
            print(line, flush=True)
