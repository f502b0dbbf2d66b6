"""State-space model bundle (counterpart of `psvo_tpu/models/ssm.py`).

Proposals q0(x_0|y_0), q1(x_t|x_{t-1}) and the encoder q2(x_t|y_t), the
transition f(x_t|x_{t-1}), the emission g(y_t|x_t) and the learned prior
p(x_0). Where the reference keeps a static `SSM` plus a params pytree, here
`SSM` is an `nn.Module` that owns its heads; every method reads them from
`self`. The `_cm` methods take the forward filter's channel-major particle
layout [B, D, K]; the feature-last ones serve the k-step evaluation and the
log-joint of the smoothed paths.

The reference's model modes:

- exogenous controls u_t [Di] (di > 0): q1 and f condition on
  [x_{t−1}; u_t], their first layers [Dx + Di, H]; g, q0, q2 and q_b see
  no controls;
- bootstrap mode (smc.use_bootstrap): t = 0 proposes from the prior and
  every later step from f, so q0, q1 and q2 go unused;
- known dynamics (smc.transition = "known"): f's mean is the true stepper
  (`models.dynamics.make_stepper`), plus u_t·ctrl_w with controls, and only
  its diagonal noise scale is learned (`networks.KnownTransition`);
- full covariances on f and g: cov_type "tril" (a constant Cholesky factor)
  or "tril_head" (a packed factor per input); "head" gives a state-dependent
  diagonal scale. Proposals stay diagonal: the use_2q fusion and the draws
  are diagonal;
- Poisson counts and Dirac emissions: g is a mean-only head (the log-rate,
  or the observation map of a Dirac delta, which adds 0 to the weights);
- smc.q_uses_true_x: q0 and q2 read the true latents (width Dx).

Which of these a kernel class takes is the gates' business
(`ops.fused_step.usable`, `ops.trunk.usable`, `ops.ffbsi.usable`,
`ops.svo.usable`, `smc.reference_path`). Heads may have no hidden layer
(hidden=(), the oracle's linear heads).

SVO's backward proposal q_b(x_t | x_{t+1}, y_t) is the "qb" head; with
smc.qb_rnn it also reads h_t, the state of a GRU (`networks.GRU`, input Dy,
width the qb trunk's first hidden size) run backwards over the observations
from h = 0, so that h_t summarizes y_{t:T} (`backward_rnn_summaries`); the
qb head's input is then [x_{t+1}; y_t; h_t], Dx + Dy + H wide.
"""

from __future__ import annotations

import torch
from torch import nn

from psvo_tpu_torch import distributions as dist
from psvo_tpu_torch import networks
from psvo_tpu_torch.config import Config
from psvo_tpu_torch.models import dynamics as dyn

_FULL = ("tril", "tril_head")


class SSM(nn.Module):
    """Model description plus its learnable heads."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.dx = cfg.data.dx
        self.dy = cfg.data.dy
        self.di = cfg.data.di
        self.emission = cfg.data.emission
        self.use_2q = cfg.smc.use_2q
        self.use_bootstrap = cfg.smc.use_bootstrap
        self.transition_known = cfg.smc.transition == "known"
        self.qb_rnn = cfg.smc.qb_rnn
        self.enc_dim = cfg.data.dx if cfg.smc.q_uses_true_x else cfg.data.dy
        self.nets = {k: v for k, v in cfg.nets}
        self.stepper = dyn.make_stepper(cfg.data) if self.transition_known else None
        # f_tril / g_tril: a full covariance, constant or per input;
        # *_tril_head: the per-input one
        f_cov, g_cov = self.nets["f"].cov_type, self.nets["g"].cov_type
        self.f_tril = not self.transition_known and f_cov in _FULL
        self.g_tril = g_cov in _FULL
        self.f_tril_head = not self.transition_known and f_cov == "tril_head"
        self.g_tril_head = g_cov == "tril_head"

        if self.qb_rnn and not self.nets["qb"].hidden:
            raise ValueError("smc.qb_rnn: the GRU's width is the qb head's first hidden size, "
                             "and the qb head has no hidden layer")
        for q in ("q0", "q1", "q2", "qb"):
            if self.nets[q].cov_type in _FULL:
                raise ValueError(
                    f"cov_type={self.nets[q].cov_type!r} is not supported on proposal head "
                    f"{q!r}: the use_2q precision fusion and reparameterized draws are "
                    "diagonal; use it on 'f' or 'g'"
                )
        if self.transition_known and f_cov in _FULL:
            raise ValueError("transition='known' uses a diagonal learned noise scale")
        if self.emission == "poisson" and self.g_tril:
            raise ValueError("poisson emissions have no covariance head")

        dx, dy, enc = self.dx, self.dy, self.enc_dim
        dims = {
            "q0": (enc, dx), "q1": (dx + self.di, dx), "q2": (enc, dx),
            "f": (dx + self.di, dx), "g": (dx, dy),
            "qb": (dx + dy + (self.qb_rnn_dim if self.qb_rnn else 0), dx),
        }
        self._dims = dims
        self._covs = {k: self.nets[k].cov_type for k in dims}
        if self.emission in ("poisson", "dirac"):
            self._covs["g"] = "none"
        heads = {
            k: networks.MLPHead(*dims[k], self.nets[k].hidden, self._covs[k])
            for k in dims if not (k == "f" and self.transition_known)
        }
        if self.transition_known:
            heads["f"] = networks.KnownTransition(dx, self.di)
        self.heads = nn.ModuleDict({k: heads[k] for k in dims})
        self.prior_mean = nn.Parameter(torch.zeros(dx))
        self.prior_raw_scale = nn.Parameter(torch.zeros(dx))
        if self.qb_rnn:
            self.gru = networks.GRU(dy, self.qb_rnn_dim)

    @property
    def qb_rnn_dim(self) -> int:
        """The qb GRU's state width H: the qb trunk's first hidden size (the
        reference's `SSM.qb_rnn_dim`)."""
        return self.nets["qb"].hidden[0]

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "SSM":
        """(Re)draw every parameter with the reference's scheme (in place)."""
        for name in ("q0", "q1", "q2", "f", "g", "qb"):
            din, dout = self._dims[name]
            cfg = self.nets[name]
            if name == "f" and self.transition_known:
                with torch.no_grad():
                    f = self.heads["f"]
                    f.raw_scale.fill_(networks.raw_scale_init(cfg.sigma_init, cfg.sigma_min))
                    if self.di:
                        f.ctrl_w.zero_()
                continue
            fresh = networks.init_mlp_head(
                generator, din, dout, cfg.hidden,
                cov_type=self._covs[name], sigma_init=cfg.sigma_init,
                sigma_min=cfg.sigma_min,
            )
            self.heads[name].load_state_dict(fresh.state_dict())
        with torch.no_grad():
            self.prior_mean.zero_()
            self.prior_raw_scale.zero_()  # softplus(0) + 1e-3 ≈ 0.69
        if self.qb_rnn:  # drawn last: a model without the GRU keeps its draws
            fresh = networks.init_gru(generator, self.dy, self.qb_rnn_dim)
            self.gru.load_state_dict(fresh.state_dict())
        return self

    # -- head application ---------------------------------------------------

    def _mean_scale(self, name: str, x):
        cfg = self.nets[name]
        return networks.mlp_mean_scale(
            self.heads[name], x, activation=cfg.activation, sigma_min=cfg.sigma_min
        )

    def _mean_scale_cm(self, name: str, x):
        cfg = self.nets[name]
        return networks.mlp_mean_scale_cm(
            self.heads[name], x, activation=cfg.activation, sigma_min=cfg.sigma_min
        )

    def _mean(self, name: str, x):
        """Mean-only application (Poisson log-rate, Dirac map, tril mean)."""
        return networks.mlp_mean(self.heads[name], x, activation=self.nets[name].activation)

    def _mean_cm(self, name: str, x):
        return networks.mlp_mean_cm(self.heads[name], x, activation=self.nets[name].activation)

    def _mean_tril_cm(self, name: str, x):
        cfg = self.nets[name]
        return networks.mlp_mean_tril_cm(self.heads[name], x, activation=cfg.activation,
                                         sigma_min=cfg.sigma_min)

    def _mean_tril(self, name: str, x):
        cfg = self.nets[name]
        return networks.mlp_mean_tril(self.heads[name], x, activation=cfg.activation,
                                      sigma_min=cfg.sigma_min)

    def _chol(self, name: str):
        """The constant Cholesky factor of a "tril" head."""
        return self.heads[name].chol(self.nets[name].sigma_min)

    def scale(self, name: str):
        """The constant diagonal scale [D] of head `name`."""
        return networks.scale_from_raw(
            self.heads[name].raw_scale, self.nets[name].sigma_min
        )

    # -- control-input concat -------------------------------------------------

    def _with_control(self, x, u):
        """Feature-last [x; u]: x [..., Dx] with u either [B, Di] (broadcast
        over the middle axes) or position-matched [..., Di]; zeros for u None.
        x itself when di = 0."""
        if not self.di:
            return x
        if u is None:
            u = x.new_zeros((*x.shape[:-1], self.di))
        elif not (u.dim() == x.dim() and u.shape[:-1] == x.shape[:-1]):
            u = u.reshape(u.shape[0], *([1] * (x.dim() - 2)), self.di).expand(
                *x.shape[:-1], self.di)
        return torch.cat([x, u], dim=-1)

    def _with_control_cm(self, x, u):
        """Channel-major [x; u]: x [..., Dx, K], u [..., Di] (leading dims
        broadcast) -> [..., Dx + Di, K]; zeros for u None. x itself when
        di = 0."""
        if not self.di:
            return x
        shape = (*x.shape[:-2], self.di, x.shape[-1])
        u_b = x.new_zeros(shape) if u is None else u[..., :, None].expand(shape)
        return torch.cat([x, u_b], dim=-2)

    # -- prior and proposals --------------------------------------------------

    def prior_params(self):
        return self.prior_mean, networks.scale_from_raw(self.prior_raw_scale, 1e-3)

    def prior_log_prob(self, x):
        """x [..., Dx] -> [...]."""
        mean, scale = self.prior_params()
        return dist.mvn_diag_log_prob(x, mean, scale)

    def prior_log_prob_cm(self, x):
        """x [..., Dx, K] -> [..., K]."""
        mean, scale = self.prior_params()
        return dist.mvn_diag_log_prob_cm(x, mean[:, None], scale[:, None])

    def propose_initial(self, y0):
        """q0(x_0 | y_0) -> (mean, scale), feature-last; bootstrap mode
        proposes from the prior."""
        if self.use_bootstrap:
            mean, scale = self.prior_params()
            shape = (*y0.shape[:-1], self.dx)
            return mean.expand(shape), scale.expand(shape)
        return self._mean_scale("q0", y0)

    def q2_mean_scale(self, enc):
        """Encoder proposal q2(x_t | y_t), feature-last; the filter evaluates
        it for all T at once, outside the time loop."""
        return self._mean_scale("q2", enc)

    def propose_cm(self, x_prev, y_t=None, q2_ms=None, u=None):
        """The diagonal proposal on x_prev [B, Dx, K] (controls u [B, Di]):
        q1, fused with q2 under use_2q; f itself in bootstrap mode (a
        diagonal f). -> (mean, scale) [B, Dx, K]."""
        if self.use_bootstrap:
            return self.transition_params_cm(x_prev, u)
        m1, s1 = self._mean_scale_cm("q1", self._with_control_cm(x_prev, u))
        if not self.use_2q:
            return m1, s1
        m2, s2 = q2_ms if q2_ms is not None else self.q2_mean_scale(y_t)
        return dist.mvn_product(m1, s1, m2[..., None], s2[..., None])

    def step_heads_cm(self, x_prev, y_t=None, q2_ms=None, u=None):
        """All per-step diagonal conditionals on x_prev [B, Dx, K] (and the
        step's controls u [B, Di]): (mean_q, scale_q, mean_f, scale_f), each
        [B, Dx, K]. q2_ms supplies the precomputed q2 (mean, scale) [B, Dx];
        y_t is read only without it. Bootstrap mode proposes from f itself.
        Diagonal f only: the filter routes a full-covariance f through
        `propose_cm` and `transition_log_prob_cm`.
        """
        if self.use_bootstrap:
            mean_f, scale_f = self.transition_params_cm(x_prev, u)
            return mean_f, scale_f, mean_f, scale_f
        mean_q, scale_q = self.propose_cm(x_prev, y_t, q2_ms, u)
        mean_f, scale_f = self.transition_params_cm(x_prev, u)
        return mean_q, scale_q, mean_f, scale_f

    def _known_drift(self, mean, u):
        """Known dynamics' control drift u·ctrl_w added to a feature-last mean
        [..., Dx]; u is [B, Di] (broadcast over the middle axes) or
        position-matched [..., Di], as in `_with_control`."""
        if not self.di or u is None:
            return mean
        drift = u @ self.heads["f"].ctrl_w
        if not (drift.dim() == mean.dim() and drift.shape[:-1] == mean.shape[:-1]):
            drift = drift.reshape(drift.shape[0], *([1] * (mean.dim() - 2)), self.dx)
        return mean + drift

    def _known_scale(self):
        return networks.scale_from_raw(self.heads["f"].raw_scale, self.nets["f"].sigma_min)

    def transition_params_cm(self, x_prev, u=None):
        """Diagonal transition: x_prev [..., Dx, K] (controls u [..., Di]) ->
        (mean, scale) [..., Dx, K]; known dynamics step x_prev with the true
        stepper."""
        if self.transition_known:
            mean = self.stepper.step(x_prev, axis=-2)
            if self.di and u is not None:
                mean = mean + (u @ self.heads["f"].ctrl_w)[..., :, None]
            return mean, self._known_scale()[:, None].expand(mean.shape)
        return self._mean_scale_cm("f", self._with_control_cm(x_prev, u))

    def transition_full_cm(self, x_prev, u=None):
        """Constant full-covariance transition (f "tril"): -> (mean
        [..., Dx, K], chol [Dx, Dx])."""
        return self._mean_cm("f", self._with_control_cm(x_prev, u)), self._chol("f")

    def transition_tril_cm(self, x_prev, u=None):
        """Per-state full-covariance transition (f "tril_head"): -> (mean,
        diag [..., Dx, K], off [..., Dx(Dx−1)/2, K])."""
        return self._mean_tril_cm("f", self._with_control_cm(x_prev, u))

    def transition_log_prob_cm(self, x_prev, x, u=None):
        """log f(x | x_prev[, u]), channel-major -> [..., K]."""
        if self.f_tril_head:
            return dist.mvn_tril_log_prob_cm(x, *self.transition_tril_cm(x_prev, u))
        if self.f_tril:
            return dist.mvn_full_log_prob_cm(x, *self.transition_full_cm(x_prev, u))
        mean, scale = self.transition_params_cm(x_prev, u)
        return dist.mvn_diag_log_prob_cm(x, mean, scale)

    def emission_log_prob_cm(self, x, y):
        """log g(y | x): x [B, Dx, K], y [B, Dy] -> [B, K]."""
        y = y[..., :, None]
        if self.emission == "dirac":  # a constant density: adds 0
            return torch.zeros((*x.shape[:-2], x.shape[-1]), dtype=x.dtype, device=x.device)
        if self.emission == "poisson":
            return dist.poisson_log_prob_cm(y, self._mean_cm("g", x))
        if self.g_tril_head:
            return dist.mvn_tril_log_prob_cm(y, *self._mean_tril_cm("g", x))
        if self.g_tril:
            return dist.mvn_full_log_prob_cm(y, self._mean_cm("g", x), self._chol("g"))
        mean, scale = self._mean_scale_cm("g", x)
        return dist.mvn_diag_log_prob_cm(y, mean, scale)

    # -- feature-last (smoothed-path log-joint, k-step evaluation) ---------------

    def transition_params(self, x_prev, u=None):
        """Diagonal transition -> (mean, scale), feature-last; u as in
        `_with_control`."""
        if self.transition_known:
            mean = self._known_drift(self.stepper.step(x_prev), u)
            return mean, self._known_scale().expand(mean.shape)
        return self._mean_scale("f", self._with_control(x_prev, u))

    def transition_log_prob(self, x_prev, x, u=None):
        """log f(x | x_prev[, u]): [..., Dx] x [..., Dx] -> [...]."""
        if self.f_tril_head:
            mean, chol = self._mean_tril("f", self._with_control(x_prev, u))
            return dist.mvn_full_log_prob(x, mean, chol)
        if self.f_tril:
            mean = self._mean("f", self._with_control(x_prev, u))
            return dist.mvn_full_log_prob(x, mean, self._chol("f"))
        mean, scale = self.transition_params(x_prev, u)
        return dist.mvn_diag_log_prob(x, mean, scale)

    def emission_log_prob(self, x, y):
        """log g(y | x): x [..., Dx], y [..., Dy] -> [...]."""
        if self.emission == "dirac":
            return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        if self.emission == "poisson":
            return dist.poisson_log_prob(y, self._mean("g", x))
        if self.g_tril_head:
            return dist.mvn_full_log_prob(y, *self._mean_tril("g", x))
        if self.g_tril:
            return dist.mvn_full_log_prob(y, self._mean("g", x), self._chol("g"))
        mean, scale = self._mean_scale("g", x)
        return dist.mvn_diag_log_prob(y, mean, scale)

    def transition_mean(self, x_prev, u=None):
        """Mean next state [..., Dx] — k-step prediction rollouts; u as in
        `_with_control`."""
        if self.transition_known:
            return self._known_drift(self.stepper.step(x_prev), u)
        if self.f_tril:
            return self._mean("f", self._with_control(x_prev, u))
        return self.transition_params(x_prev, u)[0]

    def emission_mean(self, x):
        """Mean observation ŷ(x) [..., Dy]: the rate of a Poisson emission."""
        if self.emission == "poisson":
            return torch.exp(self._mean("g", x))
        if self.emission == "dirac" or self.g_tril:
            return self._mean("g", x)
        return self._mean_scale("g", x)[0]

    def backward_rnn_summaries(self, ys_tm):
        """h_t = GRU(h_{t+1}, y_t) run backwards over the observations from
        h = 0: ys_tm [T, B, Dy] -> [T, B, H], where h_t has consumed y_{t:T}
        (the reference's `backward_rnn_summaries`). A [B, H] recurrence,
        independent of K and M."""
        h = ys_tm.new_zeros((ys_tm.shape[1], self.qb_rnn_dim))
        hs = [None] * ys_tm.shape[0]
        for t in reversed(range(ys_tm.shape[0])):
            h = hs[t] = networks.gru_step(self.gru, h, ys_tm[t])
        return torch.stack(hs)

    def backward_propose(self, x_next, y_t, h_t=None):
        """SVO's learned backward proposal q_b(x_t | x_{t+1}, y_t): the qb head
        on [x_next; y_t], y_t broadcast over the paths; with smc.qb_rnn also
        on the GRU summary h_t (`backward_rnn_summaries`), broadcast likewise.
        x_next [..., Dx], y_t [..., Dy], h_t [..., H] (broadcastable) ->
        (mean, scale) [..., Dx]."""
        parts = [x_next, y_t.expand(*x_next.shape[:-1], self.dy)]
        if self.qb_rnn:
            if h_t is None:
                raise ValueError("smc.qb_rnn=True: backward_propose needs the h_t summary "
                                 "(ssm.backward_rnn_summaries)")
            parts.append(h_t.expand(*x_next.shape[:-1], self.qb_rnn_dim))
        return self._mean_scale("qb", torch.cat(parts, dim=-1))


def init_ssm(cfg: Config, generator: torch.Generator, device="cuda") -> SSM:
    """Build the model for `cfg` and draw its parameters from `generator`
    (a CPU generator: parameters are drawn on the host, then moved to
    `device`, the card unless the caller asks for the CPU)."""
    return SSM(cfg).init(generator).to(device)
