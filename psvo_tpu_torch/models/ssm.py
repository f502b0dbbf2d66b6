"""State-space model bundle (counterpart of `psvo_tpu/models/ssm.py`).

Proposals q0(x_0|y_0), q1(x_t|x_{t-1}) and the encoder q2(x_t|y_t), the
transition f(x_t|x_{t-1}), the emission g(y_t|x_t) and the learned prior
p(x_0). Where the reference keeps a static `SSM` plus a params pytree, here
`SSM` is an `nn.Module` that owns its heads; every method reads them from
`self`. The `_cm` methods take the forward filter's channel-major particle
layout [B, D, K]; the feature-last ones serve the k-step evaluation and the
log-joint of the smoothed paths.

Ported: the diagonal-Gaussian model class of the FHN FIVO, Lorenz-63 PSVO
and SVO, and Lorenz-96 FIVO slices, at any state width, with SVO's backward
proposal q_b, and exogenous controls u_t [Di] (di > 0): q1 and f then
condition on [x_{t−1}; u_t], their first layers [Dx + Di, H]; g, q0, q2 and
q_b see no controls. Bootstrap mode (smc.use_bootstrap, the Kalman oracle's
model): t = 0 proposes from the prior and every later step from f, so q0,
q1 and q2 go unused; no kernel class takes it, so it runs on CPU tensors
only. Heads may have no hidden layer (hidden=(), the oracle's linear
heads). Known dynamics, full-covariance heads, Poisson/Dirac emissions and
the SVO backward proposal's GRU raise NotImplementedError until their
slices land.
"""

from __future__ import annotations

import torch
from torch import nn

from psvo_tpu_torch import distributions as dist
from psvo_tpu_torch import networks
from psvo_tpu_torch.config import Config

_GAUSSIAN_EMISSIONS = ("linear_gaussian", "identity_gaussian")


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

        unported = [
            name
            for name, on in (
                ("smc.transition='known'", self.transition_known),
                ("smc.qb_rnn", self.qb_rnn),
                (f"data.emission={self.emission!r}",
                 self.emission not in _GAUSSIAN_EMISSIONS),
            )
            if on
        ] + [
            f"nets[{k!r}].cov_type={v.cov_type!r}"
            for k, v in self.nets.items()
            if v.cov_type != "const"
        ]
        if unported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(unported)
            )

        dx, dy, enc = self.dx, self.dy, self.enc_dim
        dims = {
            "q0": (enc, dx), "q1": (dx + self.di, dx), "q2": (enc, dx),
            "f": (dx + self.di, dx), "g": (dx, dy), "qb": (dx + dy, dx),
        }
        self._dims = dims
        self.heads = nn.ModuleDict(
            {k: networks.MLPHead(*dims[k], self.nets[k].hidden) for k in dims}
        )
        self.prior_mean = nn.Parameter(torch.zeros(dx))
        self.prior_raw_scale = nn.Parameter(torch.zeros(dx))

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "SSM":
        """(Re)draw every parameter with the reference's scheme (in place)."""
        for name in ("q0", "q1", "q2", "f", "g", "qb"):
            din, dout = self._dims[name]
            cfg = self.nets[name]
            fresh = networks.init_mlp_head(
                generator, din, dout, cfg.hidden,
                cov_type=cfg.cov_type, sigma_init=cfg.sigma_init,
                sigma_min=cfg.sigma_min,
            )
            self.heads[name].load_state_dict(fresh.state_dict())
        with torch.no_grad():
            self.prior_mean.zero_()
            self.prior_raw_scale.zero_()  # softplus(0) + 1e-3 ≈ 0.69
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

    def step_heads_cm(self, x_prev, y_t=None, q2_ms=None, u=None):
        """All per-step diagonal conditionals on x_prev [B, Dx, K] (and the
        step's controls u [B, Di]): (mean_q, scale_q, mean_f, scale_f), each
        [B, Dx, K]. q2_ms supplies the precomputed q2 (mean, scale) [B, Dx];
        y_t is read only without it. Bootstrap mode proposes from f itself.
        """
        if self.use_bootstrap:
            mean_f, scale_f = self.transition_params_cm(x_prev, u)
            return mean_f, scale_f, mean_f, scale_f
        x_in = self._with_control_cm(x_prev, u)
        m1, s1 = self._mean_scale_cm("q1", x_in)
        mean_f, scale_f = self._mean_scale_cm("f", x_in)
        if self.use_2q:
            m2, s2 = q2_ms if q2_ms is not None else self.q2_mean_scale(y_t)
            mean_q, scale_q = dist.mvn_product(m1, s1, m2[..., None], s2[..., None])
        else:
            mean_q, scale_q = m1, s1
        return mean_q, scale_q, mean_f, scale_f

    def emission_log_prob_cm(self, x, y):
        """x [B, Dx, K], y [B, Dy] -> [B, K] (diagonal Gaussian emission)."""
        mean, scale = self._mean_scale_cm("g", x)
        return dist.mvn_diag_log_prob_cm(y[..., :, None], mean, scale)

    def transition_params_cm(self, x_prev, u=None):
        """Diagonal transition: x_prev [..., Dx, K] (controls u [..., Di]) ->
        (mean, scale) [..., Dx, K]."""
        return self._mean_scale_cm("f", self._with_control_cm(x_prev, u))

    # -- feature-last (smoothed-path log-joint, k-step evaluation) ---------------

    def transition_params(self, x_prev, u=None):
        """Diagonal transition -> (mean, scale), feature-last; u as in
        `_with_control`."""
        return self._mean_scale("f", self._with_control(x_prev, u))

    def transition_log_prob(self, x_prev, x, u=None):
        """log f(x | x_prev[, u]): [..., Dx] x [..., Dx] -> [...]."""
        mean, scale = self.transition_params(x_prev, u)
        return dist.mvn_diag_log_prob(x, mean, scale)

    def emission_log_prob(self, x, y):
        """log g(y | x): x [..., Dx], y [..., Dy] -> [...]."""
        mean, scale = self._mean_scale("g", x)
        return dist.mvn_diag_log_prob(y, mean, scale)

    def transition_mean(self, x_prev, u=None):
        """Mean next state [..., Dx] — k-step prediction rollouts; u as in
        `_with_control`."""
        return self.transition_params(x_prev, u)[0]

    def emission_mean(self, x):
        """Mean observation ŷ(x) [..., Dy]."""
        return self._mean_scale("g", x)[0]

    def backward_propose(self, x_next, y_t):
        """SVO's learned backward proposal q_b(x_t | x_{t+1}, y_t): the qb head
        on [x_next; y_t], y_t broadcast over the paths. x_next [..., Dx],
        y_t [..., Dy] (broadcastable) -> (mean, scale) [..., Dx]."""
        y = y_t.expand(*x_next.shape[:-1], self.dy)
        return self._mean_scale("qb", torch.cat([x_next, y], dim=-1))


def init_ssm(cfg: Config, generator: torch.Generator, device="cuda") -> SSM:
    """Build the model for `cfg` and draw its parameters from `generator`
    (a CPU generator: parameters are drawn on the host, then moved to
    `device`, the card unless the caller asks for the CPU)."""
    return SSM(cfg).init(generator).to(device)
