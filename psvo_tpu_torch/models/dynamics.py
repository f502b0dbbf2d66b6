"""Ground-truth dynamics (counterpart of `psvo_tpu/models/dynamics.py`).

The FitzHugh–Nagumo, Lorenz-63 and Lorenz-96 steppers that simulate the
datasets of those names, and the linear map of the LGSSM data (`lgssm`, the
Kalman/RTS oracle's system). Steppers act on an arbitrary state axis
(default last) and vectorize over every other axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

Drift = Callable[[torch.Tensor], torch.Tensor]


def euler_step(drift: Drift, x, dt: float):
    return x + dt * drift(x)


def rk4_step(drift: Drift, x, dt: float):
    k1 = drift(x)
    k2 = drift(x + 0.5 * dt * k1)
    k3 = drift(x + 0.5 * dt * k2)
    k4 = drift(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": euler_step, "rk4": rk4_step}


@dataclass(frozen=True)
class FitzHughNagumo:
    """2-D neuron model: dv = v - v^3/3 - w + I ; dw = (v + a - b w) / tau."""

    a: float = 0.7
    b: float = 0.8
    tau: float = 12.5
    current: float = 1.0
    dt: float = 0.25
    integrator: str = "rk4"
    dim = 2

    def drift(self, x, axis: int = -1):
        v, w = x.select(axis, 0), x.select(axis, 1)
        dv = v - (v**3) / 3.0 - w + self.current
        dw = (v + self.a - self.b * w) / self.tau
        return torch.stack([dv, dw], dim=axis)

    def step(self, x, axis: int = -1):
        return _STEPPERS[self.integrator](lambda z: self.drift(z, axis), x, self.dt)


@dataclass(frozen=True)
class Lorenz63:
    """Classic chaotic 3-D system (sigma, rho, beta) = (10, 28, 8/3)."""

    sigma: float = 10.0
    rho: float = 28.0
    beta: float = 8.0 / 3.0
    dt: float = 0.01
    integrator: str = "rk4"
    dim = 3

    def drift(self, x, axis: int = -1):
        a, b, c = x.select(axis, 0), x.select(axis, 1), x.select(axis, 2)
        return torch.stack(
            [self.sigma * (b - a), a * (self.rho - c) - b, a * b - self.beta * c], dim=axis
        )

    def step(self, x, axis: int = -1):
        return _STEPPERS[self.integrator](lambda z: self.drift(z, axis), x, self.dt)


@dataclass(frozen=True)
class Lorenz96:
    """D-dimensional cyclic advection model: dx_i = (x_{i+1} − x_{i−2})·x_{i−1} − x_i + F,
    with F = 8 and D = 40 in the classic setting (`dim` is kept for parity;
    the drift works for any state width)."""

    dim: int = 40
    forcing: float = 8.0
    dt: float = 0.05
    integrator: str = "rk4"

    def drift(self, x, axis: int = -1):
        xp1 = torch.roll(x, -1, dims=axis)
        xm1 = torch.roll(x, 1, dims=axis)
        xm2 = torch.roll(x, 2, dims=axis)
        return (xp1 - xm2) * xm1 - x + self.forcing

    def step(self, x, axis: int = -1):
        return _STEPPERS[self.integrator](lambda z: self.drift(z, axis), x, self.dt)


@dataclass(frozen=True)
class LinearDynamics:
    """x_{t+1} = A x_t + c, the LGSSM oracle's system."""

    matrix: tuple  # row-major nested tuple, so the dataclass stays hashable
    offset: tuple = ()

    @property
    def dim(self) -> int:
        return len(self.matrix)

    def step(self, x, axis: int = -1):
        a = torch.tensor(self.matrix, dtype=torch.float32, device=x.device)
        if axis in (-1, x.dim() - 1):
            out = x @ a.T
            if self.offset:
                out = out + torch.tensor(self.offset, dtype=torch.float32, device=x.device)
            return out
        if axis not in (-2, x.dim() - 2):
            raise ValueError(f"LinearDynamics.step: axis {axis} must be the last or second-last")
        out = torch.einsum("ij,...jk->...ik", a, x)
        if self.offset:
            out = out + torch.tensor(self.offset, dtype=torch.float32, device=x.device)[:, None]
        return out


DYNAMICS = {"fhn": FitzHughNagumo, "lorenz63": Lorenz63, "lorenz96": Lorenz96}


def _lgssm_dynamics(dx: int) -> LinearDynamics:
    """The reference's stable rotation of the LGSSM data: 0.9·R(0.3), its
    entries rounded to float32, cut to the top-left [Dx, Dx] block."""
    theta = torch.tensor(0.3, dtype=torch.float32)
    c, s = 0.9 * torch.cos(theta), 0.9 * torch.sin(theta)
    a = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])[:dx, :dx]
    return LinearDynamics(matrix=tuple(tuple(float(v) for v in row) for row in a.tolist()))


def make_stepper(data_cfg):
    """Ground-truth stepper for a DataConfig."""
    if data_cfg.datatype == "lgssm":
        return _lgssm_dynamics(data_cfg.dx)
    if data_cfg.datatype not in DYNAMICS:
        raise NotImplementedError(
            f"datatype={data_cfg.datatype!r}: only {sorted(DYNAMICS)} and lgssm dynamics are "
            "ported"
        )
    return DYNAMICS[data_cfg.datatype](**dict(data_cfg.dyn_overrides))
