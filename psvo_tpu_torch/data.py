"""Synthetic datasets (counterpart of `psvo_tpu/data.py`, the FHN, Lorenz-63
and Lorenz-96 paths).

Simulate `n_train + n_test` trajectories of the true FHN, Lorenz-63,
Lorenz-96 or LGSSM model with process noise, observed through the linear
map C with Gaussian noise (data.emission "linear_gaussian" or
"identity_gaussian"), exactly (a Dirac emission, "dirac": y = x·C), or as
Poisson counts of rate exp(tanh(x·C)) ("poisson"), as in the reference. Lorenz-63 starts near the attractor's centre; both Lorenz systems
are run 500 noise-free steps onto the attractor before the first recorded
step, as in the reference. With data.di > 0 the simulator also draws iid
N(0, 1) controls u_t [Di] and a fixed map b_ctrl = control_scale·N(0, 1)
[Di, Dx] / √Di, and steps x_{t+1} = step(x_t) + u_t·b_ctrl + proc_scale·n,
as the reference does. The draws
come from a seeded `torch.Generator`, so a port dataset differs from a
reference one of the same seed; `simulate_from_noise` takes the noise
explicitly so the two simulators can be compared on the same draws. `save_dataset`/`load_dataset`
use the reference's npz format, so both packages read one file.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from psvo_tpu_torch.config import DataConfig
from psvo_tpu_torch.models import dynamics as dyn


@dataclass
class Dataset:
    obs_train: torch.Tensor  # [n_train, T, Dy]
    obs_test: torch.Tensor  # [n_test, T, Dy]
    hidden_train: torch.Tensor  # [n_train, T, Dx]
    hidden_test: torch.Tensor  # [n_test, T, Dx]
    emission_matrix: torch.Tensor  # [Dx, Dy]
    controls_train: torch.Tensor | None = None  # [n_train, T, Di]
    controls_test: torch.Tensor | None = None
    control_matrix: torch.Tensor | None = None  # [Di, Dx]


# Burn-in pushes chaotic initial states onto the attractor before recording.
_BURN_IN = {"lorenz63": 500, "lorenz96": 500}
_X0_OFFSET = {"lorenz63": (0.0, 0.0, 25.0)}  # start near the attractor center


def emission_map(cfg: DataConfig, generator: torch.Generator):
    """Fixed [Dx, Dy] observation matrix: identity when square (or
    identity_gaussian), else a random projection from the dataset seed."""
    if cfg.emission == "identity_gaussian" or cfg.dx == cfg.dy:
        return torch.eye(cfg.dx, cfg.dy)
    return torch.randn((cfg.dx, cfg.dy), generator=generator) / math.sqrt(cfg.dx)


def simulate_from_noise(cfg: DataConfig, c_emit, x0_noise, proc_noise, obs_noise,
                        controls=None, b_ctrl=None):
    """Deterministic simulator: x0 noise [n, Dx], process noise [T, n, Dx],
    observation noise [T, n, Dy] and, with data.di > 0, controls [T, n, Di]
    and their map b_ctrl [Di, Dx] -> (hidden [n, T, Dx], obs [n, T, Dy]).
    A Dirac emission observes x·C and reads no noise; for a Poisson one obs
    is the rate exp(tanh(x·C)), from which `generate_dataset` draws the
    counts."""
    if (controls is None) != (b_ctrl is None) or (controls is not None) != bool(cfg.di):
        raise ValueError(f"simulate_from_noise: di={cfg.di} needs controls and b_ctrl "
                         "together, and only then")
    stepper = dyn.make_stepper(cfg)
    offset = torch.tensor(_X0_OFFSET.get(cfg.datatype, (0.0,) * cfg.dx),
                          dtype=x0_noise.dtype, device=x0_noise.device)
    x = offset + cfg.x0_scale * x0_noise
    for _ in range(_BURN_IN.get(cfg.datatype, 0)):
        x = stepper.step(x)
    xs, ys = [], []
    for t in range(cfg.t_steps):
        x = stepper.step(x)
        if controls is not None:
            x = x + controls[t] @ b_ctrl
        x = x + cfg.proc_scale * proc_noise[t]
        xs.append(x)
        proj = x @ c_emit
        if cfg.emission == "poisson":
            ys.append(torch.exp(torch.tanh(proj)))
        elif cfg.emission == "dirac":
            ys.append(proj)
        else:
            ys.append(proj + cfg.obs_scale * obs_noise[t])
    return torch.stack(xs, dim=1), torch.stack(ys, dim=1)


def generate_dataset(cfg: DataConfig, seed: int) -> Dataset:
    if cfg.emission not in ("linear_gaussian", "identity_gaussian", "poisson", "dirac"):
        raise ValueError(f"unknown emission {cfg.emission!r}")
    gen = torch.Generator().manual_seed(seed)
    n = cfg.n_train + cfg.n_test
    c_emit = emission_map(cfg, gen)
    x0_noise = torch.randn((n, cfg.dx), generator=gen)
    proc = torch.randn((cfg.t_steps, n, cfg.dx), generator=gen)
    obs_noise = torch.randn((cfg.t_steps, n, cfg.dy), generator=gen)
    u = b_ctrl = None
    if cfg.di:  # drawn after the rest, so an uncontrolled dataset keeps its draws
        u = torch.randn((cfg.t_steps, n, cfg.di), generator=gen)
        b_ctrl = cfg.control_scale * torch.randn((cfg.di, cfg.dx), generator=gen) / math.sqrt(cfg.di)
    hidden, obs = simulate_from_noise(cfg, c_emit, x0_noise, proc, obs_noise, u, b_ctrl)
    if cfg.emission == "poisson":  # drawn last, so the other draws keep their order
        obs = torch.poisson(obs, generator=gen)
    if not bool(torch.isfinite(hidden).all()):
        raise ValueError(
            f"simulated {cfg.datatype} trajectories diverged (non-finite states); "
            "reduce control_scale/proc_scale or the integrator dt"
        )
    ctrl = None if u is None else u.transpose(0, 1)  # [n, T, Di]
    return Dataset(
        obs_train=obs[: cfg.n_train],
        obs_test=obs[cfg.n_train :],
        hidden_train=hidden[: cfg.n_train],
        hidden_test=hidden[cfg.n_train :],
        emission_matrix=c_emit,
        controls_train=None if ctrl is None else ctrl[: cfg.n_train].contiguous(),
        controls_test=None if ctrl is None else ctrl[cfg.n_train :].contiguous(),
        control_matrix=b_ctrl,
    )


_FIELDS = (
    "obs_train",
    "obs_test",
    "hidden_train",
    "hidden_test",
    "emission_matrix",
    "controls_train",
    "controls_test",
    "control_matrix",
)


def save_dataset(ds: Dataset, path) -> None:
    arrays = {
        f: getattr(ds, f).detach().cpu().numpy()
        for f in _FIELDS
        if getattr(ds, f) is not None
    }
    np.savez_compressed(path, **arrays)


def load_dataset(path) -> Dataset:
    with np.load(path) as z:
        return Dataset(**{f: torch.from_numpy(z[f]) for f in _FIELDS if f in z.files})
