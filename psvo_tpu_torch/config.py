"""Typed configuration tree + experiment presets (jax-free mirror).

A copy of `psvo_tpu/config.py`: importing `psvo_tpu.config` imports the
`psvo_tpu` package, whose `__init__` imports jax, so the port keeps its own
copy. The dataclasses, field defaults, `PRESETS`, `to_dict`/`from_dict`,
`config_hash` and `resume_hash` must stay identical to the reference's —
`tests/test_torch_config.py` compares them preset by preset, so a config
hashed by one package is the same config in the other. The per-field and
per-preset rationale lives in the reference module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from dataclasses import dataclass, field
from typing import Any

OBJECTIVES = ("iwae", "fivo", "svo", "psvo")
RESAMPLERS = ("systematic", "multinomial", "none")


@dataclass(frozen=True)
class NetConfig:
    """One conditional head (proposal / transition / emission / backward proposal)."""

    hidden: tuple[int, ...] = (64, 64)
    activation: str = "relu"
    cov_type: str = "const"
    sigma_init: float = 1.0
    sigma_min: float = 1e-2


@dataclass(frozen=True)
class DataConfig:
    """Synthetic dataset generation."""

    datatype: str = "fhn"
    dx: int = 2
    dy: int = 2
    di: int = 0
    control_scale: float = 1.0
    t_steps: int = 100
    n_train: int = 200
    n_test: int = 40
    emission: str = "linear_gaussian"
    obs_scale: float = 0.2
    proc_scale: float = 0.1
    dyn_overrides: tuple[tuple[str, Any], ...] = ()
    x0_scale: float = 1.0


@dataclass(frozen=True)
class SMCConfig:
    """Objective family + particle-filter behavior."""

    objective: str = "fivo"
    n_particles: int = 128
    n_smoothing_particles: int = 16
    ffbsi_segments: int = 1
    resampling: str = "systematic"
    psvo_bound: str = "forward"
    qb_rnn: bool = False
    transition: str = "mlp"
    ess_threshold: float = 1.0
    kernel_rng: bool = False
    use_2q: bool = True
    remat: bool = True
    use_bootstrap: bool = False
    use_stop_gradient: bool = True
    q_uses_true_x: bool = False


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-3
    lr_schedule: str = "const"
    keep_best: bool = True
    batch_size: int = 32
    n_steps: int = 2000
    epochs: int = 0
    clip_norm: float = 10.0
    eval_every: int = 100
    save_every: int = 500
    patience: int = 20
    mse_k_steps: int = 10
    bf16_matmuls: bool = False
    rng_impl: str = "threefry2x32"
    debug_checks: bool = False
    steps_per_call: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """The (data, particle) mesh of a sharded run (`parallel.sharding`): one
    rank of a `torch.distributed` process group per position, the batch
    split over `data` and the K particles over `particle`. Started as one
    process, a run with a mesh runs unsharded. `slices` (the reference's
    multi-slice DCN layout) is kept for config parity and not used."""

    data: int = 1
    particle: int = 1
    slices: int = 1


def _default_nets() -> tuple[tuple[str, NetConfig], ...]:
    return (
        ("q0", NetConfig()),
        ("q1", NetConfig()),
        ("q2", NetConfig()),
        ("f", NetConfig()),
        ("g", NetConfig(sigma_init=0.5)),
        ("qb", NetConfig()),
    )


@dataclass(frozen=True)
class Config:
    name: str = "default"
    seed: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    smc: SMCConfig = field(default_factory=SMCConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    nets: tuple[tuple[str, NetConfig], ...] = field(default_factory=_default_nets)
    use_pallas: bool = True
    use_pallas_resample: bool = True
    use_pallas_step: bool = True

    def net(self, name: str) -> NetConfig:
        for k, v in self.nets:
            if k == name:
                return v
        raise KeyError(name)

    def with_nets(self, **updates: NetConfig) -> "Config":
        nets = tuple((k, updates.get(k, v)) for k, v in self.nets)
        return dataclasses.replace(self, nets=nets)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def config_hash(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def resume_hash(self) -> str:
        """Hash of everything that must match for a checkpoint to be loadable.

        Run-control knobs (total steps, eval/save cadence, patience, batch
        size, learning rate) may legitimately change across resumes — e.g.
        `--steps 250` continuing a 200-step run, or an lr drop — so they are
        excluded; anything shaping params/optimizer-state structure is not.
        """
        d = self.to_dict()
        for k in ("n_steps", "epochs", "eval_every", "save_every", "patience", "batch_size", "lr", "debug_checks", "steps_per_call"):
            d["train"].pop(k, None)
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _deep_tuple(v):
    """Recursively convert lists to tuples (JSON round-trips turn tuples into
    lists; nested ones like data.dyn_overrides must come back hashable)."""
    if isinstance(v, (list, tuple)):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _tupled(d: dict, cls):
    """Rebuild a (possibly nested) frozen dataclass from a dict, tupling lists."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints.get(f.name, f.type)
        if isinstance(t, type) and dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = _tupled(v, t)
        kwargs[f.name] = _deep_tuple(v) if isinstance(v, (list, tuple)) else v
    return cls(**kwargs)


def from_dict(d: dict) -> Config:
    nets = tuple(
        (k, _tupled(dict(v), NetConfig)) for k, v in (d.get("nets") or _default_nets())
    )
    return Config(
        name=d.get("name", "default"),
        seed=d.get("seed", 0),
        data=_tupled(d.get("data", {}), DataConfig),
        smc=_tupled(d.get("smc", {}), SMCConfig),
        train=_tupled(d.get("train", {}), TrainConfig),
        mesh=_tupled(d.get("mesh", {}), MeshConfig),
        nets=nets,
        use_pallas=d.get("use_pallas", True),
        use_pallas_resample=d.get("use_pallas_resample", True),
        use_pallas_step=d.get("use_pallas_step", True),
    )


# The reference's benchmark and capability presets, field for field.
PRESETS: dict[str, Config] = {
    "fhn_iwae_k16": Config(
        name="fhn_iwae_k16",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="iwae", n_particles=16, resampling="none"),
        train=TrainConfig(steps_per_call=50),
    ),
    "fhn_fivo_k128": Config(
        name="fhn_fivo_k128",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(
            objective="fivo", n_particles=128, resampling="systematic",
            kernel_rng=True,
        ),
        train=TrainConfig(steps_per_call=10),
    ),
    "lorenz63_svo_k256": Config(
        name="lorenz63_svo_k256",
        data=DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=100, obs_scale=0.5),
        smc=SMCConfig(
            objective="svo",
            n_particles=256,
            n_smoothing_particles=16,
            resampling="systematic",
            kernel_rng=True,
        ),
        train=TrainConfig(steps_per_call=10),
    ),
    "lorenz63_psvo_k1024": Config(
        name="lorenz63_psvo_k1024",
        data=DataConfig(datatype="lorenz63", dx=3, dy=3, t_steps=100, obs_scale=0.5),
        smc=SMCConfig(
            objective="psvo",
            n_particles=1024,
            n_smoothing_particles=16,
            resampling="systematic",
        ),
        train=TrainConfig(rng_impl="rbg", steps_per_call=10),
    ),
    "lorenz96_fivo_k8192_sharded": Config(
        name="lorenz96_fivo_k8192_sharded",
        data=DataConfig(
            datatype="lorenz96", dx=40, dy=40, t_steps=100, obs_scale=0.5
        ),
        smc=SMCConfig(
            objective="fivo", n_particles=8192, resampling="systematic",
            kernel_rng=True,
        ),
        mesh=MeshConfig(data=1, particle=8),
        train=TrainConfig(batch_size=8),
    ),
    "fhn_fivo_controls": Config(
        name="fhn_fivo_controls",
        data=DataConfig(datatype="fhn", dx=2, dy=2, di=2, control_scale=0.5, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ),
    "fhn_fivo_known_dynamics": Config(
        name="fhn_fivo_known_dynamics",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128, transition="known"),
    ),
    "fhn_fivo_tril": Config(
        name="fhn_fivo_tril",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ).with_nets(
        f=NetConfig(cov_type="tril"), g=NetConfig(cov_type="tril", sigma_init=0.5)
    ),
    "fhn_fivo_dirac": Config(
        name="fhn_fivo_dirac",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100, emission="dirac"),
        smc=SMCConfig(objective="fivo", n_particles=128),
    ),
    "fhn_fivo_k1024_bench": Config(
        name="fhn_fivo_k1024_bench",
        data=DataConfig(datatype="fhn", dx=2, dy=2, t_steps=100),
        smc=SMCConfig(
            objective="fivo", n_particles=1024, resampling="systematic",
            kernel_rng=True,
        ),
        train=TrainConfig(steps_per_call=10),
    ),
}


def preset(name: str) -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; options: {sorted(PRESETS)}")
