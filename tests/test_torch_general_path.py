"""The port's general filter path against `psvo_tpu`, on CPU tensors.

The general path is the counterpart of the reference's plain scan
(`psvo_tpu/smc.py:671-760`): the configurations that the reference's kernel
gates exclude. On the card it resamples through K7/K8 (K11 in the
backward); here their plain versions, or the histogram form the reference's
plain path uses. Held here, at B = 4, T = 12, heads (16,):

- each preset of the slice (`fhn_iwae_k16`, `fhn_fivo_known_dynamics`,
  `fhn_fivo_tril`, `fhn_fivo_dirac`) and the other modes: the loss and
  every gradient leaf against `jax.value_and_grad` of the reference's
  objective on the same noise (values 2e-4; gradients rtol 5e-3, atol
  5e-4), and the eval step's metrics;
- PSVO and SVO with a full-covariance transition (the plain FFBSi sweep and
  the predictive mixture) against the reference;
- each kernel gate against each mode, and `smc.reference_path` against the
  reference's own gates (`pallas_step.usable`, `pallas_trunk.usable`) in
  interpret mode, for every preset and every mode;
- the plain loop under `smc.remat`: gradients bit-equal with it on and off,
  the resample never run again in the backward.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu import train as jtrain
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step, pallas_trunk
from psvo_tpu_torch import bridge, smc
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step, svo, trunk
from tests._torch_port import (
    assert_close, assert_grads_close, key_noise, models, observations, psvo_noise, svo_noise,
    to_torch,
)

torch.set_num_threads(1)

B, T = 4, 12
GENERAL = ("fhn_iwae_k16", "fhn_fivo_known_dynamics", "fhn_fivo_tril", "fhn_fivo_dirac")

# Every mode of the slice as (config changes, K): smc fields, data fields, nets' cov_types
MODES = {
    "known dynamics": ({"transition": "known"}, {}, {}, 64),
    "known dynamics, controls": ({"transition": "known"}, {"di": 2}, {}, 64),
    "f tril": ({}, {}, {"f": "tril"}, 64),
    "f tril_head": ({}, {}, {"f": "tril_head"}, 64),
    "f head": ({}, {}, {"f": "head"}, 64),
    "g tril": ({}, {}, {"g": "tril"}, 64),
    "g tril_head": ({}, {}, {"g": "tril_head"}, 64),
    "dirac": ({}, {"emission": "dirac"}, {}, 64),
    "poisson": ({}, {"emission": "poisson"}, {}, 64),
    "bootstrap": ({"use_bootstrap": True}, {}, {}, 64),
    "bootstrap, f tril": ({"use_bootstrap": True}, {}, {"f": "tril"}, 64),
    "bootstrap, f tril_head": ({"use_bootstrap": True}, {}, {"f": "tril_head"}, 64),
    "iwae": ({"objective": "iwae", "resampling": "none"}, {}, {}, 16),
}


def _cut(jcfg, k, t=T, hidden=(16,)):
    """The reference config at the small size, the plain paths (use_pallas
    off), streamed noise."""
    nets = tuple((n, dataclasses.replace(v, hidden=hidden)) for n, v in jcfg.nets)
    return dataclasses.replace(
        jcfg, nets=nets, use_pallas=False,
        data=dataclasses.replace(jcfg.data, t_steps=t),
        smc=dataclasses.replace(jcfg.smc, n_particles=k, kernel_rng=False))


def preset_configs(preset, k=None):
    jcfg = jconfig.PRESETS[preset]
    jcfg = _cut(jcfg, k or min(jcfg.smc.n_particles, 64))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def mode_configs(mode, base="fhn_fivo_k128", objective=None, t=T, k=None):
    smc_kw, data_kw, covs, k_mode = MODES[mode]
    k = k or k_mode
    jcfg = jconfig.PRESETS[base]
    smc_kw = dict(smc_kw, **({"objective": objective} if objective else {}))
    jcfg = dataclasses.replace(jcfg, smc=dataclasses.replace(jcfg.smc, **smc_kw),
                               data=dataclasses.replace(jcfg.data, **data_kw))
    jcfg = jcfg.with_nets(**{n: dataclasses.replace(jcfg.net(n), cov_type=c)
                             for n, c in covs.items()})
    jcfg = _cut(jcfg, k, t=t)
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def _data(jcfg, seed=2):
    ys = observations(B, jcfg.data.t_steps, dy=jcfg.data.dy, seed=seed)
    if jcfg.data.emission == "poisson":
        ys = np.round(np.abs(ys) * 2).astype(np.float32)
    u = None
    if jcfg.data.di:
        u = (0.5 * np.random.default_rng(7).standard_normal(
            (B, jcfg.data.t_steps, jcfg.data.di))).astype(np.float32)
    return ys, u


def _compare_objective(jcfg, tcfg, key_seed=9, eval_too=False):
    """The FIVO/IWAE loss and every gradient leaf of the port's objective
    against jax.value_and_grad of the reference's, on the reference's draws."""
    jssm, params, tssm = models(jcfg, tcfg)
    ys, u = _data(jcfg)
    key = jax.random.key(key_seed)
    method = "none" if jcfg.smc.objective == "iwae" else jcfg.smc.resampling
    noise = to_torch(key_noise(jax.random.split(key)[0], B, jcfg.data.t_steps, jcfg.data.dx,
                               jcfg.smc.n_particles, method))
    j_obj = j_make_objective(jssm, jcfg)
    want_loss, want = jax.value_and_grad(lambda p: j_obj(p, key, ys, None, u).loss)(params)
    ctrl = None if u is None else torch.from_numpy(u)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise, controls=ctrl)
    got.loss.backward()
    assert_close(got.loss.detach(), want_loss, 2e-4)
    assert_grads_close(bridge.grads_to_numpy(tssm), want, 5e-3, 5e-4)
    if eval_too:
        want_m = jtrain.make_eval_step(jssm, jcfg)(params, key, ys, None, u)
        got_m = ttrain.make_eval_step(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise,
                                                  controls=ctrl)
        for name in ("elbo", "mse_k", "r2_k", "log_z_fwd", "ess_mean"):
            assert_close(got_m[name], want_m[name], 2e-4)


@pytest.mark.parametrize("preset", GENERAL)
def test_preset_loss_and_gradients_match_reference(preset):
    """Each preset of the slice: log Ẑ's loss and every gradient leaf on the
    same noise; for `fhn_fivo_tril` also the eval step (ELBO, k-step MSE and
    R², ESS; every mode's k-step rollouts: tests/test_torch_modes.py)."""
    jcfg, tcfg = preset_configs(preset)
    _compare_objective(jcfg, tcfg, eval_too=preset == "fhn_fivo_tril")


@pytest.mark.parametrize("mode", ["f tril_head", "poisson", "bootstrap, f tril_head",
                                  "known dynamics, controls"])
def test_mode_loss_and_gradients_match_reference(mode):
    """The modes no preset holds, FIVO at K = 64 and T = 8."""
    jcfg, tcfg = mode_configs(mode, t=8)
    _compare_objective(jcfg, tcfg)


@pytest.mark.parametrize("mode", ["f tril", "f tril_head"])
def test_psvo_with_full_covariance_f_matches_reference(mode):
    """PSVO with a full-covariance f on CPU tensors: the forward, the plain
    FFBSi sweep (the reference's scan body; K5/K6 take the diagonal density
    only) and the selected-path log-joint; the loss, both bounds and every
    gradient leaf on the reference's draws; the smoothed paths equal."""
    jcfg, tcfg = mode_configs(mode, objective="psvo", t=8)
    jcfg = dataclasses.replace(jcfg, smc=dataclasses.replace(jcfg.smc, n_smoothing_particles=4))
    tcfg = tconfig.from_dict(jcfg.to_dict())
    assert not ffbsi.usable(2, 4, tcfg.smc.n_particles, f_tril=SSM(tcfg).f_tril)
    jssm, params, tssm = models(jcfg, tcfg)
    ys, _ = _data(jcfg)
    key = jax.random.key(4)
    noise = psvo_noise(key, B, 8, 2, jcfg.smc.n_particles, 4)
    j_obj = j_make_objective(jssm, jcfg)
    (want_loss, want_out), want = jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o))(j_obj(p, key, ys)), has_aux=True)(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    got.loss.backward()
    assert_close(got.loss.detach(), want_loss, 2e-4)
    for name in ("elbo_psvo_direct", "log_joint_smoothed"):
        assert_close(got.metrics[name].detach(), want_out.metrics[name], 2e-4)
    assert_close(got.smoothed.detach(), want_out.smoothed, 1e-5)
    assert_grads_close(bridge.grads_to_numpy(tssm), want, 5e-3, 5e-4)


def test_svo_with_full_covariance_f_matches_reference():
    """SVO with a "tril" f on CPU tensors: the predictive mixture of ρ_T and
    the sweep's log f take the full covariance; the bound on the reference's
    draws."""
    jcfg, tcfg = mode_configs("f tril", objective="svo", t=8)
    jcfg = dataclasses.replace(jcfg, smc=dataclasses.replace(jcfg.smc, n_smoothing_particles=4))
    tcfg = tconfig.from_dict(jcfg.to_dict())
    jssm, params, tssm = models(jcfg, tcfg)
    assert not svo.usable(tssm, 4)
    ys, _ = _data(jcfg)
    key = jax.random.key(5)
    noise = svo_noise(key, B, 8, 2, jcfg.smc.n_particles, 4)
    want = j_make_objective(jssm, jcfg)(params, key, ys)
    with torch.no_grad():
        got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert_close(got.elbo, want.elbo, 2e-4)
    assert_close(got.smoothed, want.smoothed, 2e-4)


# -- the gates ---------------------------------------------------------------------


def _all_modes():
    return [m for m in MODES if m != "iwae"]


@pytest.mark.parametrize("mode", _all_modes())
@pytest.mark.parametrize("gate", ["fused_step", "trunk", "svo"])
def test_each_kernel_gate_excludes_each_mode(gate, mode):
    """fused_step.usable, trunk.usable and svo.usable hold the base model
    (FHN at K = 128 for the whole-scan gate, the Lorenz-96 trunk shape, the
    SVO preset's sweep) and refuse it in each mode, as the reference's gates
    (`pallas_step.py:143-152`, `pallas_trunk.py:94-99`) — except bootstrap
    mode alone for the SVO sweep, which the reference's SVO gate keeps
    (`pallas_svo.py:104-140`: the sweep never reads the forward proposal)."""
    base = {"fused_step": "fhn_fivo_k128", "trunk": "lorenz96_fivo_k8192_sharded",
            "svo": "lorenz63_svo_k256"}[gate]
    smc_kw, data_kw, covs, _ = MODES[mode]
    cfg = tconfig.PRESETS[base]
    plain = cfg

    def inside(c):
        ssm = SSM(c)
        if gate == "svo":
            return svo.usable(ssm, c.smc.n_smoothing_particles)
        return {"fused_step": fused_step, "trunk": trunk}[gate].usable(ssm, c.smc)

    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, **smc_kw),
                              data=dataclasses.replace(cfg.data, **data_kw))
    cfg = cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), cov_type=c)
                           for n, c in covs.items()})
    assert inside(plain)
    assert inside(cfg) == (gate == "svo" and mode == "bootstrap")


@pytest.mark.parametrize("cov", ["tril", "tril_head"])
def test_ffbsi_gate_excludes_a_full_covariance_f(cov):
    """ffbsi.usable refuses a full-covariance f, as the reference's FFBSi gate
    (`pallas_ffbsi.py:58`), and keeps its class otherwise."""
    cfg = tconfig.PRESETS["lorenz63_psvo_k1024"]
    ssm = SSM(cfg.with_nets(f=dataclasses.replace(cfg.net("f"), cov_type=cov)))
    assert ssm.f_tril
    k = cfg.smc.n_particles
    assert ffbsi.usable(3, 16, k) and ffbsi.usable(3, 16, k, f_tril=False)
    assert not ffbsi.usable(ssm.dx, 16, k, f_tril=ssm.f_tril)


def _reference_route(jssm, smc_cfg, batch):
    if pallas_step.usable(jssm, smc_cfg, batch):
        return "fused"
    if pallas_trunk.usable(jssm, smc_cfg, batch):
        return "trunk"
    return "scan"


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_step, pallas_resample, pallas_trunk):
        monkeypatch.setattr(mod, "_INTERPRET", True)


_ROUTE_CASES = ([("preset", p) for p in sorted(tconfig.PRESETS)]
                + [("mode", m) for m in sorted(MODES)]
                + [("variant", v) for v in ("multinomial", "ess", "iwae k128", "k100", "hidden 12",
                                            "tanh")])


@pytest.mark.parametrize("kind, name", _ROUTE_CASES)
def test_reference_path_agrees_with_the_reference_gates(_interpret, kind, name):
    """smc.reference_path against the reference's own gates in interpret
    mode, at a batch of whole row blocks (32): every preset, every mode, and
    variants on either side of the shape conditions."""
    from psvo_tpu.models.ssm import SSM as JSSM

    if kind == "preset":
        jcfg = jconfig.PRESETS[name]
    elif kind == "mode":
        jcfg, _ = mode_configs(name, t=T, k=16 if name == "iwae" else 128)
        jcfg = dataclasses.replace(jcfg, use_pallas=True)
    else:
        base = jconfig.PRESETS["fhn_fivo_k128"]
        smc_kw = {"multinomial": {"resampling": "multinomial"}, "ess": {"ess_threshold": 0.5},
                  "iwae k128": {"objective": "iwae", "resampling": "none"},
                  "k100": {"n_particles": 100}}.get(name, {})
        jcfg = dataclasses.replace(base, smc=dataclasses.replace(base.smc, **smc_kw))
        if name == "hidden 12":
            jcfg = jcfg.with_nets(**{n: jconfig.NetConfig(hidden=(12, 12)) for n in ("q1", "f", "g")})
        if name == "tanh":
            jcfg = jcfg.with_nets(f=jconfig.NetConfig(activation="tanh"))
    tcfg = tconfig.from_dict(jcfg.to_dict())
    want = _reference_route(JSSM(jcfg), jcfg.smc, 32)
    assert smc.reference_path(SSM(tcfg), tcfg.smc) == want


def test_the_general_presets_take_the_general_path():
    """The four presets of the slice: no port kernel class takes them and the
    reference sends each to its plain scan, so on CUDA tensors they run the
    general path."""
    for preset in GENERAL:
        cfg = tconfig.PRESETS[preset]
        ssm = SSM(cfg)
        assert not fused_step.usable(ssm, cfg.smc) and not trunk.usable(ssm, cfg.smc)
        assert smc.reference_path(ssm, cfg.smc) == "scan", preset


# -- remat ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["f tril", "known dynamics"])
def test_plain_loop_remat_gradients_are_bit_equal(mode, monkeypatch):
    """The plain loop under smc.remat checkpoints each step's
    propose-and-weight part after the resampling: the gradients are bit-equal
    with remat on and off, and the backward never runs the resample again
    (K7's and K8's plain versions once a step, K11's once a step)."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import resampling

    jcfg, tcfg = mode_configs(mode)
    monkeypatch.setattr(resampling, "maybe_resample",
                        lambda *a, _f=resampling.maybe_resample, **k: _f(*a, **k, use_kernel=True))
    ys, _ = _data(jcfg)
    g = torch.Generator().manual_seed(3)
    k = tcfg.smc.n_particles
    noise = (torch.randn((B, 2, k), generator=g), torch.randn((T - 1, B, 2, k), generator=g),
             resampling.bulk_positions(g, T - 1, B, k, "systematic"))
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, remat=remat))
        ssm = SSM(cfg).init(torch.Generator().manual_seed(0))
        plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
                 rg.segment_sum_scatter_reference)
        before = [f.calls for f in plain]
        out = t_make_objective(ssm, cfg)(None, torch.from_numpy(ys), noise=noise)
        out.loss.backward()
        assert [f.calls - n for f, n in zip(plain, before)] == [T - 1] * 3
        grads.append([None if p.grad is None else p.grad.clone() for p in ssm.parameters()])
    assert sum(g is not None for g in grads[0]) > 10
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*grads))
