"""The smoothing sweeps' routes in the port against `psvo_tpu`.

PSVO's FFBSi sweep and SVO's q_b sweep take one of three routes
(`smc.smoothing_route`): the port's kernel class (K5/K6, K12/K13; their plain
versions on CPU tensors), the reference's plain code as eager tensor ops
(`objectives._plain_ffbsi_sweep`, `objectives._svo_scan`) wherever the
reference's own gate sends it to that code, or, on CUDA tensors, an up-front
NotImplementedError where the reference runs a kernel the port has not
widened to.

- `smc.reference_svo_path` and `smc.reference_ffbsi_path` against the
  reference's `pallas_svo.usable` / `pallas_ffbsi.usable` in interpret mode
  at a batch of whole row blocks, over a grid of modes and shapes.
- The pure dispatch rule, and each route's decision on a CUDA device and
  a CPU one (the flag alone: no card is needed to decide).
- The eager sweeps against the reference on CPU tensors in configurations
  the routes newly serve on the card: SVO with known dynamics, PSVO at
  K = 96 (K % 128 != 0: the reference's jnp FFBSi), PSVO with Dirac
  emissions. Loss and every gradient leaf at 2e-4 and rtol 5e-3 /
  atol 5e-4 (`tests/test_torch_svo.py`'s tolerances).
"""

import dataclasses

import jax
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.models.ssm import SSM as JSSM
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_ffbsi, pallas_svo
from psvo_tpu.ops.pallas_resample import ROW_BLOCK
from psvo_tpu_torch import bridge, objectives, smc
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, svo
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, psvo_noise, svo_noise,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B = 8


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_ffbsi, pallas_svo):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _variant(preset, smc_kw=None, data_kw=None, nets=None):
    """The reference's preset with smc/data changes and nets {name: changes}."""
    jcfg = jconfig.PRESETS[preset]
    jcfg = dataclasses.replace(jcfg, smc=dataclasses.replace(jcfg.smc, **(smc_kw or {})),
                               data=dataclasses.replace(jcfg.data, **(data_kw or {})))
    return jcfg.with_nets(**{n: dataclasses.replace(jcfg.net(n), **kw)
                             for n, kw in (nets or {}).items()})


# The grid's models: (name, smc changes, data changes, nets changes)
_SVO_MODELS = [
    ("preset", {}, {}, {}),
    ("qb_rnn", {"qb_rnn": True}, {}, {}),
    ("known dynamics", {"transition": "known"}, {}, {}),
    ("poisson", {}, {"emission": "poisson"}, {}),
    ("dirac", {}, {"emission": "dirac"}, {}),
    ("f head", {}, {}, {"f": {"cov_type": "head"}}),
    ("g tril", {}, {}, {"g": {"cov_type": "tril"}}),
    ("f tril_head", {}, {}, {"f": {"cov_type": "tril_head"}}),
    ("bootstrap", {"use_bootstrap": True}, {}, {}),
    ("controls Dx+Di=7", {}, {"di": 4}, {}),
    ("controls Dx+Di=8", {}, {"di": 5}, {}),
    ("Dx=4, Dy=3", {}, {"dx": 4}, {}),
    ("Dx=4, Dy=4", {}, {"dx": 4, "dy": 4}, {}),
    ("qb hidden (16, 32)", {}, {}, {"qb": {"hidden": (16, 32)}}),
    ("hidden 48", {}, {}, {n: {"hidden": (48, 48)} for n in ("qb", "f", "g")}),
    ("hidden 12", {}, {}, {n: {"hidden": (12, 12)} for n in ("qb", "f", "g")}),
    ("f tanh", {}, {}, {"f": {"activation": "tanh"}}),
]


@pytest.mark.parametrize("m", [4, 16, 32, 136, 256])
@pytest.mark.parametrize("name, smc_kw, data_kw, nets", _SVO_MODELS,
                         ids=[c[0] for c in _SVO_MODELS])
def test_reference_svo_path_agrees_with_the_reference_gate(_interpret, name, smc_kw, data_kw,
                                                           nets, m):
    """`smc.reference_svo_path` against `pallas_svo.usable` at B = 32 (whole
    row blocks), the kernels on: every mode, controls on either side of
    Dx + Di = 7, (Dx, Dy) with Dx + Dy on either side of 7, uneven, odd and
    unaligned hidden widths, and M below the kernel's floor, on it, above
    128 off and on the lane multiple."""
    jcfg = _variant("lorenz63_svo_k256", smc_kw, data_kw, nets)
    want = "kernel" if pallas_svo.usable(JSSM(jcfg), 4 * ROW_BLOCK, m) else "plain"
    assert smc.reference_svo_path(SSM(tconfig.from_dict(jcfg.to_dict())), m) == want


_FFBSI_MODELS = [
    ("preset", {}, {}, {}),
    ("f tril", {}, {}, {"f": {"cov_type": "tril"}}),
    ("f tril_head", {}, {}, {"f": {"cov_type": "tril_head"}}),
    ("f head", {}, {}, {"f": {"cov_type": "head"}}),
    ("known dynamics", {"transition": "known"}, {}, {}),
    ("dirac", {}, {"emission": "dirac"}, {}),
    ("poisson", {}, {"emission": "poisson"}, {}),
    ("bootstrap", {"use_bootstrap": True}, {}, {}),
    ("controls", {}, {"di": 5}, {}),
    ("Dx=4", {}, {"dx": 4}, {}),
]


@pytest.mark.parametrize("k, m", [(96, 16), (128, 4), (128, 16), (2048, 8), (2176, 8),
                                  (4096, 16), (1024, 12)])
@pytest.mark.parametrize("name, smc_kw, data_kw, nets", _FFBSI_MODELS,
                         ids=[c[0] for c in _FFBSI_MODELS])
def test_reference_ffbsi_path_agrees_with_the_reference_gate(_interpret, name, smc_kw, data_kw,
                                                             nets, k, m):
    """`smc.reference_ffbsi_path` against `pallas_ffbsi.usable` at B = 32:
    every f mode and other modes, K at 96, 128, 2048, 2176 and 4096, M a
    multiple of 8 or not."""
    jcfg = _variant("lorenz63_psvo_k1024", smc_kw, data_kw, nets)
    want = "kernel" if pallas_ffbsi.usable(JSSM(jcfg), k, 4 * ROW_BLOCK, m) else "plain"
    assert smc.reference_ffbsi_path(SSM(tconfig.from_dict(jcfg.to_dict())), k, m) == want


@pytest.mark.parametrize("port_class, reference, cuda, want", [
    (True, "kernel", True, "kernel"), (True, "plain", True, "kernel"),
    (True, "kernel", False, "kernel"), (True, "plain", False, "kernel"),
    (False, "plain", True, "eager"), (False, "plain", False, "eager"),
    (False, "kernel", True, "raise"), (False, "kernel", False, "eager"),
])
def test_smoothing_route_rule(port_class, reference, cuda, want):
    """The port's class first (even where the reference runs plain code),
    then the eager route where the reference runs plain code or the tensors
    are on the CPU, else a raise."""
    assert smc.smoothing_route(port_class, reference, cuda) == want


def _tmodel(preset, smc_kw=None, data_kw=None, nets=None):
    return SSM(tconfig.from_dict(_variant(preset, smc_kw, data_kw, nets).to_dict()))


# (route label, preset, changes, M, the route on a CUDA device, on a CPU one)
_SVO_ROUTES = [
    ("preset M=16 (K12/K13; the reference's jnp below its M floor)", {}, {}, {}, 16,
     "kernel", "kernel"),
    ("bootstrap (K12/K13)", {"use_bootstrap": True}, {}, {}, 32, "kernel", "kernel"),
    ("qb GRU", {"qb_rnn": True}, {}, {}, 16, "eager", "eager"),
    ("known dynamics", {"transition": "known"}, {}, {}, 16, "eager", "eager"),
    ("qb hidden (16, 32)", {}, {}, {"qb": {"hidden": (16, 32)}}, 16, "eager", "eager"),
    ("Dx + Di = 8", {}, {"di": 5}, {}, 32, "eager", "eager"),
    ("(Dx, Dy) = (4, 3)", {}, {"dx": 4}, {}, 32, "kernel", "kernel"),
    ("hidden 48", {}, {}, {n: {"hidden": (48, 48)} for n in ("qb", "f", "g")}, 32, "kernel",
     "kernel"),
    ("hidden 72 (above the port's widths)", {}, {},
     {n: {"hidden": (72, 72)} for n in ("qb", "f", "g")}, 32, "raise", "eager"),
]


@pytest.mark.parametrize("label, smc_kw, data_kw, nets, m, on_cuda, on_cpu", _SVO_ROUTES,
                         ids=[r[0] for r in _SVO_ROUTES])
def test_svo_route(label, smc_kw, data_kw, nets, m, on_cuda, on_cpu):
    """The q_b sweep's dispatch for a CUDA device and a CPU one; where it
    raises, `_require_cuda_sweep` names the missing class."""
    ssm = _tmodel("lorenz63_svo_k256", smc_kw, data_kw, nets)
    assert objectives._svo_route(ssm, m, True) == on_cuda
    assert objectives._svo_route(ssm, m, False) == on_cpu
    assert (objectives._svo_route(ssm, m, True) == "kernel") == svo.usable(ssm, m)
    if on_cuda == "raise":
        with pytest.raises(NotImplementedError, match="ops.svo.usable"):
            objectives._require_cuda_sweep(ssm, "svo", 256, m)
    else:
        objectives._require_cuda_sweep(ssm, "svo", 256, m)


_FFBSI_ROUTES = [
    ("Lorenz-63 K=1024 M=16 (K5/K6)", "lorenz63_psvo_k1024", {}, {}, {}, 1024, 16, "kernel",
     "kernel"),
    ("K=96 (K5/K6; the reference's jnp)", "lorenz63_psvo_k1024", {}, {}, {}, 96, 16, "kernel",
     "kernel"),
    ("f tril", "lorenz63_psvo_k1024", {}, {}, {"f": {"cov_type": "tril"}}, 128, 16, "eager",
     "eager"),
    ("Lorenz-96 K=8192", "lorenz96_fivo_k8192_sharded", {}, {}, {}, 8192, 16, "eager", "eager"),
    ("Lorenz-96 K=1024", "lorenz96_fivo_k8192_sharded", {}, {}, {}, 1024, 16, "kernel",
     "kernel"),
    ("Dx=4 K=128 M=12", "lorenz63_psvo_k1024", {}, {"dx": 4}, {}, 128, 12, "eager", "eager"),
    ("Dx=4 K=128 M=8", "lorenz63_psvo_k1024", {}, {"dx": 4}, {}, 128, 8, "kernel", "kernel"),
    ("M=512", "lorenz63_psvo_k1024", {}, {}, {}, 1024, 512, "kernel", "kernel"),
    ("Dx=912 (above K6 wide's shared memory)", "lorenz63_psvo_k1024", {}, {"dx": 912}, {}, 128,
     8, "raise", "eager"),
]


@pytest.mark.parametrize("label, preset, smc_kw, data_kw, nets, k, m, on_cuda, on_cpu",
                         _FFBSI_ROUTES, ids=[r[0] for r in _FFBSI_ROUTES])
def test_ffbsi_route(label, preset, smc_kw, data_kw, nets, k, m, on_cuda, on_cpu):
    """The FFBSi sweep's dispatch for a CUDA device and a CPU one; where it
    raises, `_require_cuda_sweep` names the missing class."""
    ssm = _tmodel(preset, smc_kw, data_kw, nets)
    assert objectives._ffbsi_route(ssm, k, m, True) == on_cuda
    assert objectives._ffbsi_route(ssm, k, m, False) == on_cpu
    if on_cuda == "raise":
        with pytest.raises(NotImplementedError, match="ops.ffbsi.usable"):
            objectives._require_cuda_sweep(ssm, "psvo", k, m)
    else:
        objectives._require_cuda_sweep(ssm, "psvo", k, m)


# -- the eager sweeps against the reference ---------------------------------------------


def _small(preset, k, t, m, smc_kw=None, data_kw=None):
    """The reference's preset at hidden (16, 16), K = k, T = t, M = m, its
    plain code (use_pallas off), streamed noise; and the port's config."""
    net = jconfig.NetConfig(hidden=(16, 16))
    jcfg = _variant(preset, dict(smc_kw or {}, n_particles=k, n_smoothing_particles=m,
                                 kernel_rng=False),
                    dict(data_kw or {}, t_steps=t))
    jcfg = jcfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                          g=dataclasses.replace(net, sigma_init=0.5))
    jcfg = dataclasses.replace(jcfg, use_pallas=False)
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def _compare(jcfg, tcfg, noise_fn, key_seed, ys, extra=()):
    jssm, params, tssm = models(jcfg, tcfg)
    key = jax.random.key(key_seed)
    j_obj = j_make_objective(jssm, jcfg)
    (want_loss, want_out), want = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o))(j_obj(p, key, ys)), has_aux=True))(params)
    t, dx, k, m = jcfg.data.t_steps, jcfg.data.dx, jcfg.smc.n_particles, \
        jcfg.smc.n_smoothing_particles
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=noise_fn(key, B, t, dx, k, m))
    got.loss.backward()
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want_out.elbo, _TOL)
    for name in extra:
        assert_close(got.metrics[name].detach(), want_out.metrics[name], _TOL)
    assert_close(got.smoothed.detach(), want_out.smoothed, _TOL)
    assert_grads_close(bridge.grads_to_numpy(tssm), want, _RTOL, _ATOL)


def test_svo_known_dynamics_eager_sweep_matches_reference():
    """SVO with known dynamics (Lorenz-63, K = 128, M = 8, T = 6): the forward
    through the plain loop, the q_b sweep through `_svo_scan` (the
    reference's jnp scan), against jax.value_and_grad of the reference."""
    jcfg, tcfg = _small("lorenz63_svo_k256", 128, 6, 8, {"transition": "known"})
    assert objectives._svo_route(SSM(tcfg), 8, True) == "eager"
    plain = svo.svo_sweep_forward_reference.calls
    _compare(jcfg, tcfg, svo_noise, 31, observations(B, 6, dy=3, seed=6), ("elbo_svo",))
    assert svo.svo_sweep_forward_reference.calls == plain


@pytest.mark.parametrize("route", ["dispatch", "eager"])
def test_psvo_k96_matches_reference(route, monkeypatch):
    """PSVO on FHN at K = 96 (K % 128 != 0: the reference's forward is its
    plain scan and its FFBSi the jnp body), M = 4, T = 6, both bounds'
    metrics: through the port's dispatch (K5/K6's class: their plain
    versions) and with the eager sweep forced (`_plain_ffbsi_sweep` on a
    diagonal f)."""
    jcfg, tcfg = _small("fhn_fivo_k128", 96, 6, 4, {"objective": "psvo"})
    if route == "eager":
        monkeypatch.setattr(objectives, "_ffbsi_route", lambda *a: "eager")
    calls = ffbsi.ffbsi_forward_reference.calls
    _compare(jcfg, tcfg, psvo_noise, 32, observations(B, 6, dy=2, seed=7),
             ("elbo_psvo_direct", "log_joint_smoothed"))
    assert ffbsi.ffbsi_forward_reference.calls - calls == (1 if route == "dispatch" else 0)


def test_psvo_dirac_matches_reference():
    """PSVO with Dirac emissions (FHN, K = 128, M = 8, T = 6): the forward
    through the plain loop, the FFBSi sweep through K5/K6's plain versions
    (the reference's FFBSi kernel class), against the reference's."""
    jcfg, tcfg = _small("fhn_fivo_dirac", 128, 6, 8, {"objective": "psvo"})
    assert objectives._ffbsi_route(SSM(tcfg), 128, 8, True) == "kernel"
    calls = (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls)
    _compare(jcfg, tcfg, psvo_noise, 33, observations(B, 6, dy=2, seed=8),
             ("elbo_psvo_direct", "log_joint_smoothed"))
    assert (ffbsi.ffbsi_forward_reference.calls - calls[0],
            ffbsi.ffbsi_backward_reference.calls - calls[1]) == (1, 1)
