"""The reference's trunk class in the torch port, against the JAX reference.

The reference sends to its trunk path (`psvo_tpu/smc.py:508-627`) whatever
its trunk gate takes (`pallas_trunk.usable`), which checks neither the
resampling mode nor the gradient mode: ESS-adaptive resampling, no
resampling (IWAE), the full FIVO gradient and controls. The port's
`smc._forward_filter_trunk` takes the same (K7/K8, then K9, per step; K10
and K11 in the backward), and `trunk.usable` admits each at the presets'
widths, (Dx, Dy) = (2, 2), (3, 3) and (40, 40), and beyond them
(`tests/test_torch_trunk_reach.py`).

Small shapes: B = 8, K = 128, T = 5, hidden (16, 16), at Dx = 2 (FHN),
Dx = 3 (Lorenz-63) and the reference's trunk-test shape Dx = Dy = 10
(Lorenz-96 data). The plain versions of K7-K11 run on the CPU; the reference
runs its trunk and resampling kernels in interpret mode with float32
residuals. The reference's key-derived draws are fed to the port. Checked:

- the filter's values and the score surrogate at 2e-4, the ESS at 2e-3;
- every gradient leaf at rtol 5e-3 / atol 5e-4, and with the score term at
  the reference's own leaf-scaled atol (`tests/test_pallas_trunk.py:
  175-200`: the term sums B·K log-normalized-weight picks, which amplify
  last-bit α differences by about K);
- the launches of each step through the plain versions' call counts, the
  CPU's stand-in for the kernels' launch counters;
- `trunk.usable` against `smc.reference_path(...) == "trunk"` for each mode
  at the instantiated widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu import smc as jsmc
from psvo_tpu.ops import pallas_resample, pallas_step, pallas_trunk
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import fused_step, resample_gather, trunk
from tests._torch_port import (
    assert_close, key_noise, models, observations, small_configs, to_torch,
)

torch.set_num_threads(1)

B, K, T, DI = 8, 128, 5, 2
_RTOL, _ATOL = 5e-3, 5e-4
_FIELDS = ("log_z", "increments", "filtered_means", "x_last", "logw_last", "xs", "logws")

# mode -> (smc changes, controls)
MODES = {
    "ess + score": ({"ess_threshold": 0.7, "resampling": "multinomial",
                     "use_stop_gradient": False}, False),
    "iwae": ({"objective": "iwae", "resampling": "none"}, False),
    "controls": ({"ess_threshold": 0.7}, True),
}


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_step, pallas_resample, pallas_trunk):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "BF16_RESIDUALS", False)


def _configs(dx: int, mode: str):
    """(reference Config, port Config) of mode at width dx: FHN (2),
    Lorenz-63 (3) or the reference's Lorenz-96 trunk-test cut (10)."""
    smc_kw, controlled = MODES[mode]
    if dx == 10:
        net = jconfig.NetConfig(hidden=(16, 16))
        jcfg = jconfig.Config(
            name="trunk_class_test",
            data=jconfig.DataConfig(datatype="lorenz96", dx=10, dy=10, t_steps=T),
            smc=jconfig.SMCConfig(n_particles=K, n_smoothing_particles=4, **smc_kw),
        ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5),
                    qb=net)
    else:
        jcfg, _ = small_configs(t=T, datatype="fhn" if dx == 2 else "lorenz63", **smc_kw)
    if controlled:
        jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, di=DI,
                                                                  control_scale=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def _loss(fwd, mean, stop):
    """log Ẑ with the last weights and particles (so that K10 sees more than
    α's cotangents), plus the score term at zero value where there is one."""
    loss = -mean(fwd.log_z) + 1e-3 * mean(fwd.logw_last) + 1e-2 * mean(fwd.x_last)
    if fwd.score_surrogate is not None:
        sur = mean(fwd.score_surrogate)
        loss = loss - (sur - stop(sur))
    return loss


_PLAIN = (resample_gather.ancestor_indices_large_reference,
          resample_gather.gather_particles_reference, trunk.trunk_forward_reference,
          trunk.trunk_backward_reference, resample_gather.segment_sum_scatter_reference)


@pytest.mark.parametrize("dx", [2, 3, 10])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trunk_path_matches_reference(_interpret, mode, dx):
    """The port's trunk path (K7-K11's plain versions) against the reference's
    trunk path in interpret mode on the draws its key gives: the filter with
    its cache and score surrogate, then the loss and every gradient leaf;
    K7/K8/K11 once a step with resampling and never without, K9 and K10
    once a step."""
    jcfg, tcfg = _configs(dx, mode)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, T, dy=dx, seed=3)
    key = jax.random.key(11)
    method = jcfg.smc.resampling
    u = None
    if jcfg.data.di:
        u = (0.5 * np.random.default_rng(7).standard_normal((B, T, DI))).astype(np.float32)

    def reference(p):
        return jsmc._forward_filter_trunk(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                          encoder_inputs=None,
                                          controls=None if u is None else jnp.asarray(u))

    want = reference(params)
    noise = to_torch(key_noise(key, B, T, dx, K, method))
    calls = [f.calls for f in _PLAIN]
    got = tsmc._forward_filter_trunk(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=True,
                                     streams=noise,
                                     controls=None if u is None else torch.from_numpy(u))
    for f in _FIELDS:
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    assert_close(got.ess.detach(), want.ess, 2e-3)
    score = not jcfg.smc.use_stop_gradient
    assert (got.score_surrogate is None) == (want.score_surrogate is None) == (not score)
    if score:
        assert_close(got.score_surrogate.detach(), want.score_surrogate, 2e-4)

    want_loss, want_grads = jax.value_and_grad(
        lambda p: _loss(reference(p), jnp.mean, jax.lax.stop_gradient))(params)
    loss = _loss(got, torch.mean, torch.Tensor.detach)
    for p in tssm.parameters():
        p.grad = None
    loss.backward()
    steps = T - 1
    resampled = steps if method != "none" else 0
    assert [f.calls - n for f, n in zip(_PLAIN, calls)] == [resampled, resampled, steps, steps,
                                                            resampled]
    assert_close(loss.detach(), want_loss, 2e-4)
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_grads)
    flat_got = jax.tree_util.tree_leaves(bridge.grads_to_numpy(tssm))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        w = np.asarray(w)
        atol = max(_ATOL, 1e-4 * float(np.max(np.abs(w)))) if score else _ATOL
        np.testing.assert_allclose(g, w, rtol=_RTOL, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


_GATE_PRESETS = ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024", "lorenz96_fivo_k8192_sharded",
                 "fhn_fivo_controls")
_GATE_MODES = {
    "ess": ({"ess_threshold": 0.5}, {}),
    "iwae": ({"objective": "iwae", "resampling": "none"}, {}),
    "full gradient": ({"resampling": "multinomial", "use_stop_gradient": False}, {}),
    "controls, ess": ({"ess_threshold": 0.5}, {"di": 2, "control_scale": 0.5}),
    "iwae k128": ({"objective": "iwae", "resampling": "none", "n_particles": 128}, {}),
}


@pytest.mark.parametrize("preset", _GATE_PRESETS)
@pytest.mark.parametrize("mode", sorted(_GATE_MODES))
def test_trunk_gate_agrees_with_reference_path(preset, mode):
    """trunk.usable admits each new mode at the instantiated widths exactly
    where the reference's gates send it to the trunk kernel, and the
    whole-scan class stays out of it."""
    smc_kw, data_kw = _GATE_MODES[mode]
    cfg = PRESETS[preset]
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, **smc_kw),
                              data=dataclasses.replace(cfg.data, **data_kw))
    ssm = SSM(cfg)
    assert (ssm.dx, ssm.dy) in trunk.TRUNK_DIMS
    assert tsmc.reference_path(ssm, cfg.smc) == "trunk"
    assert trunk.usable(ssm, cfg.smc)
    assert not fused_step.usable(ssm, cfg.smc)


def test_trunk_gate_outside_the_instantiated_widths():
    """Beyond the presets' (Dx, Dy) and widths the trunk class takes the
    reference's shapes (Dx = Dy = 10; hidden (48, 48) at FHN's width), each
    in a trunk shape library of its own; outside it stay the holes, where
    the reference still runs its trunk kernel and the filter raises on CUDA
    tensors: a width above 64 and a net deeper than K10's streamed tiles
    hold (nine hidden layers of 64 at (55, 55)). K10's tensor-core design
    is Lorenz-96's alone, at the library's widths; the small widths and the
    new shapes take the previous one."""
    jcfg, tcfg = _configs(10, "ess + score")
    ssm = SSM(tcfg)
    assert tsmc.reference_path(ssm, tcfg.smc) == "trunk" and trunk.usable(ssm, tcfg.smc)
    assert trunk.lib_key(10, 10, 16, 1, False) == ("trunk", 10, 10, 16, 0, 0)
    wide = PRESETS["fhn_fivo_k1024_bench"]
    wide = dataclasses.replace(wide, smc=dataclasses.replace(wide.smc, ess_threshold=0.5))
    for hidden, admitted in (((48, 48), True), ((72, 72), False)):
        cfg = wide.with_nets(**{n: dataclasses.replace(wide.net(n), hidden=hidden)
                                for n in ("q1", "f", "g")})
        assert tsmc.reference_path(SSM(cfg), cfg.smc) == "trunk"
        assert trunk.usable(SSM(cfg), cfg.smc) is admitted
        assert tsmc.filter_route(SSM(cfg), cfg.smc, 100, cuda=True) == (
            "trunk" if admitted else "raise")
    l96 = PRESETS["lorenz96_fivo_k8192_sharded"]
    l96 = dataclasses.replace(l96, data=dataclasses.replace(l96.data, dx=55, dy=55))
    for depth, admitted in ((8, True), (9, False)):
        cfg = l96.with_nets(**{n: tconfig.NetConfig(hidden=(64,) * depth)
                               for n in ("q0", "q1", "q2", "f", "qb", "g")})
        assert tsmc.reference_path(SSM(cfg), cfg.smc) == "trunk"
        assert trunk.usable(SSM(cfg), cfg.smc) is admitted
    assert [trunk.k10_design(d, d) for d in (2, 3, 40)] == ["simt", "simt", "tf32x3"]
    assert trunk.k10_design(40, 40, 48, 1) == "simt" == trunk.k10_design(40, 40, 64, 2)
    assert trunk.k10_ok(2, 2, 64, 1, 1024) and not trunk.k10_ok(2, 2, 64, 1, 1024, "tf32x3")
    assert trunk.k10_ok(40, 40, 64, 1, 8192, "tf32x3") and trunk.k10_ok(40, 40, 64, 1, 8192)


def test_trunk_path_runs_from_forward_filter():
    """forward_filter sends an ESS-adaptive FHN configuration, IWAE at K = 128
    and a controlled Lorenz-96 cut to the trunk path on CPU tensors (its
    plain versions), with in-kernel ε replayed through K2's plain version,
    and the result equals the trunk path fed those same streams."""
    _, tcfg = small_configs(t=T, ess_threshold=0.5, kernel_rng=True)
    tssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    ys = torch.from_numpy(observations(4, T, seed=6))
    calls = (trunk.trunk_forward_reference.calls, fused_step.stream_noise_reference.calls,
             fused_step.scan_forward_reference.calls)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, torch.Generator().manual_seed(2), ys, tcfg.smc,
                                  cache=True)
    assert (trunk.trunk_forward_reference.calls - calls[0],
            fused_step.stream_noise_reference.calls - calls[1],
            fused_step.scan_forward_reference.calls - calls[2]) == (T - 1, T - 1, 0)
    gen = torch.Generator().manual_seed(2)
    eps0 = torch.randn((4, 2, K), generator=gen)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen))
    eps = fused_step.stream_noise_reference(seed, T - 1, 4, 2, K)[0]
    from psvo_tpu_torch.ops import resampling
    pos = resampling.bulk_positions(gen, T - 1, 4, K, "systematic")
    with torch.no_grad():
        want = tsmc._forward_filter_trunk(tssm, None, ys, tcfg.smc, cache=True,
                                          streams=(eps0, eps, pos))
    for f in _FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    _, iwae = small_configs(t=T, objective="iwae", resampling="none")
    calls = (trunk.trunk_forward_reference.calls,
             resample_gather.ancestor_indices_large_reference.calls)
    with torch.no_grad():
        out = tsmc.forward_filter(tssm, torch.Generator().manual_seed(3), ys, iwae.smc)
    assert (trunk.trunk_forward_reference.calls - calls[0],
            resample_gather.ancestor_indices_large_reference.calls - calls[1]) == (T - 1, 0)
    assert bool(torch.isfinite(out.log_z).all())
