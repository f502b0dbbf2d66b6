"""Exogenous controls (data.di > 0, the preset `fhn_fivo_controls`) in the
torch port, against the JAX reference.

Both packages run the same controlled model (params bridged, q1's and f's
first layers [Dx + Di, H]) on the same observations and controls, made from
a numpy seed, with the reference's key-derived noise, at a small size (B = 8,
K = 128, T <= 8, hidden (16, 16), Di = 2). Tolerances are those of the
uncontrolled slices: 2e-4 on log Ẑ, the increments, the filtered means and
the particles, 2e-3 on the ESS (tests/test_torch_slice.py), rtol 5e-3 /
atol 5e-4 on every gradient leaf (the reference's own fused-vs-unfused
gradient test, tests/test_pallas_step.py). Checked:

- the plain filter body against `psvo_tpu.smc.forward_filter(...,
  controls=)` through the noise hook;
- the kernels' plain versions (`fused_step.scan_forward_reference` through
  `smc._forward_filter_fused`, and the per-step path's
  `step_forward_reference` with `fused_step.SCAN_FUSED` off) against the
  reference's whole-scan and per-step kernels in interpret mode;
- the FIVO loss and every gradient leaf, through the plain body and through
  both kernel paths' plain VJPs, against `jax.value_and_grad`;
- `make_eval_step` with the k-step rollouts on the shifted controls,
  `filter_posterior`'s control checks, negated controls moving log Ẑ;
- the controlled simulator step and the npz round trip;
- the kernel-class gates for a controlled model (the FFBSi and SVO sweeps
  take one; tests/test_torch_controlled_smoothing.py holds them to the
  reference), and the refusals (the trunk class, an unbuilt shape).
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import data as jdata
from psvo_tpu import infer as jinfer
from psvo_tpu import smc as jsmc
from psvo_tpu import train as jtrain
from psvo_tpu.models.ssm import SSM as JSSM
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import data as tdata
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.config import PRESETS, DataConfig
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import _build, ffbsi, fused_step, svo, trunk
from tests._torch_port import assert_close, key_noise, models, observations, small_configs, to_torch

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4
_FIELDS_2E4 = ("log_z", "increments", "filtered_means", "x_last", "logw_last")
DI = 2


def controlled_configs(t=6, di=DI, datatype="fhn", **smc_kw):
    """(reference Config, port Config) of the small FHN (or Lorenz-63) slice
    with di exogenous controls, control_scale 0.5 as the preset."""
    jcfg, _ = small_configs(t=t, datatype=datatype, **smc_kw)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, di=di, control_scale=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def controls(batch, t_steps, di=DI, seed=11):
    return (0.5 * np.random.default_rng(seed).standard_normal((batch, t_steps, di))).astype(
        np.float32)


def _compare_filter(got, want, cache):
    for f in _FIELDS_2E4 + (("xs", "logws") if cache else ()):
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    assert_close(got.ess.detach(), want.ess, 2e-3)


def _assert_grads_close(tssm, want_tree):
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_got = jax.tree_util.tree_leaves(bridge.grads_to_numpy(tssm))
    assert len(flat_got) == len(flat_want)
    for (path, want), got in zip(flat_want, flat_got):
        np.testing.assert_allclose(got, np.asarray(want), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _backward(tssm, loss):
    for p in tssm.parameters():
        p.grad = None
    loss.backward()


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


# -- model and data -------------------------------------------------------------


def test_controlled_heads_and_bridge_shapes():
    """q1 and f take [x; u] (first layers [Dx + Di, H]); g, q0, q2 and qb do
    not. The bridge carries the reference's [Dx + Di, H] layers across and
    refuses a tree of another shape."""
    jcfg, tcfg = controlled_configs()
    _, params, tssm = models(jcfg, tcfg)
    for name, din in (("q1", 2 + DI), ("f", 2 + DI), ("g", 2), ("q0", 2), ("q2", 2),
                      ("qb", 4)):
        assert tuple(tssm.heads[name].weights[0].shape) == (din, 16), name
        assert np.asarray(params[name]["layers"][0][0]).shape == (din, 16), name
    tree = bridge.params_to_numpy(tssm)
    for (w, _), (wj, _) in zip(tree["q1"]["layers"], params["q1"]["layers"]):
        np.testing.assert_array_equal(w, np.asarray(wj))
    _, plain_cfg = small_configs()
    with pytest.raises(ValueError, match="shape"):
        bridge.load_numpy_params(SSM(plain_cfg), tree)


@pytest.mark.parametrize("u_shape", ["per_row", "position_matched"])
def test_transition_with_controls_matches_reference(u_shape):
    """transition_params / transition_mean with u [B, Di] broadcast over the
    middle axes or position-matched [B, T, Di], and the channel-major
    step heads with u [B, Di], against the reference (1e-6)."""
    jcfg, tcfg = controlled_configs()
    jssm, params, tssm = models(jcfg, tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 2)).astype(np.float32)
    u = rng.standard_normal((4, DI) if u_shape == "per_row" else (4, 5, DI)).astype(np.float32)
    with torch.no_grad():
        got = tssm.transition_params(torch.from_numpy(x), torch.from_numpy(u))
        got_mean = tssm.transition_mean(torch.from_numpy(x), torch.from_numpy(u))
    want = jssm.transition_params(params, x, u)
    assert_close(got[0], want[0], 1e-6)
    assert_close(got[1], want[1], 1e-6)
    assert_close(got_mean, jssm.transition_mean(params, x, u), 1e-6)
    x_cm = rng.standard_normal((4, 2, 16)).astype(np.float32)
    u_row = rng.standard_normal((4, DI)).astype(np.float32)
    y = rng.standard_normal((4, 2)).astype(np.float32)
    with torch.no_grad():
        got = tssm.step_heads_cm(torch.from_numpy(x_cm), torch.from_numpy(y), None,
                                 torch.from_numpy(u_row))
    for a, b in zip(got, jssm.step_heads_cm(params, x_cm, y, u_row)):
        assert_close(a, b, 1e-6)


def test_controlled_simulator_matches_reference_on_its_draws():
    """x_{t+1} = step(x_t) + u_t·b_ctrl + proc_scale·n on the reference's own
    draws (psvo_tpu/data.py::_simulate's key schedule, controls included),
    and the port's own dataset: controls [n, T, Di] split like the
    observations, b_ctrl [Di, Dx] scaled by control_scale/√Di."""
    kw = dict(t_steps=12, n_train=3, n_test=2, di=DI, control_scale=0.5)
    cfg_j, cfg_t = jdata.DataConfig(**kw), DataConfig(**kw)
    ds = jdata.generate_dataset(cfg_j, seed=4)
    n = cfg_j.n_train + cfg_j.n_test
    k_x0, k_proc, k_obs, _, k_ctrl, k_cmat = jax.random.split(jax.random.key(4), 6)
    x0 = jax.random.normal(k_x0, (n, 2))
    draw = jax.vmap(lambda k: jax.random.normal(k, (n, 2)))
    proc, obs = draw(jax.random.split(k_proc, 12)), draw(jax.random.split(k_obs, 12))
    u = jax.random.normal(k_ctrl, (12, n, DI))
    b_ctrl = 0.5 * jax.random.normal(k_cmat, (DI, 2)) / np.sqrt(DI)
    hidden, ys = tdata.simulate_from_noise(
        cfg_t, torch.eye(2), *(torch.tensor(np.asarray(a)) for a in (x0, proc, obs, u, b_ctrl)))
    assert_close(hidden, np.concatenate([ds.hidden_train, ds.hidden_test]), 1e-4)
    assert_close(ys, np.concatenate([ds.obs_train, ds.obs_test]), 1e-4)
    assert_close(np.concatenate([ds.controls_train, ds.controls_test]),
                 np.swapaxes(np.asarray(u), 0, 1), 0)
    assert_close(ds.control_matrix, b_ctrl, 1e-6)  # jit rounds the scaling its own way
    # one step by hand: the formula of psvo_tpu/data.py on the same arrays
    step = tdata.dyn.make_stepper(cfg_t)
    x1 = step.step(hidden[:, 0]) + torch.tensor(np.asarray(u[1])) @ torch.tensor(
        np.asarray(b_ctrl)) + cfg_t.proc_scale * torch.tensor(np.asarray(proc[1]))
    assert_close(x1, hidden[:, 1], 1e-6)
    port = tdata.generate_dataset(cfg_t, seed=4)
    assert port.controls_train.shape == (3, 12, DI) and port.controls_test.shape == (2, 12, DI)
    assert port.control_matrix.shape == (DI, 2)
    assert bool(torch.isfinite(port.hidden_train).all())
    with pytest.raises(ValueError, match="controls"):
        tdata.simulate_from_noise(cfg_t, torch.eye(2), *(torch.tensor(np.asarray(a))
                                                         for a in (x0, proc, obs)))


def test_controlled_dataset_file_is_shared(tmp_path):
    """The npz round trip with controls, both ways between the packages (the
    port's analog of tests/test_parity_modes.py::test_controls_dataset_roundtrip)."""
    cfg = jdata.DataConfig(datatype="fhn", dx=2, dy=2, di=3, t_steps=6, n_train=4, n_test=2)
    ds = jdata.generate_dataset(cfg, 0)
    jdata.save_dataset(ds, tmp_path / "jax.npz")
    got = tdata.load_dataset(tmp_path / "jax.npz")
    for f in ("controls_train", "controls_test", "control_matrix", "obs_train"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ds, f)))
    own = tdata.generate_dataset(DataConfig(datatype="fhn", dx=2, dy=2, di=3, t_steps=6,
                                            n_train=4, n_test=2), 0)
    tdata.save_dataset(own, tmp_path / "torch.npz")
    back = jdata.load_dataset(tmp_path / "torch.npz")
    np.testing.assert_array_equal(np.asarray(back.controls_test), own.controls_test.numpy())
    np.testing.assert_array_equal(np.asarray(back.control_matrix), own.control_matrix.numpy())


# -- the filter ---------------------------------------------------------------------


@pytest.mark.parametrize("cache", [True, False])
def test_plain_filter_matches_reference(cache):
    """The plain step body (the noise hook on CPU tensors) against the
    reference's plain scan with controls."""
    jcfg, tcfg = controlled_configs(t=7)
    jssm, params, tssm = models(jcfg, tcfg)
    ys, u = observations(8, 7), controls(8, 7)
    noise = key_noise(jax.random.key(5), 8, 7, 2, 128)
    want = jsmc.forward_filter(jssm, params, None, ys, jcfg.smc, cache=cache, noise=noise,
                               controls=u)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=cache,
                                  noise=to_torch(noise), controls=torch.from_numpy(u))
    _compare_filter(got, want, cache)


def _fused_pair(scan_fused, cache, monkeypatch, t=5):
    """(params, port model, reference filter of params, port filter) on the
    kernel path of both packages, toggles set to scan_fused, same controls
    and key-derived streams."""
    monkeypatch.setattr(pallas_step, "SCAN_FUSED", scan_fused)
    monkeypatch.setattr(fused_step, "SCAN_FUSED", scan_fused)
    jcfg, tcfg = controlled_configs(t=t, kernel_rng=True)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, 8) and fused_step.usable(tssm, tcfg.smc)
    ys, u = observations(8, t, seed=3), controls(8, t, seed=4)
    key = jax.random.key(11)

    def reference(p):
        return jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=cache,
                                          encoder_inputs=None, controls=jnp.asarray(u))

    def port():
        return tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc,
                                          cache=cache, controls=torch.from_numpy(u),
                                          streams=to_torch(key_noise(key, 8, t, 2, 128)))

    return params, tssm, reference, port


def _calls():
    return [f.calls for f in (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
                              fused_step.step_forward_reference,
                              fused_step.step_backward_reference)]


@pytest.mark.parametrize("scan_fused, cache", [(True, True), (True, False), (False, True)])
def test_kernel_plain_versions_match_reference_kernels(_interpret, monkeypatch, scan_fused, cache):
    """scan_forward_reference (whole scan) or T−1 step_forward_reference
    calls (per-step path) with the controls' coefficient columns, against
    the reference's whole-scan or per-step kernels in interpret mode, whose
    carry holds u_t in its pad rows."""
    params, _, reference, port = _fused_pair(scan_fused, cache, monkeypatch)
    want = reference(params)
    before = _calls()
    with torch.no_grad():
        got = port()
    ran = [a - b for a, b in zip(_calls(), before)]
    assert ran == ([1, 0, 0, 0] if scan_fused else [0, 0, 4, 0])
    _compare_filter(got, want, cache)


@pytest.mark.parametrize("scan_fused", [True, False])
def test_kernel_path_gradients_match_reference(_interpret, monkeypatch, scan_fused):
    """−mean(log Ẑ) plus small terms on the other outputs through ScanForward
    (scan_backward_reference) or StepForward (step_backward_reference)
    against jax.value_and_grad through the reference's kernels: every leaf,
    q1's and f's [Dx + Di, H] first layers included. The controls get no
    gradient (they are data)."""
    params, tssm, reference, port = _fused_pair(scan_fused, False, monkeypatch)

    def loss_of(fwd, mean):
        return (-mean(fwd.log_z) + 1e-2 * mean(fwd.x_last) + 1e-3 * mean(fwd.logw_last)
                + 1e-3 * mean(fwd.ess) + 1e-2 * mean(fwd.filtered_means))

    want_loss, want = jax.value_and_grad(lambda p: loss_of(reference(p), jnp.mean))(params)
    before = _calls()
    loss = loss_of(port(), torch.mean)
    _backward(tssm, loss)
    ran = [a - b for a, b in zip(_calls(), before)]
    assert ran == ([1, 1, 0, 0] if scan_fused else [0, 0, 4, 4])
    assert_close(loss.detach(), want_loss, 2e-4)
    _assert_grads_close(tssm, want)
    for name in ("q1", "f"):
        assert float(tssm.heads[name].weights[0].grad[2:].abs().sum()) > 0, name


def test_fivo_objective_gradients_and_eval_match_reference():
    """make_objective(...)(..., controls=) on the plain body: the FIVO loss
    and every gradient leaf against jax.value_and_grad of the reference's
    objective (its plain scan), then make_eval_step, whose k-step rollouts
    take u_{t+j} (2e-4)."""
    jcfg, tcfg = controlled_configs(t=8)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    ys, u = observations(8, 8, seed=2), controls(8, 8, seed=6)
    key = jax.random.key(9)
    noise = to_torch(key_noise(jax.random.split(key)[0], 8, 8, 2, 128))
    j_obj = j_make_objective(jssm, jcfg)
    want_loss, want = jax.value_and_grad(lambda p: j_obj(p, key, ys, None, u).loss)(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise,
                                       controls=torch.from_numpy(u))
    _backward(tssm, got.loss)
    assert_close(got.loss.detach(), want_loss, 2e-4)
    _assert_grads_close(tssm, want)

    want_m = jtrain.make_eval_step(jssm, jcfg)(params, key, ys, None, u)
    got_m = ttrain.make_eval_step(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise,
                                              controls=torch.from_numpy(u))
    assert set(got_m) == set(want_m)
    for name in ("elbo", "mse_k", "r2_k"):
        assert_close(got_m[name], want_m[name], 2e-4)
    fm = np.array(jtrain.filtered_means(jsmc.forward_filter(
        jssm, params, None, ys, jcfg.smc, noise=tuple(np.asarray(n) for n in noise),
        controls=u)))
    want_p = jtrain.k_step_predictions(jssm, params, fm, 3, u)
    with torch.no_grad():
        got_p = ttrain.k_step_predictions(tssm, torch.from_numpy(fm), 3, torch.from_numpy(u))
    assert_close(got_p, want_p, 2e-4)


def test_negated_controls_change_log_z_and_zero_controls_equal_none():
    """Controls reach the model: negating them moves log Ẑ (the port's analog
    of tests/test_pallas_step.py::test_fused_controls_match_unfused) on the
    plain body and on the kernels' plain versions; controls=None runs zeros,
    as the reference's _controls_tm."""
    _, tcfg = controlled_configs(t=5)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys, u = torch.from_numpy(observations(8, 5)), torch.from_numpy(controls(8, 5))
    noise = tsmc._draw_noise(torch.Generator().manual_seed(1), tcfg.smc, 5, 8, 2)
    with torch.no_grad():
        for run in (lambda c: tsmc.forward_filter(tssm, None, ys, tcfg.smc, noise=noise,
                                                  controls=c),
                    lambda c: tsmc._forward_filter_fused(tssm, None, ys, tcfg.smc, cache=False,
                                                         streams=noise, controls=c)):
            lz, lz_neg = run(u).log_z, run(-u).log_z
            assert float((lz - lz_neg).abs().max()) > 1e-3
            assert torch.equal(run(None).log_z, run(torch.zeros_like(u)).log_z)


def test_filter_posterior_checks_controls_and_matches_reference():
    """filter_posterior with controls against the reference's (2e-4); a di > 0
    model without controls raises, as does a di = 0 model given some, in
    filter_posterior and smooth_posterior alike (infer._check_controls)."""
    jcfg, tcfg = controlled_configs(t=4)
    jssm, params, tssm = models(jcfg, tcfg)
    ys, u = observations(8, 4, seed=4), controls(8, 4, seed=5)
    key = jax.random.key(21)
    noise = to_torch(key_noise(key, 8, 4, 2, 128))
    want = jinfer.filter_posterior(jssm, params, ys, jcfg, key, return_particles=True,
                                   controls=u)
    got = tinfer.filter_posterior(tssm, torch.from_numpy(ys), tcfg, return_particles=True,
                                  noise=noise, controls=torch.from_numpy(u))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a, b, 2e-4)
    with pytest.raises(ValueError, match="controls=\\[B, T, di\\]"):
        tinfer.filter_posterior(tssm, torch.from_numpy(ys), tcfg, noise=noise)
    with pytest.raises(ValueError, match="controls=\\[B, T, di\\]"):
        tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg)
    _, plain_cfg = small_configs(t=4)
    plain = init_ssm(plain_cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="di=0"):
        tinfer.filter_posterior(plain, torch.from_numpy(ys), plain_cfg,
                                controls=torch.from_numpy(u))


def test_train_step_takes_controls_per_step():
    """make_train_step(...)(gen, batch, controls=) with steps_per_call N:
    controls [N, B, T, Di], N steps in one call equal to N single calls."""
    _, tcfg = controlled_configs(t=5)
    gens = []
    for n in (1, 2):
        cfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, steps_per_call=n))
        tssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = ttrain.make_train_step(tssm, cfg, ttrain.make_optimizer(cfg))
        ys = torch.from_numpy(observations(2 * 4, 5, seed=8)).reshape(2, 4, 5, 2)
        u = torch.from_numpy(controls(2 * 4, 5, seed=9)).reshape(2, 4, 5, DI)
        gen = torch.Generator().manual_seed(3)
        if n == 1:
            for i in range(2):
                step(gen, ys[i], controls=u[i])
        else:
            step(gen, ys, controls=u)
        gens.append([p.detach().clone() for p in tssm.parameters()])
    for a, b in zip(*gens):
        assert torch.equal(a, b)


# -- the kernel classes ---------------------------------------------------------------


@pytest.mark.parametrize("datatype, di, want", [
    ("fhn", 2, True), ("fhn", 5, True), ("fhn", 6, False),
    ("lorenz63", 2, True), ("lorenz63", 4, True), ("lorenz63", 5, False),
])
def test_fused_step_gate_admits_built_controlled_shapes(_interpret, datatype, di, want):
    """fused_step.usable takes controls at the built (Dx, Dy) with Dx + Di <= 7
    (the reference's gate), as pallas_step.usable does."""
    jcfg, tcfg = controlled_configs(datatype=datatype, di=di)
    assert fused_step.usable(SSM(tcfg), tcfg.smc) is want
    assert pallas_step.usable(JSSM(jcfg), jcfg.smc, 8) is want


def test_other_kernel_classes_refuse_controls():
    """The trunk class (K7–K11, K9 and K10 in their control mode) takes a
    controlled model as the reference's trunk gate does, while
    max(Dx + Di, Dy) + 1 fits its 56 state rows, and refuses one beyond.
    The FFBSi sweep (K5/K6, whose support terms take the controls) and
    SVO's (K12/K13, in their control mode) take one while Dx + Di <= 7, as
    the reference's SVO gate (`pallas_svo.py:122`)."""
    l96 = PRESETS["lorenz96_fivo_k8192_sharded"]
    l96_ctrl = dataclasses.replace(l96, data=dataclasses.replace(l96.data, di=2))
    l96_wide = dataclasses.replace(l96, data=dataclasses.replace(l96.data, di=16))
    assert trunk.usable(SSM(l96), l96.smc) and trunk.usable(SSM(l96_ctrl), l96_ctrl.smc)
    assert not trunk.usable(SSM(l96_wide), l96_wide.smc)
    assert ffbsi.usable(2, 16, 1024) and ffbsi.usable(3, 16, 1024)
    svo_cfg = PRESETS["lorenz63_svo_k256"]
    for di, want in ((0, True), (2, True), (4, True), (5, False)):
        cfg = dataclasses.replace(svo_cfg, data=dataclasses.replace(svo_cfg.data, di=di))
        assert svo.usable(SSM(cfg), 16) is want, di


@pytest.mark.parametrize("objective", ["psvo", "svo"])
def test_smoothing_objectives_refuse_controls(objective):
    """PSVO and SVO with di > 0 no longer refuse: their support terms and
    sweeps take the controls, and the objective runs on CPU tensors with
    finite values; negated controls move its loss (the controls reach the
    backward pass). tests/test_torch_controlled_smoothing.py holds them to
    the reference."""
    _, tcfg = controlled_configs(objective=objective, n_smoothing_particles=4)
    tssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    ys = torch.from_numpy(observations(4, 6, seed=2))
    u = torch.from_numpy(controls(4, 6))
    losses = []
    for sign in (1.0, -1.0):
        with torch.no_grad():
            out = t_make_objective(tssm, tcfg)(torch.Generator().manual_seed(1), ys,
                                               controls=sign * u)
        assert bool(torch.isfinite(out.loss)) and bool(torch.isfinite(out.smoothed).all())
        losses.append(float(out.loss))
    assert abs(losses[0] - losses[1]) > 1e-4


def test_the_controlled_preset_is_in_the_kernel_class():
    cfg = PRESETS["fhn_fivo_controls"]
    ssm = SSM(cfg)
    assert (cfg.data.di, cfg.data.control_scale, cfg.smc.n_particles) == (2, 0.5, 128)
    assert fused_step.usable(ssm, cfg.smc)
    consts = fused_step.prepare(ssm)
    assert tuple(consts["ctrl_w"].shape) == (2, 128)
    assert fused_step.coef_width(consts) == 3 * 2 + 2 + 1 + 128
    # one middle layer at width 64: K4 and K15 take it, with room for the control sums
    assert fused_step._k4_class(consts, 128) and fused_step._k15_ok(consts, 128)
    assert (fused_step.k4_smem_bytes(consts, 128)
            == fused_step.k4_smem_bytes(dict(consts, di=0), 128) + 4 * 2 * 64 + 8 * 4 * 64)
    assert (fused_step.k1_smem_bytes(consts, 128)
            == fused_step.k1_smem_bytes(dict(consts, di=0), 128) + 4 * 2 * 64)


def test_control_term_layout():
    """prepare's packed buffer holds W1's first Dx rows of q1 and f and
    ctrl_w their last Di rows, q1's then f's; control_term is u·ctrl_w and
    pack_coef appends it after ab. Without controls the buffer and the row
    are as before (ctrl_w None)."""
    _, tcfg = controlled_configs()
    ssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    consts = fused_step.prepare(ssm)
    q1, f, _ = fused_step._unpack_nets(consts)
    assert torch.equal(q1[0][0][0], ssm.heads["q1"].weights[0][:2])
    assert torch.equal(f[0][0][0], ssm.heads["f"].weights[0][:2])
    w1q, w1f = ssm.heads["q1"].weights[0], ssm.heads["f"].weights[0]
    assert torch.equal(consts["ctrl_w"], torch.cat([w1q[2:], w1f[2:]], dim=1))
    u = torch.randn(3, 4, DI)
    c = fused_step.control_term(consts, u)
    assert_close(c[..., :16].detach(), (u @ w1q[2:]).detach(), 1e-6)
    z = torch.zeros(3, 4, 2)
    coef = fused_step.pack_coef(z, z, z, z, torch.zeros(3, 4), c)
    assert coef.shape == (3, 4, fused_step.coef_width(consts))
    aq, cq, sq, y, ab, cb = fused_step._split_coef(coef[0], consts)
    assert torch.equal(cb[0], c[0, :, :16]) and torch.equal(cb[1], c[0, :, 16:])
    _, plain_cfg = small_configs()
    plain = SSM(plain_cfg).init(torch.Generator().manual_seed(0))
    pc = fused_step.prepare(plain)
    assert pc["ctrl_w"] is None and fused_step.coef_width(pc) == 9
    assert fused_step._split_coef(torch.zeros(4, 9), pc)[5] is None


def _c_params(name):
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src.read_text(), re.S)
        if m:
            return [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    raise AssertionError(f"{name} not found")


@pytest.mark.parametrize("name, last", [
    ("psvo_scan_forward", ["ctrl", "cluster", "stream"]),
    ("psvo_scan_backward", ["ctrl", "cluster", "stream"]),
    ("psvo_step_forward", ["ctrl", "slices", "stream"]),
    ("psvo_step_backward", ["ctrl", "slices", "stream"]),
])
def test_ctypes_signatures_carry_the_control_flag(name, last):
    """Each argtypes list matches its C entry point (pointers and the stream
    c_void_p, seeds c_uint32, ints c_int), the ctrl flag just before C or S."""
    params = _c_params(name)
    want = [ctypes.c_void_p if "*" in t else ctypes.c_uint32 if t == "uint32_t" else ctypes.c_int
            for t, _ in params]
    assert _build.SIGNATURES[name] == want
    assert [n for _, n in params][-3:] == last
