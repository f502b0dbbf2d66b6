"""Controlled smoothing in the torch port: PSVO and SVO with exogenous
controls (data.di > 0), against the JAX reference.

Both packages run the same controlled Lorenz-63 model (params bridged; f's
and q1's first layers [Dx + Di, H]) on the same observations and controls,
made from a numpy seed, with the draws the reference derives from its key,
at a small size (B = 8, K = 128, M = 8, T <= 9, hidden (16, 16), Di = 2,
control scale 0.5 as `fhn_fivo_controls`). Tolerances are those of the
uncontrolled slices (tests/test_torch_psvo.py, tests/test_torch_svo.py,
tests/test_torch_controls.py): 2e-4 on values, rtol 5e-3 / atol 5e-4 on
every gradient leaf. Checked:

- PSVO under both bounds (`use_pallas=False`: the reference's scan bodies)
  and segmented at S = 2: loss, elbo, smoothed paths, metrics and every
  gradient leaf against `jax.value_and_grad` of the reference objective;
- PSVO's kernel path on CPU tensors (K1/K4's plain versions in their
  control mode, then K5/K6's on support terms that take u_{t+1}) against
  the reference's whole-scan and FFBSi kernels in interpret mode;
- SVO the same way: the objective against the reference's scan body, the
  sweep's plain versions in control mode (K12/K13's, f's first layer from
  b1 + u_{t+1}·W_u) against `pallas_svo.run_svo_sweep` with ctrl_tm in
  interpret mode, values and VJP (`pallas_svo.MIN_M` patched to 1, and at
  M = 32 unpatched), and the whole kernel path;
- `smooth_posterior` with controls, both methods;
- zero controls equal to none, and to the same model without controls.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import infer as jinfer
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_ffbsi, pallas_resample, pallas_step, pallas_svo
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step, svo
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, psvo_noise, segmented_psvo_noise,
    small_configs, svo_noise,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K, M, DX, DI = 8, 128, 8, 3, 2


def _configs(objective, t=6, datatype="lorenz63", **smc_kw):
    """(reference Config, port Config) of the small slice with Di controls."""
    jcfg, _ = small_configs(objective=objective, datatype=datatype, t=t, **smc_kw)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, di=DI,
                                                              control_scale=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def _controls(batch, t_steps, seed=11):
    return (0.5 * np.random.default_rng(seed).standard_normal((batch, t_steps, DI))).astype(
        np.float32)


def _reference(jssm, jcfg, params, key, ys, u):
    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys, controls=u)
        return out.loss, out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


def _port(tssm, tcfg, ys, u, noise):
    out = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise,
                                       controls=torch.from_numpy(u))
    for p in tssm.parameters():
        p.grad = None
    out.loss.backward()
    return out, bridge.grads_to_numpy(tssm)


def _compare(got, got_grads, want, want_loss, want_grads, names):
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert got.smoothed.shape == want.smoothed.shape
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for name in names:
        assert_close(got.metrics[name].detach(), want.metrics[name], _TOL)
    assert_grads_close(got_grads, want_grads, _RTOL, _ATOL)


_PSVO_METRICS = ("log_joint_smoothed", "elbo_psvo_direct", "log_z_fwd")


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_ffbsi, pallas_resample, pallas_step, pallas_svo):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def _fused_filter(ssm, generator, ys, cfg, *, cache, encoder_inputs, noise, controls):
    """The whole-scan class's plain versions on the given streams (the hook
    alone picks the plain body on CPU tensors, as the reference does)."""
    return tsmc._forward_filter_fused(ssm, generator, ys, cfg, cache=cache,
                                      encoder_inputs=encoder_inputs, streams=noise,
                                      controls=controls)


# -- PSVO --------------------------------------------------------------------------------


@pytest.mark.parametrize("bound", ["forward", "direct"])
def test_controlled_psvo_objective_matches_reference(bound):
    jcfg, tcfg = _configs("psvo", n_smoothing_particles=M, psvo_bound=bound)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    assert ffbsi.usable(tssm.dx, M, tcfg.smc.n_particles, f_tril=tssm.f_tril)
    ys, u, key = observations(B, 6, dy=DX, seed=5), _controls(B, 6), jax.random.key(13)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys, u)
    got, got_grads = _port(tssm, tcfg, ys, u, psvo_noise(key, B, 6, DX, K, M))
    _compare(got, got_grads, want, want_loss, want_grads, _PSVO_METRICS)


def test_controlled_psvo_kernel_path_matches_reference_kernels(_interpret, monkeypatch):
    """ScanForward (K1/K4's plain versions, control mode) with the cache,
    then FFBSiSweep (K5/K6's) on support terms with u_{t+1}, under the direct
    bound, against the reference's whole-scan and FFBSi kernels in interpret
    mode: values and every gradient leaf, W_u's rows included."""
    jcfg, tcfg = _configs("psvo", t=5, n_smoothing_particles=M, psvo_bound="direct")
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, B) and fused_step.usable(tssm, tcfg.smc)
    ys, u, key = observations(B, 5, dy=DX, seed=9), _controls(B, 5), jax.random.key(17)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys, u)
    monkeypatch.setattr(tobjectives, "forward_filter", _fused_filter)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    calls = [f.calls for f in plain]
    got, got_grads = _port(tssm, tcfg, ys, u, psvo_noise(key, B, 5, DX, K, M))
    assert [f.calls - n for f, n in zip(plain, calls)] == [1, 1, 1, 1]
    _compare(got, got_grads, want, want_loss, want_grads, ("log_joint_smoothed",))


def test_controlled_segmented_psvo_matches_reference():
    """S = 2 at T = 9, forward bound: each segment's support terms take its
    slice of the controls and t = 0 takes u_1 (the reference's `ctrl_sup`)."""
    jcfg, tcfg = _configs("psvo", t=9, n_smoothing_particles=M, ffbsi_segments=2)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    ys, u, key = observations(B, 9, dy=DX, seed=5), _controls(B, 9), jax.random.key(13)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys, u)
    got, got_grads = _port(tssm, tcfg, ys, u, segmented_psvo_noise(key, B, 9, DX, K, M, 2))
    _compare(got, got_grads, want, want_loss, want_grads, _PSVO_METRICS)


# -- SVO ---------------------------------------------------------------------------------


def test_controlled_svo_objective_matches_reference():
    """The reference's scan body (f on [x̃_t; u_{t+1}], the mixture with u_T)
    against the port's sweep, in K12/K13's class: their plain versions in
    control mode."""
    jcfg, tcfg = _configs("svo", n_smoothing_particles=M)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    assert svo.usable(tssm, M)
    ys, u, key = observations(B, 6, dy=DX, seed=5), _controls(B, 6), jax.random.key(13)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys, u)
    calls = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    got, got_grads = _port(tssm, tcfg, ys, u, svo_noise(key, B, 6, DX, K, M))
    assert (svo.svo_sweep_forward_reference.calls - calls[0],
            svo.svo_sweep_backward_reference.calls - calls[1]) == (1, 1)
    _compare(got, got_grads, want, want_loss, want_grads, ("elbo_svo", "log_z_fwd"))


@pytest.mark.parametrize("datatype,hidden,m,min_m", [("lorenz63", (16,), 8, 1),
                                                     ("fhn", (16, 16), 8, 1),
                                                     ("lorenz63", (16, 16), 32, None)])
def test_controlled_svo_sweep_plain_versions_match_reference_kernel(
        _interpret, monkeypatch, datatype, hidden, m, min_m):
    """K12's and K13's plain versions in control mode (through SVOSweep with
    cbias = u_{t+1}·W_u) against the reference's whole-sweep kernel with
    ctrl_tm in interpret mode, as tests/test_pallas_svo.py runs it with
    di = 2: the four outputs and the VJP of random cotangents on all four to
    the anchors and every parameter, f's control rows included (the
    controls get none)."""
    if min_m is not None:
        monkeypatch.setattr(pallas_svo, "MIN_M", min_m)
    jcfg, tcfg = _configs("svo", t=5, datatype=datatype, hidden=hidden, n_smoothing_particles=m)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_svo.usable(jssm, B, m) and svo.usable(tssm, m)
    dx = jssm.dx
    rng = np.random.default_rng(3)
    ys_tm = (rng.standard_normal((5, B, dx)) * 4.0).astype(np.float32)
    ctrl_tm = (0.5 * rng.standard_normal((5, B, DI))).astype(np.float32)
    eps = rng.standard_normal((4, B, m, dx)).astype(np.float32)
    x_anchor = (rng.standard_normal((B, m, dx)) * 4.0).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, m, dx), (B, m), (B, m), (4, B, m, dx))]

    def ref(p, xa):
        return pallas_svo.run_svo_sweep(jssm, p, ys_tm, ctrl_tm, eps, xa, m)

    want, vjp = jax.vjp(ref, params, x_anchor)
    want_params, want_anchor = vjp(tuple(cots))
    xa = torch.from_numpy(x_anchor).requires_grad_()
    for p in tssm.parameters():
        p.grad = None
    calls = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    got = svo.run_svo_sweep(tssm, torch.from_numpy(ys_tm), torch.from_numpy(eps), xa,
                            torch.from_numpy(ctrl_tm))
    for a, w in zip(got, want):
        assert_close(a.detach(), w, _TOL)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    assert (svo.svo_sweep_forward_reference.calls - calls[0],
            svo.svo_sweep_backward_reference.calls - calls[1]) == (1, 1)
    np.testing.assert_allclose(xa.grad.numpy(), np.asarray(want_anchor), rtol=_RTOL, atol=_ATOL)
    assert_grads_close(bridge.grads_to_numpy(tssm), want_params, _RTOL, _ATOL)


def test_controlled_svo_kernel_path_matches_reference_kernels(_interpret, monkeypatch):
    """ScanForward (K1/K4's plain versions, control mode) with the cache,
    then SVOSweep (K12/K13's, control mode) against the reference's
    whole-scan and SVO kernels in interpret mode: values and gradients."""
    monkeypatch.setattr(pallas_svo, "MIN_M", 1)
    jcfg, tcfg = _configs("svo", t=5, n_smoothing_particles=M)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_svo.usable(jssm, B, M)
    ys, u, key = observations(B, 5, dy=DX, seed=9), _controls(B, 5), jax.random.key(17)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys, u)
    monkeypatch.setattr(tobjectives, "forward_filter", _fused_filter)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    calls = [f.calls for f in plain]
    got, got_grads = _port(tssm, tcfg, ys, u, svo_noise(key, B, 5, DX, K, M))
    assert [f.calls - n for f, n in zip(plain, calls)] == [1, 1, 1, 1]
    _compare(got, got_grads, want, want_loss, want_grads, ("elbo_svo",))


# -- serving and the zero controls ---------------------------------------------------------


@pytest.mark.parametrize("method", ["psvo", "svo"])
def test_smooth_posterior_with_controls_matches_reference(method):
    jcfg, tcfg = _configs(method, t=5, n_smoothing_particles=M)
    jssm, params, tssm = models(jcfg, tcfg)
    ys, u, key = observations(B, 5, dy=DX, seed=8), _controls(B, 5), jax.random.key(23)
    want = jinfer.smooth_posterior(jssm, params, ys, jcfg, key, controls=u)
    noise = (psvo_noise if method == "psvo" else svo_noise)(key, B, 5, DX, K, M)
    got = tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg, noise=noise,
                                  controls=torch.from_numpy(u))
    assert got.shape == want.shape == (B, M, 5, DX)
    assert_close(got, want, _TOL)
    with pytest.raises(ValueError, match="controls"):
        tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg, noise=noise)


def _without_controls(tssm, tcfg):
    """The same model with di = 0: q1's and f's first layers cut to their
    first Dx rows, every other weight as it is."""
    cfg0 = dataclasses.replace(tcfg, data=dataclasses.replace(tcfg.data, di=0))
    tree = bridge.params_to_numpy(tssm)
    for name in ("q1", "f"):
        w, b = tree[name]["layers"][0]
        tree[name]["layers"][0] = (w[:DX], b)
    return bridge.load_numpy_params(SSM(cfg0), tree), cfg0


@pytest.mark.parametrize("objective,bound", [("psvo", "forward"), ("psvo", "direct"),
                                             ("svo", "forward")])
def test_zero_controls_equal_none(objective, bound):
    """A controlled model with zero controls gives what it gives with
    controls=None (zeros), bit for bit, and what the same model without
    controls gives (di = 0, the control rows dropped), to 1e-5; its
    gradients on the shared leaves agree to 1e-5 too."""
    _, tcfg = _configs(objective, n_smoothing_particles=M, psvo_bound=bound)
    tssm = SSM(tcfg).init(torch.Generator().manual_seed(4))
    ys = observations(B, 6, dy=DX, seed=7)
    key = jax.random.key(19)
    noise = (psvo_noise if objective == "psvo" else svo_noise)(key, B, 6, DX, K, M)
    zero = np.zeros((B, 6, DI), np.float32)
    out_zero, _ = _port(tssm, tcfg, ys, zero, noise)
    out_none = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert torch.equal(out_zero.loss, out_none.loss)
    assert torch.equal(out_zero.smoothed, out_none.smoothed)
    grads = bridge.grads_to_numpy(tssm)
    plain_ssm, plain_cfg = _without_controls(tssm, tcfg)
    out_plain = t_make_objective(plain_ssm, plain_cfg)(None, torch.from_numpy(ys), noise=noise)
    out_plain.loss.backward()
    assert_close(out_zero.loss.detach(), out_plain.loss.detach(), 1e-5)
    assert_close(out_zero.smoothed.detach(), out_plain.smoothed.detach(), 1e-5)
    plain_grads = bridge.grads_to_numpy(plain_ssm)
    for name in ("q1", "f"):
        w, _ = grads[name]["layers"][0]
        grads[name]["layers"][0] = (w[:DX], grads[name]["layers"][0][1])
    assert_grads_close(grads, plain_grads, 1e-5, 1e-5)


@pytest.mark.parametrize("preset", ["lorenz63_psvo_k1024", "lorenz63_svo_k256"])
def test_cli_trains_a_controlled_smoothing_preset(tmp_path, preset):
    """`cli train --preset <PSVO or SVO preset> --set data.di=2 --set
    data.control_scale=0.5` (the controls of `fhn_fivo_controls`), cut to a
    small size, trains on the CPU: exit 0, finite test ELBOs at both evals,
    a checkpoint."""
    import contextlib
    import io
    import json
    import math
    import os

    from psvo_tpu_torch import cli as tcli

    sets = ["data.di=2", "data.control_scale=0.5", "data.n_train=8", "data.n_test=3",
            "data.t_steps=8", "smc.n_particles=32", "smc.n_smoothing_particles=4",
            "train.batch_size=4", "train.steps_per_call=2", "train.eval_every=2",
            "train.save_every=2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["train", "--preset", preset, "--device", "cpu", "--steps", "4",
                        "--results-root", str(tmp_path),
                        *[a for s in sets for a in ("--set", s)]])
    assert rc == 0
    path = next(line.split(": ", 1)[1] for line in out.getvalue().splitlines()
                if line.startswith("results: "))
    hist = json.load(open(os.path.join(path, "history.json")))
    assert [r["step"] for r in hist] == [2, 4]
    assert all(math.isfinite(r["test_elbo"]) for r in hist)
    assert os.path.exists(os.path.join(path, "checkpoints", "4.pt"))
