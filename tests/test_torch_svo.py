"""The torch port's SVO slice against the JAX reference.

Small sizes only: B=8, K=128, M=8 (and M=4), T = 5, Lorenz-63's Dx = Dy = 3
(and one FHN Dx = Dy = 2 case), hidden (16,) and (16, 16). Values are held at
rtol=atol=2e-4 and gradients at rtol=5e-3, atol=5e-4: the reference's own
kernel-vs-scan tolerances (tests/test_pallas_svo.py).

- The SVO sweep op: `SVOSweep` on CPU tensors (K12's and K13's plain
  versions) against `pallas_svo.run_svo_sweep` and its `jax.vjp` in
  interpret mode, with the kernel's M >= 32 speed gate lowered to 1 as the
  reference's own tests lower it, on the same numpy inputs.
- The SVO objective: loss, elbo, smoothed paths, `elbo_svo` and every
  gradient leaf against `jax.value_and_grad` of the reference objective
  with `use_pallas=False` (the lax.scan body, which the preset runs at
  M = 16), on the noise the reference derives from its key; once inside the
  kernels' class and once outside it (the port's scan body).
- The kernel path: ScanForward and SVOSweep on CPU tensors against the
  reference's whole-scan and SVO Pallas kernels in interpret mode.
- CPU dispatch: an SVO train step without the noise hook runs each of the
  four plain versions once and launches nothing.
- `smooth_posterior(method="svo")` against the reference's on the same noise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import infer as jinfer
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step, pallas_svo
from psvo_tpu_torch import bridge
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.config import PRESETS, NetConfig
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import fused_step, svo
from tests._torch_port import assert_close, models, observations, small_configs, svo_noise

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K, M = 8, 128, 8


def _assert_grads_close(got_tree, want_tree):
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_got = jax.tree_util.tree_leaves(got_tree)
    assert len(flat_got) == len(flat_want)
    for (path, want), got in zip(flat_want, flat_got):
        np.testing.assert_allclose(got, np.asarray(want), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _zero_grads(ssm):
    for p in ssm.parameters():
        p.grad = None


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_resample, pallas_step, pallas_svo):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_svo, "MIN_M", 1)


@pytest.mark.parametrize("datatype,hidden,m", [("lorenz63", (16,), 8),
                                               ("lorenz63", (16, 16), 4),
                                               ("fhn", (16, 16), 8)])
def test_svo_sweep_plain_versions_match_reference_kernel(_interpret, datatype, hidden, m):
    """K12's and K13's plain versions, through SVOSweep on CPU tensors,
    against the whole-sweep Pallas kernel in interpret mode: the four
    outputs, and the VJP of random cotangents on all four to the anchors and
    to every parameter (the qb, f and g weights, biases and scales; zeros
    elsewhere)."""
    jcfg, tcfg = small_configs(objective="svo", datatype=datatype, hidden=hidden, t=5,
                               n_smoothing_particles=m)
    jssm, params, tssm = models(jcfg, tcfg)
    dx = jssm.dx
    rng = np.random.default_rng(3)
    ys_tm = (rng.standard_normal((5, B, dx)) * 4.0).astype(np.float32)
    eps = rng.standard_normal((4, B, m, dx)).astype(np.float32)
    x_anchor = (rng.standard_normal((B, m, dx)) * 4.0).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, m, dx), (B, m), (B, m), (4, B, m, dx))]

    def ref(p, xa):
        return pallas_svo.run_svo_sweep(jssm, p, ys_tm, None, eps, xa, m)

    want, vjp = jax.vjp(ref, params, x_anchor)
    want_params, want_anchor = vjp(tuple(cots))

    xa = torch.from_numpy(x_anchor).requires_grad_()
    calls = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    _zero_grads(tssm)
    got = svo.run_svo_sweep(tssm, torch.from_numpy(ys_tm), torch.from_numpy(eps), xa)
    for a, w in zip(got, want):
        assert_close(a.detach(), w, _TOL)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    assert (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    np.testing.assert_allclose(xa.grad.numpy(), np.asarray(want_anchor), rtol=_RTOL, atol=_ATOL)
    _assert_grads_close(bridge.grads_to_numpy(tssm), want_params)


def test_svo_plain_backward_honours_missing_cotangents():
    """The plain VJP with one live cotangent (d_lp) equals the full one with
    the other three zero; with none it returns zeros."""
    _, tcfg = small_configs(objective="svo", datatype="lorenz63", t=5, n_smoothing_particles=4)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(4)
    xa = torch.randn((2, 4, 3), generator=g) * 3
    eps = torch.randn((4, 2, 4, 3), generator=g)
    y = torch.randn((4, 2, 3), generator=g) * 3
    with torch.no_grad():
        consts = svo.prepare(tssm)
        xtilde = svo.svo_sweep_forward(xa, eps, y, consts)[3]
    d_lp = torch.randn((2, 4), generator=g)
    one = svo.svo_sweep_backward(xa, eps, y, consts, xtilde, d_lp=d_lp)
    full = svo.svo_sweep_backward(xa, eps, y, consts, xtilde, torch.zeros_like(xa), d_lp,
                                  torch.zeros_like(d_lp), torch.zeros_like(xtilde))
    for a, w in zip(one, full):
        torch.testing.assert_close(a, w)
    assert all(not bool(t.any()) for t in svo.svo_sweep_backward(xa, eps, y, consts, xtilde))


def test_svo_usable_class():
    """The preset is in the kernels' class; widths that are not one width
    for qb, f and g (qb alone at (16, 32) or (48, 48)), M above MAX_M and a
    state with Dx + Dy above 7 are not."""
    cfg = PRESETS["lorenz63_svo_k256"]
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert svo.usable(ssm, cfg.smc.n_smoothing_particles)
    assert svo.usable(ssm, 1) and not svo.usable(ssm, svo.MAX_M + 1)
    for hidden in ((16, 32), (48, 48)):
        odd = init_ssm(cfg.with_nets(qb=NetConfig(hidden=hidden)), torch.Generator().manual_seed(0),
                       device="cpu")
        assert not svo.usable(odd, 16), hidden
    _, wide = small_configs(objective="svo", datatype="lorenz63")
    wide = dataclasses.replace(wide, data=dataclasses.replace(wide.data, dx=4, dy=4))
    assert not svo.usable(init_ssm(wide, torch.Generator().manual_seed(0), device="cpu"), 8)


@pytest.mark.parametrize("hidden,m", [((16, 16), 8), ((16, 32), 4)])
def test_svo_objective_matches_reference_scan(hidden, m):
    """The objective against the reference's lax.scan body (use_pallas=False).
    Hidden (16, 32) lies outside the kernels' class: the port's own scan
    body runs there."""
    jcfg, tcfg = small_configs(objective="svo", datatype="lorenz63", hidden=hidden, t=5,
                               n_smoothing_particles=m)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    assert svo.usable(tssm, m) == (hidden != (16, 32))
    ys = observations(B, 5, dy=3, seed=5)
    key = jax.random.key(13)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=svo_noise(key, B, 5, 3, K, m))
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert got.smoothed.shape == want.smoothed.shape == (5, B, m, 3)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for name in ("elbo_svo", "log_z_fwd"):
        assert_close(got.metrics[name].detach(), want.metrics[name], _TOL)
    _zero_grads(tssm)
    got.loss.backward()
    _assert_grads_close(bridge.grads_to_numpy(tssm), want_grads)


def test_svo_kernel_path_matches_reference_kernels(_interpret, monkeypatch):
    """The whole kernel path on CPU tensors — ScanForward (K1/K4's plain
    versions) with the particle cache, then SVOSweep (K12/K13's) — against
    jax.value_and_grad through the reference's whole-scan and SVO Pallas
    kernels in interpret mode. The SVO gradient reaches the cache at
    xs[-2] and logws[-2] (the predictive mixture), the last increment and
    x_last (the anchors), so K4 runs with its cache cotangents."""
    jcfg, tcfg = small_configs(objective="svo", datatype="lorenz63", t=5, n_smoothing_particles=M)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_svo.usable(jssm, B, M)
    ys = observations(B, 5, dy=3, seed=9)
    key = jax.random.key(17)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    noise = svo_noise(key, B, 5, 3, K, M)

    def fused_filter(ssm, generator, ys_, cfg, *, cache, encoder_inputs, noise):
        return tsmc._forward_filter_fused(ssm, generator, ys_, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", fused_filter)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    calls = [f.calls for f in plain]
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    _zero_grads(tssm)
    got.loss.backward()
    assert [f.calls - n for f, n in zip(plain, calls)] == [1, 1, 1, 1]
    _assert_grads_close(bridge.grads_to_numpy(tssm), want_grads)


def test_cpu_svo_train_step_runs_each_plain_version_once():
    _, tcfg = small_configs(objective="svo", datatype="lorenz63", t=4, n_smoothing_particles=M)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
               svo.svo_sweep_backward, fused_step.stream_noise, fused_step.ancestor_indices)
    before = [f.calls for f in plain]
    launches = [f.launches for f in kernels]
    metrics = step(torch.Generator().manual_seed(1),
                   torch.from_numpy(observations(2, 4, dy=3, seed=3)))
    assert [f.calls - n for f, n in zip(plain, before)] == [1, 1, 1, 1]
    assert [f.launches for f in kernels] == launches
    for name in ("loss", "grad_norm", "elbo_svo"):
        assert torch.isfinite(metrics[name]), name


def test_svo_smooth_posterior_matches_reference():
    jcfg, tcfg = small_configs(objective="svo", datatype="lorenz63", t=5, n_smoothing_particles=M)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, 5, dy=3, seed=8)
    key = jax.random.key(23)
    want = jinfer.smooth_posterior(jssm, params, ys, jcfg, key, method="svo")
    plain = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    got = tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg, method="svo",
                                  noise=svo_noise(key, B, 5, 3, K, M))
    assert got.shape == want.shape == (B, M, 5, 3)
    assert_close(got, want, _TOL)
    assert (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls) == (
        plain[0] + 1, plain[1])
