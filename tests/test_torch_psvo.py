"""The torch port's PSVO slice against the JAX reference.

Small sizes only: B=8, K=128, M=8, T <= 6, hidden (16, 16), Lorenz-63's
Dx = Dy = 3. Values are held at rtol=atol=2e-4 and gradients at rtol=5e-3,
atol=5e-4: the reference's own kernel-vs-scan tolerances
(tests/test_pallas_ffbsi.py).

- The FFBSi op: the plain versions of K5 and K6 (`ops.ffbsi`, what
  `FFBSiSweep` runs on CPU tensors) against `pallas_ffbsi.run_ffbsi_scan`
  and its `jax.vjp` in interpret mode, on the same numpy inputs.
- The PSVO objective, both bounds: loss, elbo, smoothed paths, metrics and
  every gradient leaf against `jax.value_and_grad` of the reference
  objective (`use_pallas=False`), on the filter noise and Gumbels the
  reference derives from its key.
- The kernel path, direct bound: ScanForward and FFBSiSweep on CPU tensors
  (the four kernels' plain versions) against the reference's whole-scan
  and FFBSi Pallas kernels in interpret mode, values and gradients.
- CPU dispatch: a PSVO train step without the noise hook runs each of the
  four plain versions once and launches nothing.
- `smooth_posterior` against the reference's on the same noise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import infer as jinfer
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_ffbsi
from psvo_tpu_torch import bridge
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, psvo_interpret, psvo_noise,
    small_configs,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K, M, DX = 8, 128, 8, 3


def _assert_grads_close(got_tree, want_tree):
    assert_grads_close(got_tree, want_tree, _RTOL, _ATOL)


def _sweep_inputs(seed, t1=5):
    """One sweep's operands: support particles around Lorenz-63 scales, the
    diagonal support terms of a transition whose means lie near them,
    normalized log-weights, emission terms, Gumbels and anchors."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t1, B, DX, K)) * 8.0
    mean = xs + rng.standard_normal(xs.shape)
    scale = rng.uniform(0.5, 2.0, xs.shape)
    r = 1.0 / scale**2
    c = -0.5 * np.sum(mean * mean * r, axis=2) - np.sum(np.log(scale), axis=2) \
        - DX * 0.5 * np.log(2 * np.pi)
    lw = rng.standard_normal((t1, B, K)) * 2.0
    lwn = lw - np.log(np.sum(np.exp(lw), axis=-1, keepdims=True))
    lg = rng.standard_normal((t1, B, K))
    gum = rng.gumbel(size=(t1, B, M, K))
    x_anchor = xs[-1, :, :, :M].transpose(0, 2, 1) + 0.5 * rng.standard_normal((B, M, DX))
    return [np.asarray(a, np.float32) for a in (x_anchor, xs, r, mean * r, c, lwn, lg, gum)]


@pytest.mark.parametrize("cotangents", ["all four outputs", "paths only"])
def test_ffbsi_plain_versions_match_reference_kernel(monkeypatch, cotangents):
    """K5's and K6's plain versions, through FFBSiSweep on CPU tensors,
    against the whole-sweep Pallas kernels in interpret mode: the outputs and
    the VJP for random cotangents. "paths only" is the forward bound's case:
    no cotangent on logp and logq, and no gradient wanted for the support
    terms, which K6 then does not write."""
    monkeypatch.setattr(pallas_ffbsi, "_INTERPRET", True)
    x_anchor, xs, r, mr, c, lwn, lg, gum = _sweep_inputs(0)
    rng = np.random.default_rng(1)
    all_live = cotangents == "all four outputs"
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, M, DX), (B, M), (B, M), (xs.shape[0], B, M, DX))]
    if not all_live:
        cots[1] = cots[2] = np.zeros((B, M), np.float32)

    def ref(xa, xs_, r_, mr_, c_, lwn_, lg_):
        return pallas_ffbsi.run_ffbsi_scan(None, {"r": r_, "mr": mr_, "c": c_}, xs_, lwn_, lg_,
                                           gum, xa, DX)

    want, vjp = jax.vjp(ref, x_anchor, xs, r, mr, c, lwn, lg)
    want_grads = vjp(tuple(cots))

    tensors = [torch.from_numpy(a) for a in (x_anchor, xs, r, mr, c, lwn, lg)]
    diff = tensors if all_live else tensors[:2]
    for t in diff:
        t.requires_grad_()
    calls = (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls)
    got = ffbsi.FFBSiSweep.apply(*tensors, torch.from_numpy(gum))
    for a, w in zip(got, want):
        assert_close(a.detach(), w, _TOL)
    live = [0, 1, 2, 3] if all_live else [0, 3]
    got_grads = torch.autograd.grad([got[i] for i in live], diff,
                                    [torch.from_numpy(cots[i]) for i in live])
    assert (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    for a, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=_RTOL, atol=_ATOL)


def test_ffbsi_plain_selections_take_the_first_maximum_and_honour_needs():
    """The plain forward's selections are the argmax of its own logits plus
    the Gumbels, first maximum on ties, and its backward honours `needs`."""
    x_anchor, xs, r, mr, c, lwn, lg, gum = (torch.from_numpy(a) for a in _sweep_inputs(2, t1=3))
    for t in (xs, r, mr, c, lwn, gum):  # particle 9 of step 1 is a copy of particle 5 ...
        t[1, ..., 9] = t[1, ..., 5]
    gum[1, ..., 5] = gum[1, ..., 9] = 1e4  # ... and every path picks the first of the two
    x_first, logp, logq, xtilde, sel = ffbsi.ffbsi_forward(x_anchor, xs, r, mr, c, lwn, lg, gum)
    assert sel.dtype == torch.int32 and bool((sel[1] == 5).all())
    assert torch.equal(x_first, xtilde[0])
    q = xtilde[1]
    logits = torch.clamp(ffbsi.pair_logp(q, r[0], mr[0], c[0]), min=-1e30) + lwn[0][:, None]
    assert torch.equal(sel[0].long(), torch.argmax(logits + gum[0], dim=-1))
    grads = ffbsi.ffbsi_backward(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde,
                                 d_xtilde=torch.ones_like(xtilde), needs=(False,) * 5)
    assert all(g is None for g in grads[2:])
    assert float(grads[1].sum()) == pytest.approx(float(xtilde.numel()))


@pytest.mark.parametrize("bound", ["forward", "direct"])
def test_psvo_objective_matches_reference(bound):
    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=6,
                               n_smoothing_particles=M, psvo_bound=bound)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    ys = observations(B, 6, dy=DX, seed=5)
    key = jax.random.key(13)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=psvo_noise(key, B, 6, DX, K, M))
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert got.smoothed.shape == want.smoothed.shape == (6, B, M, DX)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for name in ("log_joint_smoothed", "elbo_psvo_direct", "log_z_fwd"):
        assert_close(got.metrics[name].detach(), want.metrics[name], _TOL)
    for p in tssm.parameters():
        p.grad = None
    got.loss.backward()
    _assert_grads_close(bridge.grads_to_numpy(tssm), want_grads)


def test_psvo_kernel_path_gradients_match_reference_kernels(psvo_interpret, monkeypatch):
    """The whole kernel path on CPU tensors — ScanForward (K1/K4's plain
    versions) with the particle cache, then FFBSiSweep (K5/K6's) — against
    jax.value_and_grad through the reference's whole-scan and FFBSi Pallas
    kernels in interpret mode, with the direct bound, so that every cache
    cotangent is live: the FFBSi's on x_0 and on the later particles (K4's
    d_x_all), the weights' (d_alpha_all, d_alpha_last) and the anchors'
    (d_x_last)."""
    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=5,
                               n_smoothing_particles=M, psvo_bound="direct")
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, 5, dy=DX, seed=9)
    key = jax.random.key(17)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    noise = psvo_noise(key, B, 5, DX, K, M)

    def fused_filter(ssm, generator, ys_, cfg, *, cache, encoder_inputs, noise):
        return tsmc._forward_filter_fused(ssm, generator, ys_, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", fused_filter)
    calls = [f.calls for f in (fused_step.scan_forward_reference,
                               fused_step.scan_backward_reference)]
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for p in tssm.parameters():
        p.grad = None
    got.loss.backward()
    assert [f.calls - n for f, n in zip((fused_step.scan_forward_reference,
                                         fused_step.scan_backward_reference), calls)] == [1, 1]
    _assert_grads_close(bridge.grads_to_numpy(tssm), want_grads)


def test_cpu_psvo_train_step_runs_each_plain_version_once():
    _, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=4, n_smoothing_particles=M)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, fused_step.stream_noise, fused_step.ancestor_indices)
    before = [f.calls for f in plain]
    launches = [f.launches for f in kernels]
    metrics = step(torch.Generator().manual_seed(1),
                   torch.from_numpy(observations(2, 4, dy=DX, seed=3)))
    assert [f.calls - n for f, n in zip(plain, before)] == [1, 1, 1, 1]
    assert [f.launches for f in kernels] == launches
    for name in ("loss", "grad_norm", "log_joint_smoothed", "elbo_psvo_direct"):
        assert torch.isfinite(metrics[name]), name


def test_smooth_posterior_matches_reference():
    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=5,
                               n_smoothing_particles=M)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, 5, dy=DX, seed=8)
    key = jax.random.key(23)
    want = jinfer.smooth_posterior(jssm, params, ys, jcfg, key)
    got = tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg,
                                  noise=psvo_noise(key, B, 5, DX, K, M))
    assert got.shape == want.shape == (B, M, 5, DX)
    assert_close(got, want, _TOL)
    svo_paths = tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg, method="svo",
                                        generator=torch.Generator().manual_seed(0))
    assert svo_paths.shape == (B, M, 5, DX) and bool(torch.isfinite(svo_paths).all())
