"""The torch port's per-step filter path (`fused_step.SCAN_FUSED` off)
against the JAX reference's (`pallas_step.SCAN_FUSED` off).

With the toggle off, the reference runs one `pallas_step._step_call` per
step under lax.scan, the per-step Pallas kernels `_step_fwd` / `_step_bwd`;
the port runs one `fused_step.StepForward` per step, whose plain versions
(`step_forward_reference`, `step_backward_reference`) CPU tensors take. At
the suite's small size (B=8, K=128, T=5, hidden (16, 16)), on the noise the
reference derives from its key:

- values against the reference's per-step kernels in interpret mode, at the
  tolerances of its own fused-vs-unfused tests (2e-4, ESS 2e-3), cache on
  and off;
- gradients against `jax.value_and_grad` of the same reference, leaf by
  leaf, at rtol 5e-3 / atol 5e-4;
- the chained per-step plain versions against the whole-scan ones (1e-6),
  at Dx = 2 and 3;
- the dispatch with the toggle off, and PSVO with the toggle on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import smc as jsmc
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import bridge
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import fused_step
from tests._torch_port import (assert_close, key_noise, models, observations, psvo_noise,
                               small_configs, to_torch)

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4
_FIELDS_2E4 = ("log_z", "increments", "filtered_means", "x_last", "logw_last")


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


@pytest.fixture
def _per_step(monkeypatch):
    """Both packages' toggles off: the per-step path."""
    monkeypatch.setattr(pallas_step, "SCAN_FUSED", False)
    monkeypatch.setattr(fused_step, "SCAN_FUSED", False)


def _loss(fwd, cache, mean):
    """−mean(log Ẑ) plus a term on the last log-weights, so that each step's
    α cotangent is live, and small terms on every other output (under cache
    the particle and weight histories; ESS and the filtered means, whose
    cotangents both per-step VJPs drop)."""
    last = fwd.logws[-1] if cache else fwd.logw_last
    loss = -mean(fwd.log_z) + 1e-3 * mean(last) + 1e-2 * mean(fwd.x_last)
    loss = loss + 1e-3 * mean(fwd.ess) + 1e-2 * mean(fwd.filtered_means)
    if cache:
        loss = loss + 1e-2 * mean(fwd.xs * fwd.xs) + 1e-3 * mean(fwd.logws)
    return loss


def _reference_and_port(cache):
    jcfg, tcfg = small_configs(t=5, kernel_rng=True)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(8, 5, seed=3)
    key = jax.random.key(11)

    def reference(p):
        return jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=cache,
                                          encoder_inputs=None)

    def port():
        return tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc,
                                          cache=cache, streams=to_torch(key_noise(key, 8, 5, 2, 128)))

    return params, tssm, reference, port


def _counts():
    return ([f.calls for f in (fused_step.step_forward_reference,
                               fused_step.step_backward_reference,
                               fused_step.scan_forward_reference,
                               fused_step.scan_backward_reference)],
            [f.launches for f in (fused_step.step_forward, fused_step.step_backward,
                                  fused_step.scan_forward, fused_step.scan_backward)])


@pytest.mark.parametrize("cache", [True, False])
def test_step_path_matches_reference_step_call(_interpret, _per_step, cache):
    """The per-step path under no_grad against the reference's per-step
    kernels in interpret mode: T−1 calls of step_forward_reference, none of
    the whole-scan plain version, no launch."""
    params, _, reference, port = _reference_and_port(cache)
    want = reference(params)
    calls, launches = _counts()
    with torch.no_grad():
        got = port()
    after_calls, after_launches = _counts()
    assert [a - b for a, b in zip(after_calls, calls)] == [4, 0, 0, 0]
    assert after_launches == launches
    for f in _FIELDS_2E4 + (("xs", "logws") if cache else ()):
        assert_close(getattr(got, f), getattr(want, f), 2e-4)
    assert_close(got.ess, want.ess, 2e-3)


@pytest.mark.parametrize("cache", [True, False])
def test_step_path_gradients_match_reference(_interpret, _per_step, cache):
    """StepForward on CPU tensors (step_forward_reference forward,
    step_backward_reference backward, T−1 each) against jax.value_and_grad
    through the reference's per-step forward and backward kernels."""
    params, tssm, reference, port = _reference_and_port(cache)
    want_loss, want = jax.value_and_grad(lambda p: _loss(reference(p), cache, jnp.mean))(params)
    calls, _ = _counts()
    loss = _loss(port(), cache, torch.mean)
    for p in tssm.parameters():
        p.grad = None
    loss.backward()
    after, _ = _counts()
    assert [a - b for a, b in zip(after, calls)] == [4, 4, 0, 0]
    assert_close(loss.detach(), want_loss, 2e-4)
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_got = jax.tree_util.tree_leaves(bridge.grads_to_numpy(tssm))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _scan_operands(datatype, seed=0):
    """K1's operands at the small size with random weights, plus random
    cotangents of every output K4 honours."""
    _, tcfg = small_configs(t=6, datatype=datatype)
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    dx, dy, b, k, t1 = ssm.dx, ssm.dy, 4, 128, 5
    consts = {n: v.detach() if torch.is_tensor(v) else v
              for n, v in fused_step.prepare(ssm).items()}
    x0 = torch.randn((b, dx, k), generator=g)
    a0 = torch.randn((b, k), generator=g)
    coef = torch.rand((t1, b, 3 * dx + dy + 1), generator=g) + 0.1
    eps = torch.randn((t1, b, dx, k), generator=g)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g), k)
    cots = dict(d_stats=torch.randn((t1, b, 2 + dx), generator=g),
                d_x_last=torch.randn((b, dx, k), generator=g),
                d_alpha_last=torch.randn((b, k), generator=g),
                d_x_all=torch.randn((t1, b, dx, k), generator=g) * 0.1,
                d_alpha_all=torch.randn((t1, b, k), generator=g) * 0.1)
    return consts, x0, a0, coef, eps, pos, cots


@pytest.mark.parametrize("datatype", ["fhn", "lorenz63"])
def test_step_chain_equals_whole_scan_plain_versions(datatype):
    """T−1 chained step_forward_reference calls give scan_forward_reference's
    outputs; step_backward_reference chained in reverse (each step's d x_new
    the cache cotangent plus the next step's d x, its d α the cache one plus
    d_alpha_last at the end), with the weight gradients summed, gives
    scan_backward_reference's, to 1e-6."""
    consts, x0, a0, coef, eps, pos, cots = _scan_operands(datatype)
    x_last, a_last, stats, x_all, a_all, idx = fused_step.scan_forward_reference(
        x0, a0, coef, consts, eps, pos, cache=True, save_res=True)
    x, lw, steps = x0, a0, []
    for t in range(coef.shape[0]):
        x, lw, st, ix = fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t])
        steps.append((x, lw, st, ix))
    for i, want in enumerate((x_all, a_all, stats, idx)):
        assert torch.equal(torch.stack([s[i] for s in steps]), want)
    assert torch.equal(x, x_last) and torch.equal(lw, a_last)

    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, **cots)
    t1 = coef.shape[0]
    d_x = cots["d_x_last"]
    d_coef, d_packed, d_sconst = [None] * t1, 0.0, 0.0
    for t in reversed(range(t1)):
        x_in = x0 if t == 0 else x_all[t - 1]
        d_alpha = cots["d_alpha_all"][t] + (cots["d_alpha_last"] if t == t1 - 1 else 0.0)
        d_x, d_coef[t], dp, ds = fused_step.step_backward_reference(
            x_in, coef[t], consts, eps[t], idx[t], cots["d_stats"][t],
            d_x + cots["d_x_all"][t], d_alpha)
        d_packed, d_sconst = d_packed + dp, d_sconst + ds
    for got, w in zip((d_x, torch.stack(d_coef), d_packed, d_sconst), want):
        assert float((got - w).abs().max()) <= 1e-6 * (1.0 + float(w.abs().max()))


def test_toggle_off_dispatch_runs_streams_and_the_step_plain_versions(monkeypatch):
    """With fused_step.SCAN_FUSED off, a kernel_rng config on CPU tensors runs
    on streams (no Philox replay) drawn from the generator as the plain body
    draws them, step_forward_reference T−1 times and the whole-scan plain
    version never; its backward step_backward_reference T−1 times."""
    monkeypatch.setattr(fused_step, "SCAN_FUSED", False)
    _, tcfg = small_configs(t=5, kernel_rng=True)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys =torch.from_numpy(observations(4, 5, seed=6))
    noise_calls = fused_step.stream_noise_reference.calls
    calls, launches = _counts()
    fwd = tsmc.forward_filter(tssm, torch.Generator().manual_seed(2), ys, tcfg.smc, cache=True)
    (-torch.mean(fwd.log_z)).backward()
    after_calls, after_launches = _counts()
    assert [a - b for a, b in zip(after_calls, calls)] == [4, 4, 0, 0]
    assert after_launches == launches
    assert fused_step.stream_noise_reference.calls == noise_calls

    streams = tsmc._draw_noise(torch.Generator().manual_seed(2), tcfg.smc, 5, 4, 2)
    with torch.no_grad():
        want = tsmc.forward_filter(tssm, None, ys, tcfg.smc, cache=True, noise=streams)
    for f in _FIELDS_2E4 + ("xs", "logws"):
        assert_close(getattr(fwd, f).detach(), getattr(want, f), 2e-4)


def test_psvo_loss_and_gradients_agree_with_the_toggle_on_and_off(monkeypatch):
    """The PSVO objective (direct bound: every cache cotangent live) on the
    same streams gives the same loss and gradients through the whole-scan
    plain versions and the per-step ones."""
    _, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=5,
                            n_smoothing_particles=8, psvo_bound="direct")
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.from_numpy(observations(8, 5, dy=3, seed=9))
    noise = psvo_noise(jax.random.key(17), 8, 5, 3, 128, 8)
    results = []
    for scan_fused in (True, False):
        monkeypatch.setattr(fused_step, "SCAN_FUSED", scan_fused)
        out = t_make_objective(tssm, tcfg)(None, ys, noise=noise)
        for p in tssm.parameters():
            p.grad = None
        out.loss.backward()
        results.append((out.loss.detach(), out.smoothed.detach(),
                        [p.grad.clone() for p in tssm.parameters() if p.grad is not None]))
    (loss_on, paths_on, grads_on), (loss_off, paths_off, grads_off) = results
    assert torch.equal(paths_on, paths_off)
    assert_close(loss_off, loss_on, 1e-6)
    assert len(grads_on) == len(grads_off) > 0
    for a, b in zip(grads_off, grads_on):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_step_backward_class_is_wider_than_the_whole_scan_one():
    """K15 keeps no carry, and its d x_res and ancestors stay in device
    memory, so its shared memory does not depend on K and admits every K up
    to MAX_K = 4096 at Dx = 2 and 3 with hidden (64, 64), where K4 stops at
    2304 and 1536 on one CTA per row; any depth of the class, as K4 (as
    deep as the plan's shared memory holds: not 14 hidden layers of 64,
    whose activation tiles alone take 14 x 64 x 68 x 4 B = 243,712 B)."""
    widths = {}
    for preset in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"):
        ssm = init_ssm(PRESETS[preset], torch.Generator().manual_seed(0), device="cpu")
        consts = fused_step.prepare(ssm)
        ks = range(256, fused_step.MAX_K + 1, 256)
        widths[ssm.dx] = (max(k for k in ks if fused_step._k4_ok(consts, k)),
                          max(k for k in ks if fused_step._k15_ok(consts, k)))
        # K4's less the carry and d x_res [Dx][K] and the ancestors [K]
        assert fused_step.k15_smem_bytes(consts) == (
            fused_step.k4_smem_bytes(consts, 1024) - 4 * (2 * ssm.dx + 1) * 1024)
        assert fused_step._k15_ok(dict(consts, n_mid=2), 1024)
        assert not fused_step._k15_ok(dict(consts, n_mid=13), 1024)
    assert widths == {2: (2304, 4096), 3: (1536, 4096)}
