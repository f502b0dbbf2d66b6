"""The Lorenz-96 train step of the torch port against the JAX reference.

At small sizes on the CPU, with the reference's Pallas kernels in interpret
mode and its float32 residuals (`BF16_RESIDUALS` off, as its own strict
tests run): the plain version of K10 (the VJP of the trunk kernel, through
`trunk.TrunkForward`) against `jax.vjp` of `pallas_trunk.trunk_call`; the
plain version of K11 (the segment-sum scatter, through
`resample_gather.GatherParticles`) against `jax.vjp` of
`pallas_resample.resample_and_gather` on each of the reference's three
backward branches (the fused `_scatter_kernel` at K <= MAX_K, `_sorted_segsum`,
the windowed `_win_scatter`), healthy and degenerate rows; the trunk path's
gradients against `jax.grad` through `smc._forward_filter_trunk` on the same
three branches; and one `make_train_step` of the cut Lorenz-96 preset
against the reference's. Tolerances: rtol 5e-3 / atol 5e-4 on gradients and
parameters (tests/test_torch_train.py's), 2e-4 on values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import smc as jsmc
from psvo_tpu import train as jtrain
from psvo_tpu.ops import pallas_resample, pallas_step, pallas_trunk
from psvo_tpu.ops import resampling as jresampling
from psvo_tpu_torch import bridge
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.ops import resample_gather, trunk
from tests._torch_port import assert_close, key_noise, models, observations, to_torch
from tests.test_torch_lorenz96 import _l96_small, _trunk_configs

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "BF16_RESIDUALS", False)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=_RTOL, atol=_ATOL,
                               err_msg=err_msg)


def _assert_grads_close(got_tree, want_tree):
    flat_want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    flat_got = jax.tree_util.tree_leaves(got_tree)
    assert len(flat_got) == len(flat_want)
    for (path, want), got in zip(flat_want, flat_got):
        _close(got, want, jax.tree_util.keystr(path))


def _zero_grads(tssm):
    for p in tssm.parameters():
        p.grad = None


def test_trunk_backward_plain_version_matches_reference_vjp(_interpret):
    """One step of TrunkForward on CPU tensors (K9's and K10's plain versions)
    against jax.vjp of trunk_call at the reference's trunk-test shape
    (Dx = Dy = 10, B = 8, K = 128, hidden (16, 16)), random cotangents, and
    row 5 forced below the −3e30 floor by a huge observation. Both sides
    build their operands from the same params with their own preamble, so
    the weight gradients compare per head parameter; the coefficient and
    scale-inverse gradients compare column by column."""
    jcfg, tcfg = _trunk_configs(128)
    jssm, params, tssm = models(jcfg, tcfg)
    batch, k, dx, dy, t, floored = 8, 128, 10, 10, 2, 5
    ys = observations(batch, 5, dy=10, seed=3)
    key = jax.random.key(5)
    rng = np.random.default_rng(7)
    x_res = (rng.standard_normal((batch, dx, k)) * 2.0).astype(np.float32)
    d_x_new = rng.standard_normal((batch, dx, k)).astype(np.float32)
    d_alpha = rng.standard_normal((batch, k)).astype(np.float32)

    pre0 = jsmc._fused_preamble(jssm, params, key, jnp.asarray(ys), jcfg.smc, None, None)
    pd, eps_t = pre0["pd"], pre0["eps_scan"][t]
    x_res_p = jnp.pad(jnp.asarray(x_res), ((0, 0), (0, pd - dx), (0, 0))).at[:, pd - 1].set(1.0)
    y_big = jnp.zeros_like(pre0["sm_scan"][t]).at[floored, :dy, pallas_step.SM_Y].set(1e16)

    def ref(p, xr, sm_extra, sconst_extra):
        pre = jsmc._fused_preamble(jssm, p, key, jnp.asarray(ys), jcfg.smc, None, None)
        sm = pre["sm_scan"][t] + y_big + sm_extra
        x_new, alpha = pallas_trunk.trunk_call((pd, pre["n_mid"], None), xr, eps_t, sm,
                                               pre["sconst"] + sconst_extra, *pre["weights"])
        return x_new[:, :dx], alpha

    sm0, sc0 = jnp.zeros_like(pre0["sm_scan"][t]), jnp.zeros_like(pre0["sconst"])
    (x_new_w, alpha_w), vjp = jax.vjp(ref, params, x_res_p, sm0, sc0)
    d_params, d_xr_w, d_sm_w, d_sc_w = vjp((jnp.asarray(d_x_new), jnp.asarray(d_alpha)))
    floor = np.float32(-3e30)
    assert np.all(np.asarray(alpha_w[floored]) == floor)
    assert np.all(np.asarray(alpha_w[:floored]) > floor)

    streams = to_torch(key_noise(key, batch, 5, dx, k))
    consts, coef, *_ = tsmc._fused_preamble(tssm, None, torch.from_numpy(ys), tcfg.smc, None,
                                            streams)
    coef_t = coef[t].detach().clone()
    coef_t[floored, 3 * dx:3 * dx + dy] = 1e16
    coef_extra = torch.zeros_like(coef_t, requires_grad=True)
    sconst_extra = torch.zeros_like(consts["sconst"], requires_grad=True)
    coef_t = coef_t + (coef[t] - coef[t].detach()) + coef_extra  # the graph to the params
    x_res_t = torch.from_numpy(x_res).requires_grad_()
    calls = (trunk.trunk_forward_reference.calls, trunk.trunk_backward_reference.calls)
    x_new, alpha = trunk.TrunkForward.apply(x_res_t, coef_t, consts["packed"],
                                            consts["sconst"] + sconst_extra, consts,
                                            streams[1][t], None, 0)
    assert_close(x_new.detach(), x_new_w, 2e-4)
    assert_close(alpha.detach(), alpha_w, 2e-4)
    _zero_grads(tssm)
    torch.autograd.backward([x_new, alpha], [torch.from_numpy(d_x_new), torch.from_numpy(d_alpha)])
    assert (trunk.trunk_forward_reference.calls, trunk.trunk_backward_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert trunk.trunk_backward.launches == 0

    _close(x_res_t.grad, d_xr_w[:, :dx], "d_x_res")
    d_coef = coef_extra.grad.numpy()
    lanes = ((pallas_step.SM_AQ, 0), (pallas_step.SM_CQ, dx), (pallas_step.SM_SQ, 2 * dx))
    for lane, lo in lanes:
        _close(d_coef[:, lo:lo + dx], d_sm_w[:, :dx, lane], f"d_coef lane {lane}")
    assert np.all(d_coef[:, 3 * dx:3 * dx + dy] == 0.0)  # y is data
    assert np.all(np.asarray(d_sm_w[:, :, pallas_step.SM_Y]) == 0.0)
    _close(d_coef[:, -1], d_sm_w[:, 0, pallas_step.SM_AB], "d_ab")
    assert d_coef[floored, -1] == 0.0  # the floor cut dα on the forced row
    d_sc = sconst_extra.grad.numpy()
    _close(d_sc[:dx], d_sc_w[:dx, pallas_step.SM_SFI], "d 1/s_f")
    _close(d_sc[dx:], d_sc_w[:dy, pallas_step.SM_SGI], "d 1/s_g")
    _assert_grads_close(bridge.grads_to_numpy(tssm), d_params)


# (K, the reference's MAX_K): its fused _scatter_kernel (#7); _sorted_segsum
# (#10 + #11); the windowed _win_scatter (#9), which falls back to
# _sorted_segsum when a row's windows do not fit (the degenerate rows)
_BRANCHES = [(128, None), (256, 128), (1024, 128)]


@pytest.mark.parametrize("degenerate", [False, True], ids=["healthy", "degenerate"])
@pytest.mark.parametrize("k, max_k", _BRANCHES, ids=["fused", "sorted_segsum", "windowed"])
def test_segment_sum_scatter_plain_version_matches_reference_vjp(_interpret, monkeypatch, k,
                                                                 max_k, degenerate):
    """GatherParticles on CPU tensors (K8's and K11's plain versions) on the
    reference's own indices: the gather is exact, and its VJP matches the
    reference's scatter branch. Degenerate rows put nearly all weight on one
    particle, so one ancestor takes (almost) every child."""
    if max_k is not None:
        monkeypatch.setattr(pallas_resample, "MAX_K", max_k)
    rng = np.random.default_rng(k + degenerate)
    batch, d = 8, 40
    logw = (rng.standard_normal((batch, k)) * 3).astype(np.float32)
    if degenerate:
        logw[::2] = -60.0
        logw[np.arange(0, batch, 2), rng.integers(0, k, size=batch // 2)] = 0.0
    u = jresampling.quantile_positions_from_raw(jnp.asarray(rng.uniform(size=batch), jnp.float32),
                                                k, "systematic")
    x = rng.standard_normal((batch, d, k)).astype(np.float32)
    g = rng.standard_normal((batch, d, k)).astype(np.float32)

    def ref(xx):
        idx, x_res = pallas_resample.resample_and_gather(u, jnp.asarray(logw), xx)
        return x_res, idx

    x_res_w, vjp, idx = jax.vjp(ref, jnp.asarray(x), has_aux=True)
    (dx_w,) = vjp(jnp.asarray(g))
    idx = np.asarray(idx)
    if degenerate:
        assert len(np.unique(idx[0])) == 1
    calls = (resample_gather.gather_particles_reference.calls,
             resample_gather.segment_sum_scatter_reference.calls)
    x_t = torch.from_numpy(x).requires_grad_()
    x_res = resample_gather.GatherParticles.apply(x_t, torch.from_numpy(idx))
    np.testing.assert_array_equal(x_res.detach().numpy(), np.asarray(x_res_w))
    x_res.backward(torch.from_numpy(g))
    assert (resample_gather.gather_particles_reference.calls,
            resample_gather.segment_sum_scatter_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert resample_gather.segment_sum_scatter.launches == 0
    _close(x_t.grad, dx_w)
    orphans = np.ones((batch, k), bool)
    np.put_along_axis(orphans, idx.astype(np.int64), False, axis=-1)
    assert np.all(x_t.grad.numpy().transpose(0, 2, 1)[orphans] == 0.0)  # no child: exactly 0


@pytest.mark.parametrize("k, max_k", _BRANCHES, ids=["fused", "sorted_segsum", "windowed"])
def test_trunk_path_gradients_match_reference(_interpret, monkeypatch, k, max_k):
    """−mean(log Z) of the port's _forward_filter_trunk on CPU tensors (K8-K11's
    plain versions) backpropagated, against jax.grad through the reference's
    trunk path in interpret mode on its key-derived noise, per leaf; each
    step runs K10's and K11's plain versions once. The port takes the
    reference's ancestors, step by step: α's last-bit rounding differs
    between the two, and at K = 1024 it moves a CDF boundary across a
    position now and then, which changes one ancestor and the gradient by
    more than the tolerance (test_torch_lorenz96 holds the index versions
    to each other)."""
    if max_k is not None:
        monkeypatch.setattr(pallas_resample, "MAX_K", max_k)
    jcfg, tcfg = _trunk_configs(k)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(8, 5, dy=10, seed=4)
    key = jax.random.key(13)
    noise = key_noise(key, 8, 5, 10, k)

    def loss(p):
        fwd = jsmc._forward_filter_trunk(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                         encoder_inputs=None)
        return -jnp.mean(fwd.log_z), (fwd.xs, fwd.logws)

    (want_loss, (xs, logws)), want = jax.value_and_grad(loss, has_aux=True)(params)
    ancestors = [np.array(pallas_resample.resample_and_gather(
        jnp.asarray(noise[2][t]), logws[t], xs[t])[0], np.int32) for t in range(4)]
    monkeypatch.setattr(resample_gather, "ancestor_indices_large",
                        lambda logw, positions: torch.from_numpy(ancestors.pop(0)))
    calls = (trunk.trunk_backward_reference.calls,
             resample_gather.segment_sum_scatter_reference.calls)
    fwd = tsmc._forward_filter_trunk(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=False,
                                     streams=to_torch(noise))
    assert not ancestors
    got_loss = -torch.mean(fwd.log_z)
    _zero_grads(tssm)
    got_loss.backward()
    assert (trunk.trunk_backward_reference.calls,
            resample_gather.segment_sum_scatter_reference.calls) == (calls[0] + 4, calls[1] + 4)
    assert_close(got_loss.detach(), want_loss, 2e-4)
    _assert_grads_close(bridge.grads_to_numpy(tssm), want)


def test_l96_train_step_matches_reference(_interpret, monkeypatch):
    """One make_train_step on the cut preset (Dx = Dy = 40, B = 8, K = 128,
    T = 6, hidden (16, 16), Adam at lr 3e-3 with clip 10): the same loss,
    gradient norm and parameters after the step as the reference's train
    step. The port replays the reference's draws through its own trunk path
    (the noise hook alone would take the plain step body)."""

    def trunk_filter(ssm, generator, ys, cfg, *, cache=False, encoder_inputs=None, noise=None):
        return tsmc._forward_filter_trunk(ssm, generator, ys, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", trunk_filter)
    jcfg, tcfg = _l96_small()
    assert jcfg.train.steps_per_call == 1 and jcfg.smc.objective == "fivo"
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_trunk.usable(jssm, jcfg.smc, 8) and trunk.usable(tssm, tcfg.smc)
    ys = observations(8, 6, dy=40, seed=8) * 3.0
    key = jax.random.key(17)
    j_opt = jtrain.make_optimizer(jcfg)
    want_params, _, want_m = jtrain.make_train_step(jssm, jcfg, j_opt)(
        params, j_opt.init(params), key, jnp.asarray(ys))

    noise = to_torch(key_noise(jax.random.split(key)[0], 8, 6, 40, 128))
    calls = (trunk.trunk_backward_reference.calls,
             resample_gather.segment_sum_scatter_reference.calls)
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    metrics = step(None, torch.from_numpy(ys), noise=noise)
    assert (trunk.trunk_backward_reference.calls,
            resample_gather.segment_sum_scatter_reference.calls) == (calls[0] + 5, calls[1] + 5)
    assert_close(metrics["loss"], want_m["loss"], 2e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_m["grad_norm"]), rtol=_RTOL)
    assert int(step.opt_state.count) == 1
    got_params = bridge.params_to_numpy(tssm)
    _assert_grads_close(got_params, want_params)
    assert not np.array_equal(got_params["q1"]["mean"][0], np.asarray(params["q1"]["mean"][0]))
