"""Multinomial resampling in the torch port's kernel classes, against the JAX
reference.

Multinomial resampling draws K sorted iid positions per row and step
(`resampling.bulk_positions`) where systematic draws one offset; the kernels
search any sorted position stream over the row's CDF, so the whole-scan (K1,
K4), per-step (K14, K15) and trunk (K7, K8, K9; K10, K11) classes take it,
as the reference's whole-step kernel does (`pallas_step.py:139`) and its
trunk path (which resamples outside its kernel). In-kernel RNG makes
systematic positions only, so a multinomial run streams its noise, as the
reference's (`smc.py:419-429`); on the trunk path K9 keeps its in-kernel ε
and the positions are streamed (`smc.py:312-318`).

Small sizes: B = 8, K = 128, T = 5, hidden (16, 16), FHN (Dx = 2),
Lorenz-63 (Dx = 3) and the reference's trunk test shape (Lorenz-96 data at
Dx = 10). Values at 2e-4 (the ESS at 2e-3), gradients at rtol 5e-3 /
atol 5e-4, the tolerances of the systematic slices (tests/test_torch_slice.py,
tests/test_torch_step.py, tests/test_torch_psvo.py). Checked:

- the whole-scan and per-step paths' plain versions on the positions the
  reference derives from its key against the reference's whole-scan and
  per-step kernels in interpret mode, values and gradients;
- the trunk path's plain versions against the reference's trunk path in
  interpret mode;
- PSVO's kernel path with multinomial resampling against the reference's
  kernels;
- K1's and K14's plain versions: every step's ancestors are the count form
  on sorted iid positions, and a chain of K14 steps gives K1's bits;
- the gates and the streamed draw (no K2 replay under kernel_rng).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import smc as jsmc
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_ffbsi, pallas_resample, pallas_step, pallas_trunk
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step, resample_gather, trunk
from tests._torch_port import (
    assert_close, assert_grads_close, key_noise, models, observations, small_configs, to_torch,
)

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4
_FIELDS = ("log_z", "increments", "filtered_means", "x_last", "logw_last")
B, K = 8, 128


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_step, pallas_resample, pallas_trunk, pallas_ffbsi):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "BF16_RESIDUALS", False)


def _compare_filter(got, want, cache):
    for f in _FIELDS + (("xs", "logws") if cache else ()):
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    assert_close(got.ess.detach(), want.ess, 2e-3)


def _loss(fwd, mean):
    """log Ẑ with the last weights and particles, so that K4/K15 see more
    than the stats' cotangents."""
    return -mean(fwd.log_z) + 1e-3 * mean(fwd.logw_last) + 1e-2 * mean(fwd.x_last)


@pytest.mark.parametrize("scan_fused,datatype", [(True, "fhn"), (True, "lorenz63"),
                                                 (False, "fhn")])
def test_multinomial_kernel_paths_match_reference(_interpret, monkeypatch, scan_fused, datatype):
    """The whole-scan path (ScanForward: K1/K4's plain versions) and, with
    SCAN_FUSED off, the per-step path (StepForward: K14/K15's) on multinomial
    positions, against the reference's whole-scan or per-step kernels in
    interpret mode on the positions its key gives (kernel_rng on, which
    multinomial turns off on both sides): the filter with its cache, then
    the loss and every gradient leaf."""
    monkeypatch.setattr(fused_step, "SCAN_FUSED", scan_fused)
    monkeypatch.setattr(pallas_step, "SCAN_FUSED", scan_fused)
    jcfg, tcfg = small_configs(t=5, datatype=datatype, resampling="multinomial",
                               kernel_rng=True)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, B) and fused_step.usable(tssm, tcfg.smc)
    dx = jssm.dx
    ys = observations(B, 5, dy=dx, seed=3)
    key = jax.random.key(11)

    def reference(p):
        return jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                          encoder_inputs=None)

    want = reference(params)
    noise = to_torch(key_noise(key, B, 5, dx, K, "multinomial"))
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.step_forward_reference, fused_step.step_backward_reference)
    calls = [f.calls for f in plain]
    got = tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=True,
                                     streams=noise)
    _compare_filter(got, want, cache=True)
    want_loss, want_grads = jax.value_and_grad(lambda p: _loss(reference(p), jnp.mean))(params)
    loss = _loss(got, torch.mean)
    for p in tssm.parameters():
        p.grad = None
    loss.backward()
    assert [f.calls - n for f, n in zip(plain, calls)] == (
        [1, 1, 0, 0] if scan_fused else [0, 0, 4, 4])
    assert_close(loss.detach(), want_loss, 2e-4)
    assert_grads_close(bridge.grads_to_numpy(tssm), want_grads, _RTOL, _ATOL)


def test_multinomial_trunk_path_matches_reference(_interpret):
    """The port's `_forward_filter_trunk` (K7/K8/K9's plain versions) on
    multinomial positions against the reference's trunk path in interpret
    mode, cache on, at the reference's trunk-test shape (Lorenz-96 data,
    Dx = Dy = 10)."""
    from psvo_tpu import config as jconfig

    net = jconfig.NetConfig(hidden=(16, 16))
    jcfg = jconfig.Config(
        name="trunk_port_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=10, dy=10, t_steps=5),
        smc=jconfig.SMCConfig(objective="fivo", n_particles=K, n_smoothing_particles=4,
                              resampling="multinomial"),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5),
                qb=net)
    tcfg = tconfig.from_dict(jcfg.to_dict())
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_trunk.usable(jssm, jcfg.smc, B)
    ys = observations(B, 5, dy=10, seed=3)
    key = jax.random.key(11)
    want = jsmc._forward_filter_trunk(jssm, params, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                      encoder_inputs=None)
    calls = (trunk.trunk_forward_reference.calls,
             resample_gather.ancestor_indices_large_reference.calls)
    with torch.no_grad():
        got = tsmc._forward_filter_trunk(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=True,
                                         streams=to_torch(key_noise(key, B, 5, 10, K,
                                                                    "multinomial")))
    assert (trunk.trunk_forward_reference.calls - calls[0],
            resample_gather.ancestor_indices_large_reference.calls - calls[1]) == (4, 4)
    _compare_filter(got, want, cache=True)


def test_multinomial_psvo_kernel_path_matches_reference_kernels(_interpret, monkeypatch):
    """PSVO (direct bound) on multinomial resampling through the whole
    kernel path on CPU tensors (K1/K4, K5/K6's plain versions) against the
    reference's whole-scan and FFBSi kernels in interpret mode."""
    from tests._torch_port import psvo_noise

    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=5,
                               n_smoothing_particles=8, psvo_bound="direct",
                               resampling="multinomial")
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, 5, dy=3, seed=9)
    key = jax.random.key(17)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    k_fwd, _ = jax.random.split(key)
    noise = list(psvo_noise(key, B, 5, 3, K, 8))
    noise[:3] = to_torch(key_noise(k_fwd, B, 5, 3, K, "multinomial"))

    def fused_filter(ssm, generator, ys_, cfg, *, cache, encoder_inputs, noise):
        return tsmc._forward_filter_fused(ssm, generator, ys_, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", fused_filter)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    calls = [f.calls for f in plain]
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=tuple(noise))
    for p in tssm.parameters():
        p.grad = None
    got.loss.backward()
    assert [f.calls - n for f, n in zip(plain, calls)] == [1, 1, 1, 1]
    assert_close(got.loss.detach(), want_loss, 2e-4)
    assert_close(got.smoothed.detach(), want.smoothed, 2e-4)
    assert_grads_close(bridge.grads_to_numpy(tssm), want_grads, _RTOL, _ATOL)


@pytest.mark.parametrize("datatype", ["fhn", "lorenz63"])
def test_multinomial_ancestors_are_the_count_form_and_the_step_chain_is_k1(datatype):
    """K1's plain version on sorted iid positions: every step's ancestors are
    the count form on its incoming weights (positions bunch where the weight
    is), and a chain of K14's plain version gives its bits."""
    _, tcfg = small_configs(t=6, datatype=datatype)
    ssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    dx, t1 = ssm.dx, 5
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    x0 = torch.randn((B, dx, K), generator=g) * 2.0
    a0 = torch.randn((B, K), generator=g) * 3.0
    coef = torch.rand((t1, B, 4 * dx + 1), generator=g) + 0.1
    eps = torch.randn((t1, B, dx, K), generator=g)
    pos = torch.sort(torch.rand((t1, B, K), generator=g), dim=-1).values
    with torch.no_grad():
        got = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                      save_res=True)
        incoming = torch.cat([a0[None], got[4][:-1]])
        for t in range(t1):
            assert torch.equal(got[5][t], fused_step.count_form_indices(incoming[t], pos[t]))
        x, lw = x0, a0
        for t in range(t1):
            x, lw, _, idx = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t])
            assert torch.equal(idx, got[5][t]) and torch.equal(x, got[3][t])


def test_multinomial_gates_and_streamed_draw():
    """The whole-scan and trunk classes take multinomial resampling, as the
    reference's gates do; ESS-adaptive resampling stays outside both. Under
    kernel_rng a multinomial filter on CPU tensors streams its noise (no K2
    replay) and runs K1's plain version once; the segmented filter draws its
    positions per segment the same way."""
    for name in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024", "lorenz63_svo_k256",
                 "fhn_fivo_controls"):
        cfg = PRESETS[name]
        multi = dataclasses.replace(cfg.smc, resampling="multinomial")
        assert fused_step.usable(SSM(cfg), multi), name
        assert tsmc.reference_path(SSM(cfg), multi) == "fused", name
    l96 = PRESETS["lorenz96_fivo_k8192_sharded"]
    assert trunk.usable(SSM(l96), dataclasses.replace(l96.smc, resampling="multinomial"))
    ess = dataclasses.replace(PRESETS["fhn_fivo_k1024_bench"].smc, ess_threshold=0.5)
    assert not fused_step.usable(SSM(PRESETS["fhn_fivo_k1024_bench"]), ess)

    _, tcfg = small_configs(t=5, resampling="multinomial", kernel_rng=True)
    tssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    ys = torch.from_numpy(observations(4, 5, seed=6))
    calls = (fused_step.scan_forward_reference.calls, fused_step.stream_noise_reference.calls)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, torch.Generator().manual_seed(2), ys, tcfg.smc,
                                  cache=True)
    assert (fused_step.scan_forward_reference.calls - calls[0],
            fused_step.stream_noise_reference.calls - calls[1]) == (1, 0)
    gen = torch.Generator().manual_seed(2)
    streams = tsmc._draw_noise(gen, tcfg.smc, 5, 4, 2)
    assert streams[2].shape == (4, 4, K)
    assert bool((torch.diff(streams[2], dim=-1) >= 0).all())
    with torch.no_grad():
        want = tsmc._forward_filter_fused(tssm, None, ys, tcfg.smc, cache=True, streams=streams)
    _compare_filter(got, want, cache=True)

    _, seg_cfg = small_configs(objective="psvo", t=9, resampling="multinomial",
                               kernel_rng=True, ffbsi_segments=2, n_smoothing_particles=4)
    sssm = SSM(seg_cfg).init(torch.Generator().manual_seed(0))
    noise_calls = fused_step.stream_noise_reference.calls
    with torch.no_grad():
        out = t_make_objective(sssm, seg_cfg)(torch.Generator().manual_seed(3),
                                              torch.from_numpy(observations(4, 9, seed=1)))
    assert fused_step.stream_noise_reference.calls == noise_calls
    assert bool(torch.isfinite(out.loss))
