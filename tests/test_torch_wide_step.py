"""The whole-step kernels' class above width 64 (K1, K4, K14, K15) against
the reference.

The reference's whole-step gate takes any uniform relu width that is a
multiple of 8 (`pallas_step.usable`, pallas_step.py:161-162); the port's
class (`fused_step.usable`) now takes every width its plans hold in shared
memory, K1 and K14 under the tiled plan ("tile") above width 64. Held here,
on the CPU:

- the plain versions of K1 and K4 (what the kernels are held to on the
  card) against the reference's whole-scan kernels in interpret mode at
  widths 72 and 128: the filter's outputs within 2e-4, every gradient leaf
  within rtol 5e-3 / atol 5e-4;
- one FIVO train step at width 128 against the reference's jitted
  objective, and one PSVO loss at width 128 (the port's kernel path on CPU
  tensors: the plain versions of K1/K4 and K5/K6) against the reference's
  jitted objective through its kernels in interpret mode;
- the per-step plain chain (K14's and K15's plain versions) against the
  whole-scan plain versions at width 72;
- the gate: `usable` and `filter_route` at widths 72-256 on both devices,
  against `smc.reference_path`; every width from 8 to 256 at two hidden
  layers over the reference's K and (Dx, Dy, Di); where the class stops
  (the widest width at two layers), the raise;
- the tiled plan: where it is chosen, its tile of particles and its shape
  library's key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu import smc as jsmc
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.config import NetConfig, PRESETS
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step, svo, trunk
from tests._torch_port import (
    assert_close, assert_grads_close, key_noise, models, observations, psvo_interpret,
    psvo_noise, small_configs, to_torch,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4


def _configs(dx, dy, hidden, t, k=128, objective="fivo", **smc_kw):
    net = jconfig.NetConfig(hidden=hidden)
    jcfg = jconfig.Config(
        name="torch_wide_step_test",
        data=jconfig.DataConfig(datatype="fhn", dx=dx, dy=dy, t_steps=t),
        smc=jconfig.SMCConfig(objective=objective, n_particles=k, kernel_rng=True, **smc_kw),
        train=jconfig.TrainConfig(mse_k_steps=3),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                g=dataclasses.replace(net, sigma_init=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


def _loss(fwd, mean):
    """−mean(log Z) plus small terms on x_last and logw_last (the cotangents
    the kernels honour) and the ESS and filtered means (those they drop)."""
    return (-mean(fwd.log_z) + 1e-2 * mean(fwd.x_last) + 1e-3 * mean(fwd.logw_last)
            + 1e-3 * mean(fwd.ess) + 1e-2 * mean(fwd.filtered_means))


@pytest.mark.parametrize("dx, dy, hidden", [(2, 2, (72, 72)), (3, 1, (128,)), (2, 2, (128, 128))])
def test_plain_versions_match_reference_kernels_above_width_64(_interpret, dx, dy, hidden):
    """ScanForward on CPU tensors (scan_forward_reference, then
    scan_backward_reference: what K1 and K4 are held to on the card) against
    jax.value_and_grad through the reference's whole-scan kernels in
    interpret mode, on the reference's key-derived streams, at widths the
    port's class took only from this PR on: the filter's outputs within
    2e-4, every gradient leaf within rtol 5e-3 / atol 5e-4."""
    t, b = 4, 8
    jcfg, tcfg = _configs(dx, dy, hidden, t)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, b) and fused_step.usable(tssm, tcfg.smc)
    assert fused_step.k1_plan(fused_step.prepare(tssm)) == "tile"
    ys = observations(b, t, dy=dy, seed=3)
    key = jax.random.key(11)

    def reference(p):
        fwd = jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=False,
                                         encoder_inputs=None)
        return _loss(fwd, jnp.mean), fwd

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(reference, has_aux=True))(params)
    calls = (fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls)
    got = tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=False,
                                     streams=to_torch(key_noise(key, b, t, dx, 128)))
    for f in ("log_z", "increments", "filtered_means", "x_last", "logw_last"):
        assert_close(getattr(got, f).detach(), getattr(want, f), _TOL)
    loss = _loss(got, torch.mean)
    assert_close(loss.detach(), want_loss, _TOL)
    loss.backward()
    assert (fused_step.scan_forward_reference.calls,
            fused_step.scan_backward_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert_grads_close(bridge.grads_to_numpy(tssm), want_grads, _RTOL, _ATOL)


def test_fivo_train_step_at_width_128_matches_reference():
    """One train step of the FHN slice with every net at (128, 128), on the
    noise the reference derives from its key: the loss and the raw gradient
    norm of the step, and every gradient leaf of the objective, against
    jax.value_and_grad of the reference's jitted objective (its plain scan)."""
    jcfg, tcfg = small_configs(t=6, hidden=(128, 128))
    jcfg = dataclasses.replace(jcfg, use_pallas=False)
    jssm, params, tssm = models(jcfg, tcfg)
    assert fused_step.usable(tssm, tcfg.smc)
    ys = observations(4, 6, seed=2)
    key = jax.random.key(9)
    noise = to_torch(key_noise(jax.random.split(key)[0], 4, 6, 2, 128))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: j_make_objective(jssm, jcfg)(p, key, ys).loss))(params)
    out = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    out.loss.backward()
    assert_grads_close(bridge.grads_to_numpy(tssm), want_grads, _RTOL, _ATOL)
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    metrics = step(None, torch.from_numpy(ys), noise=noise)
    assert_close(metrics["loss"], want_loss, _RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                                                  jax.tree_util.tree_leaves(want_grads)))),
                               rtol=_RTOL)
    assert int(step.opt_state.count) == 1


def test_psvo_kernel_path_at_width_128_matches_reference_kernels(psvo_interpret, monkeypatch):
    """The PSVO objective on Lorenz-63 with q1, f and g at (128, 128), the
    direct bound, through the port's kernel path on CPU tensors (ScanForward
    with the particle cache, then FFBSiSweep: the plain versions of K1/K4 and
    K5/K6) against jax.value_and_grad of the reference's jitted objective
    through its whole-scan and FFBSi kernels in interpret mode: the loss and
    the smoothed paths within 2e-4, every gradient leaf within rtol 5e-3 /
    atol 5e-4."""
    b, t, dx, k, m = 8, 4, 3, 128, 8
    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=t, hidden=(128, 128),
                               n_smoothing_particles=m, psvo_bound="direct")
    jssm, params, tssm = models(jcfg, tcfg)
    assert fused_step.usable(tssm, tcfg.smc)
    ys = observations(b, t, dy=dx, seed=9)
    key = jax.random.key(17)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    def fused_filter(ssm, generator, ys_, cfg, *, cache, encoder_inputs, noise):
        return tsmc._forward_filter_fused(ssm, generator, ys_, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", fused_filter)
    calls = [f.calls for f in (fused_step.scan_forward_reference,
                               fused_step.scan_backward_reference,
                               ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)]
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=psvo_noise(key, b, t, dx, k, m))
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    got.loss.backward()
    assert [f.calls - n for f, n in zip((fused_step.scan_forward_reference,
                                         fused_step.scan_backward_reference,
                                         ffbsi.ffbsi_forward_reference,
                                         ffbsi.ffbsi_backward_reference), calls)] == [1, 1, 1, 1]
    assert_grads_close(bridge.grads_to_numpy(tssm), want_grads, _RTOL, _ATOL)


def test_per_step_plain_chain_equals_the_whole_scan_plain_version_at_width_72():
    """At (Dx, Dy) = (2, 2) and two hidden layers of 72: T−1
    step_forward_reference calls equal one scan_forward_reference call, and
    the T−1 step_backward_reference calls chained in reverse (d x_new the
    next step's d x plus d_x_all[t], d α = d_alpha_all[t]) equal one
    scan_backward_reference call, within 1e-6."""
    _, tcfg = _configs(2, 2, (72, 72), 6)
    g = torch.Generator().manual_seed(5)
    ssm = SSM(tcfg)
    with torch.no_grad():
        for p in ssm.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
        consts = fused_step.prepare(ssm)
    t1, b, k, dx = 5, 3, 256, 2
    coef = torch.randn((t1, b, fused_step.coef_width(consts)), generator=g)
    coef[..., dx:2 * dx] = 1.0 + 0.1 * coef[..., dx:2 * dx]  # cq
    coef[..., 2 * dx:3 * dx] = 0.5 + 0.1 * coef[..., 2 * dx:3 * dx].abs()  # sq
    x0 = torch.randn((b, dx, k), generator=g)
    a0 = torch.randn((b, k), generator=g)
    eps = torch.randn((t1, b, dx, k), generator=g)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g), k)
    with torch.no_grad():
        scan = fused_step.scan_forward_reference(x0, a0, coef, consts, eps, pos, cache=True,
                                                 save_res=True)
        x, lw, steps = x0, a0, []
        for t in range(t1):
            steps.append(fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t]))
            x, lw = steps[-1][:2]
    chain = [torch.stack([s[i] for s in steps]) for i in range(4)]
    assert torch.equal(chain[3], scan[5])
    for a, w in zip(chain[:3], (scan[3], scan[4], scan[2])):
        assert_close(a, w, 1e-6)
    x_all, alpha_all, stats, idx = chain
    d_stats = torch.randn(stats.shape, generator=g)
    d_x_last = torch.randn(x0.shape, generator=g)
    d_x_all = 0.1 * torch.randn(x_all.shape, generator=g)
    d_a_all = 0.1 * torch.randn(alpha_all.shape, generator=g)
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats, d_x_last,
                                              None, d_x_all, d_a_all)
    d_x, d_coef, d_packed, d_sconst = d_x_last, [None] * t1, 0.0, 0.0
    for t in reversed(range(t1)):
        d_x, d_coef[t], dp, ds = fused_step.step_backward_reference(
            x0 if t == 0 else x_all[t - 1], coef[t], consts, eps[t], idx[t], d_stats[t],
            d_x + d_x_all[t], d_a_all[t])
        d_packed, d_sconst = d_packed + dp, d_sconst + ds
    for a, w in zip((d_x, torch.stack(d_coef), d_packed, d_sconst), want):
        assert_close(a, w, 1e-6)


_MODELS = {}


def _model(dx, dy, di, hidden):
    """The port's SSM of the FHN preset at these widths, on the meta device:
    the gates read its shapes and modes alone."""
    key = (dx, dy, di, hidden)
    if key not in _MODELS:
        cfg = PRESETS["fhn_fivo_k1024_bench"]
        net = NetConfig(hidden=hidden)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, di=di))
        with torch.device("meta"):
            _MODELS[key] = SSM(cfg.with_nets(q0=net, q1=net, q2=net, f=net, g=net))
    return _MODELS[key]


@pytest.mark.parametrize("h", [72, 96, 128, 192, 256])
def test_usable_and_filter_route_above_width_64(h):
    """At widths 72-256 (one and two hidden layers, every (Dx, Dy, Di) with
    max(Dx + Di, Dy) <= 7, K a multiple of 128 up to 2048) the reference runs
    its whole-step kernel, the port's class takes it, and the filter's route
    is the whole scan on both devices (segmented too); the trunk and SVO
    classes do not take the width."""
    smc_cfg = PRESETS["fhn_fivo_k1024_bench"].smc
    n = 0
    for dx in range(1, 8):
        for dy in range(1, 8):
            for di in range(0, 8 - dx):
                for depth in (1, 2):
                    ssm = _model(dx, dy, di, (h,) * depth)
                    for k in (128, 384, 1024, 2048):
                        cfg = dataclasses.replace(smc_cfg, n_particles=k)
                        label = (dx, dy, di, depth, k)
                        assert tsmc.reference_path(ssm, cfg) == "fused", label
                        assert fused_step.usable(ssm, cfg), label
                        for cuda in (True, False):
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=cuda) == "fused", label
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=cuda,
                                                     segmented=True) == "fused", label
                        assert not trunk.usable(ssm, cfg), label
                        n += 1
    assert not svo.in_class(2, 2, 0, h)
    assert n == 7 * sum(8 - dx for dx in range(1, 8)) * 2 * 4


def test_every_width_to_256_at_two_layers_fits_the_plans():
    """Every width from 8 to 256 in steps of 8 at two hidden layers, at every
    K of the reference's class (multiples of 128 up to 2048) and every
    (Dx, Dy, Di) with max(Dx + Di, Dy) <= 7, fits K1/K14, K4 (on some
    cluster size) and K15 (`shape_fits`); above width 64 K1's plan is the
    tiled one."""
    for dx in range(1, 8):
        for dy in range(1, 8):
            for di in range(0, 8 - dx):
                for h in range(8, 257, 8):
                    c = fused_step.shape_consts(dx, dy, di, h, 1)
                    assert fused_step._in_class(c), (dx, dy, di, h)
                    for k in range(128, 2049, 128):
                        assert fused_step.shape_fits(c, k), (dx, dy, di, h, k)
                    assert (fused_step.k1_plan(c) == "tile") == (h > 64), (dx, dy, di, h)


@pytest.mark.parametrize("d, widest", [(2, 1344), (7, 856)])
def test_the_widest_width_at_two_layers_and_the_raise_past_it(d, widest):
    """At Dx = Dy = d, two hidden layers and K = 2048 the plans hold widths
    up to `widest` (K4 under "stream" with tiles of 16 particles on clusters
    of 8 is the limit: two activation tiles of [H][20] floats); one step of
    8 wider is a hole of ROADMAP queue 2 B: the reference runs its
    whole-step kernel, the port's class stops, and the filter raises on CUDA
    tensors (the plain loop on CPU tensors)."""
    fits = [h for h in range(8, 2049, 8)
            if fused_step.shape_fits(fused_step.shape_consts(d, d, 0, h, 1), 2048)]
    assert max(fits) == widest and fits == list(range(8, widest + 1, 8))
    smc_cfg = dataclasses.replace(PRESETS["fhn_fivo_k1024_bench"].smc, n_particles=2048)
    ssm = _model(d, d, 0, (widest + 8,) * 2)
    assert tsmc.reference_path(ssm, smc_cfg) == "fused"
    assert not fused_step.usable(ssm, smc_cfg) and not trunk.usable(ssm, smc_cfg)
    assert tsmc.filter_route(ssm, smc_cfg, 5, cuda=True) == "raise"
    assert tsmc.filter_route(ssm, smc_cfg, 5, cuda=False) == "plain"
    assert fused_step.usable(_model(d, d, 0, (widest,) * 2), smc_cfg)


@pytest.mark.parametrize("dx, dy, di, h, k, tile1, tile4", [
    (2, 2, 0, 72, 2048, 64, 64), (2, 2, 0, 256, 2048, 64, 64), (7, 7, 0, 256, 1920, 32, 32),
    (2, 2, 0, 384, 1920, 32, 32), (7, 7, 0, 328, 2048, 16, 64), (6, 1, 1, 256, 1920, 32, 32),
    (2, 2, 0, 1344, 2048, 8, 16)])
def test_tiled_plan_and_its_shape_library(dx, dy, di, h, k, tile1, tile4):
    """Above width 64 K1 and K14 run the tiled plan, with the largest tile
    of particles whose CTA fits shared memory at K = 2048 (its bits do not
    depend on it); K4 and K15 keep tiles of 64 particles but where two
    layers under "stream" fit only narrower ones at K (at K = 1920 a row
    takes one or two CTAs, at 2048 up to eight); the shape library's key
    carries the tiles. At width 64 the register plans stay, and the
    presets' shapes come from the kernels' own library."""
    c = fused_step.shape_consts(dx, dy, di, h, 1)
    assert fused_step.k1_plan(c) == "tile" and fused_step.k1_tile(c) == tile1
    assert fused_step.k4_tile(c, k) == tile4 and fused_step.shape_fits(c, k)
    assert fused_step.k1_smem_bytes(c, 2048) <= fused_step.SMEM_LIMIT
    if tile1 < fused_step.K1_TILES[0]:
        wider = fused_step.K1_TILES[fused_step.K1_TILES.index(tile1) - 1]
        assert fused_step.k1_smem_bytes(c, 2048, "tile", wider) > fused_step.SMEM_LIMIT
    if tile4 < fused_step.K4_TILES[0]:
        wider = fused_step.K4_TILES[fused_step.K4_TILES.index(tile4) - 1]
        assert fused_step.k4_plan(c, k) == "stream"
        assert min(fused_step.k4_smem_bytes(c, k, n, "stream", wider)
                   for n in fused_step._clusters_at(k)) > fused_step.SMEM_LIMIT
    key = fused_step.shape_key(c, k)
    want = (dx, dy, h, 1, fused_step.K1_PLANS.index("tile"),
            fused_step.K4_PLANS.index(fused_step.k4_plan(c, k)), tile1)
    assert key == (want + (tile4,) if tile4 < 64 else want)
    assert fused_step._lib_key(c, False, k) == key == fused_step._lib_key(c, True, k)
    for d in (2, 3):
        preset = fused_step.shape_consts(d, d, 0, 64, 1)
        assert fused_step.k1_plan(preset) == "smem" and len(fused_step.shape_key(preset)) == 6
        assert fused_step._lib_key(preset, False) is None


def test_k4_plan_follows_k_where_the_shapes_plan_does_not_fit():
    """A shape keeps the plan it takes at K = 2048 (on up to eight CTAs a
    row) wherever that plan fits; at K = 1920, where a row takes one or two
    CTAs, three layers of 64 move from "global" to "split" (every plan gives
    the same bits), so the reference's whole class fits at every K, the
    presets' shapes staying in the kernels' own library."""
    deep = fused_step.shape_consts(2, 2, 0, 64, 2)
    assert [fused_step.k4_plan(deep, k) for k in (1024, 1920, 2048)] == ["global", "split",
                                                                         "global"]
    assert fused_step._lib_key(deep, True, 1024) == fused_step._lib_key(deep, True)
    assert fused_step._lib_key(deep, True, 1920) == (2, 2, 64, 2, 0, 2)
    for d in (2, 3):
        for h in (16, 32, 64):
            preset = fused_step.shape_consts(d, d, 0, h, 1)
            assert all(fused_step._lib_key(preset, True, k) is None
                       for k in range(128, 2049, 128))
    for n_mid in range(5):
        for h in range(8, 73, 8):
            c = fused_step.shape_consts(1, 3, 1, h, n_mid)
            if fused_step.shape_fits(c, 2048):
                assert all(fused_step.shape_fits(c, k) for k in range(128, 2049, 128)), (h, n_mid)
