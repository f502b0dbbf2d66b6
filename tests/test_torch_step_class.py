"""The whole-step kernels' class (K1, K4, K14, K15) against the reference's.

- The gate: over a grid of (Dx, Dy, Di), depth, width and K,
  `fused_step.usable` agrees with `smc.reference_path(...) == "fused"`
  inside the reference's whole-step class (K a multiple of 128 up to 2048,
  max(Dx + Di, Dy) <= 7, uniform relu widths 8..72, one to five hidden
  layers); where the reference sends a configuration to its whole-step
  kernel outside that, the port takes it where its plans hold it, and
  where they do not (two layers of 2048; a net deeper than any plan's
  shared memory holds) `smc.filter_route` says "raise" on CUDA tensors (or
  "trunk" where the port's trunk class takes it) and "plain" on CPU
  tensors. SVO's class (`svo.usable`) is the reference's SVO gate's up to
  width 64 (tests/test_torch_smoothing_class.py holds it to that gate).
- The plain versions (what the kernels are held to on the card) against the
  reference's whole-scan kernels in interpret mode at shapes the presets do
  not have: Dy != Dx, widths 8, 24, 48, one to three layers, controls.
- The per-step plain chain (K14's and K15's plain versions) against the
  whole-scan plain versions at one new shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu import smc as jsmc
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.config import NetConfig, PRESETS
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import fused_step, svo, trunk
from tests._torch_port import assert_close, key_noise, models, observations, to_torch

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4  # gradient leaves, as tests/test_torch_train.py
_WIDTHS = (8, 24, 48, 64, 72, 2048)
_DEPTHS = (1, 2, 3, 4, 5)
_KS = (96, 128, 384, 2048, 2176)
_MODELS = {}


def _model(dx, dy, di, hidden):
    """The port's SSM (its shapes and modes only, on the meta device) of the
    FHN preset at these widths."""
    key = (dx, dy, di, hidden)
    if key not in _MODELS:
        cfg = PRESETS["fhn_fivo_k1024_bench"]
        net = NetConfig(hidden=hidden)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, di=di))
        with torch.device("meta"):
            _MODELS[key] = SSM(cfg.with_nets(q0=net, q1=net, q2=net, f=net, g=net))
    return _MODELS[key]


def _in_set(dx, dy, di, h, depth, k):
    return (k % 128 == 0 and 128 <= k <= 2048 and max(dx + di, dy) <= 7 and 8 <= h <= 72
            and h % 8 == 0 and 1 <= depth <= 5)


@pytest.mark.parametrize("dx", range(1, 9))
def test_usable_agrees_with_the_reference_gate(dx):
    smc_cfg = PRESETS["fhn_fivo_k1024_bench"].smc
    inside = outside = 0
    for dy in range(1, 9):
        for di in (0, 1, 2):
            for h in _WIDTHS:
                for depth in _DEPTHS:
                    ssm = _model(dx, dy, di, (h,) * depth)
                    for k in _KS:
                        cfg = dataclasses.replace(smc_cfg, n_particles=k)
                        ref = tsmc.reference_path(ssm, cfg)
                        label = (dx, dy, di, h, depth, k, ref)
                        if _in_set(dx, dy, di, h, depth, k):
                            inside += 1
                            assert ref == "fused", label
                            assert fused_step.usable(ssm, cfg), label
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=True) == "fused", label
                        elif ref == "fused" and fused_step.usable(ssm, cfg):  # the plans hold it
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=True) == "fused", label
                        elif ref == "fused":
                            outside += 1
                            route = "trunk" if trunk.usable(ssm, cfg) else "raise"
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=True) == route, label
                            if route == "raise":
                                assert tsmc.filter_route(ssm, cfg, 5, cuda=False) == "plain"
                            assert tsmc.filter_route(ssm, cfg, 5, cuda=True,
                                                     segmented=True) == "raise", label
                        if (k == 2048 and depth <= 3
                                and tsmc.reference_svo_path(ssm, 32) == "kernel"):
                            assert svo.usable(ssm, 32) == (h <= 64), label
    assert (inside > 0 and outside > 0) if dx <= 7 else inside == outside == 0


def test_svo_keeps_its_own_shapes():
    """K12/K13's library keeps its own shapes, the presets' (svo's constants,
    narrower than the whole-step class's); every other shape of the class,
    widths 8..64 (its own, narrower than the whole-step class's), is built
    into a shape library of its own: Lorenz-63 seen through one channel at
    width 48 runs the kernels too."""
    assert svo.KERNEL_DIMS == ((2, 2), (3, 3)) and svo.HIDDEN_WIDTHS == (16, 32, 64)
    assert all(fused_step._in_class(fused_step.shape_consts(dx, dy, 0, 16, 1))
               for dx, dy in svo.KERNEL_DIMS)
    assert fused_step._in_class(fused_step.shape_consts(3, 1, 0, 48, 1))
    assert set(svo.HIDDEN_WIDTHS) < set(svo.CLASS_WIDTHS) == set(range(8, 65, 8))
    assert fused_step._in_class(fused_step.shape_consts(3, 3, 0, 72, 1))  # wider than SVO's
    assert svo.usable(_model(3, 3, 0, (64, 64)), 32)
    net = NetConfig(hidden=(48, 48))
    l63_dy1 = PRESETS["lorenz63_svo_k256"]
    l63_dy1 = dataclasses.replace(l63_dy1, data=dataclasses.replace(l63_dy1.data, dy=1))
    assert svo.usable(SSM(l63_dy1.with_nets(qb=net, f=net, g=net)), 32)
    assert svo.lib_key(3, 3, 64) is None and svo.lib_key(3, 1, 48) == ("svo", 3, 1, 48)


def test_every_plan_of_the_set_fits_shared_memory():
    """Every shape of the reference's class at K = 2048 fits each kernel under
    the plan `k1_plan` / `k4_plan` choose (one to five hidden layers, widths
    8..72: K1's tiled plan above 64), the presets keep every plan in shared
    memory, and each plan is needed somewhere."""
    plans = set()
    for dx in range(1, 8):
        for dy in range(1, 8):
            for di in range(0, 8 - dx):
                for h in range(8, 73, 8):
                    for n_mid in range(5):
                        c = fused_step.shape_consts(dx, dy, di, h, n_mid)
                        assert fused_step.shape_fits(c, 2048), (dx, dy, di, h, n_mid)
                        plans.add((fused_step.k1_plan(c), fused_step.k4_plan(c)))
    assert {p for p, _ in plans} == set(fused_step.K1_PLANS)
    assert {p for _, p in plans} == set(fused_step.K4_PLANS)
    for dx, h in ((2, 16), (2, 64), (3, 32), (3, 64)):
        c = fused_step.shape_consts(dx, dx, 0, h, 1)
        assert (fused_step.k1_plan(c), fused_step.k4_plan(c)) == ("smem", "smem")
        assert fused_step._lib_key(c, False) is None and fused_step._lib_key(c, True) is None
    deep = fused_step.shape_consts(2, 2, 0, 64, 2)
    assert fused_step._lib_key(deep, False) is None  # K1 takes any depth from the library
    assert fused_step._lib_key(deep, True) == (2, 2, 64, 2, 0, 1)


def _class_configs(dx, dy, di, hidden, t):
    net = jconfig.NetConfig(hidden=hidden)
    jcfg = jconfig.Config(
        name="torch_step_class_test",
        data=jconfig.DataConfig(datatype="fhn", dx=dx, dy=dy, di=di, control_scale=0.5,
                                t_steps=t),
        smc=jconfig.SMCConfig(objective="fivo", n_particles=128, kernel_rng=True),
        train=jconfig.TrainConfig(mse_k_steps=3),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                g=dataclasses.replace(net, sigma_init=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("dx, dy, deepest", [(2, 2, 12), (3, 3, 11), (7, 7, 10)])
def test_depth_stops_where_shared_memory_does(dx, dy, deepest):
    """At width 64 and K = 2048 the class takes nets as deep as K4's
    smallest plan ("stream": the weights and their gradient sums in device
    memory, one net's activation tiles at a time) fits a CTA's shared memory
    on some cluster size: `deepest` hidden layers. One more is outside the
    whole-step class, where the reference runs its whole-step kernel; the
    trunk class takes it (K9 and K10 with their weights in device memory),
    so `smc.filter_route` says "trunk" on CUDA tensors. Where the trunk
    class stops too (K10's streamed tiles), the net is a hole of ROADMAP
    queue 2 B: "raise", before any launch."""
    smc_cfg = dataclasses.replace(PRESETS["fhn_fivo_k1024_bench"].smc, n_particles=2048)
    for depth in (deepest, deepest + 1):
        c = fused_step.shape_consts(dx, dy, 0, 64, depth - 1)
        least = min(fused_step.k4_smem_bytes(c, 2048, n, "stream") for n in (1, 2, 4, 8))
        assert (least <= fused_step.SMEM_LIMIT) == (depth == deepest), (depth, least)
        ssm = _model(dx, dy, 0, (64,) * depth)
        assert tsmc.reference_path(ssm, smc_cfg) == "fused"
        assert fused_step.usable(ssm, smc_cfg) == (depth == deepest)
        assert trunk.usable(ssm, smc_cfg)
        want = "fused" if depth == deepest else "trunk"
        assert tsmc.filter_route(ssm, smc_cfg, 5, cuda=True) == want, depth
    hole = next(d for d in range(deepest + 1, 40) if not trunk.shape_ok(dx, dy, 64, d - 1))
    ssm = _model(dx, dy, 0, (64,) * hole)
    assert not (fused_step.usable(ssm, smc_cfg) or trunk.usable(ssm, smc_cfg))
    assert tsmc.filter_route(ssm, smc_cfg, 5, cuda=True) == "raise", hole


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


def _loss(fwd, mean):
    """−mean(log Z) plus small terms on x_last and logw_last (the cotangents
    the kernels honour) and the ESS and filtered means (those they drop)."""
    return (-mean(fwd.log_z) + 1e-2 * mean(fwd.x_last) + 1e-3 * mean(fwd.logw_last)
            + 1e-3 * mean(fwd.ess) + 1e-2 * mean(fwd.filtered_means))


@pytest.mark.parametrize("dx, dy, di, hidden", [
    (2, 1, 0, (8,)), (3, 1, 0, (48, 48)), (5, 5, 2, (24, 24, 24)),
])
def test_plain_versions_match_reference_kernels_at_new_shapes(_interpret, dx, dy, di, hidden):
    """ScanForward on CPU tensors (scan_forward_reference, then
    scan_backward_reference) against jax.value_and_grad through the
    reference's whole-scan kernels in interpret mode, on the reference's
    key-derived streams: the filter's outputs within 2e-4, every gradient
    leaf within rtol 5e-3 / atol 5e-4."""
    t, b = 4, 8
    jcfg, tcfg = _class_configs(dx, dy, di, hidden, t)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, b) and fused_step.usable(tssm, tcfg.smc)
    ys = observations(b, t, dy=dy, seed=3)
    u = (0.5 * np.random.default_rng(4).standard_normal((b, t, di))).astype(np.float32)
    key = jax.random.key(11)
    kw = {"controls": jnp.asarray(u)} if di else {}

    def reference(p):
        fwd = jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=False,
                                         encoder_inputs=None, **kw)
        return _loss(fwd, jnp.mean), fwd

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(reference, has_aux=True))(params)
    calls = (fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls)
    got = tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=False,
                                     streams=to_torch(key_noise(key, b, t, dx, 128)),
                                     controls=torch.from_numpy(u) if di else None)
    for f in ("log_z", "increments", "filtered_means", "x_last", "logw_last"):
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    loss = _loss(got, torch.mean)
    assert_close(loss.detach(), want_loss, 2e-4)
    for p in tssm.parameters():
        p.grad = None
    loss.backward()
    assert (fused_step.scan_forward_reference.calls,
            fused_step.scan_backward_reference.calls) == (calls[0] + 1, calls[1] + 1)
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_grads)
    flat_got = jax.tree_util.tree_leaves(bridge.grads_to_numpy(tssm))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_per_step_plain_chain_equals_the_whole_scan_plain_version():
    """At (Dx, Dy) = (3, 1), three hidden layers of 24 and controls: T−1
    step_forward_reference calls equal one scan_forward_reference call, and
    the T−1 step_backward_reference calls chained in reverse (d x_new the
    next step's d x plus d_x_all[t], d α = d_alpha_all[t]) equal one
    scan_backward_reference call, within 1e-6."""
    _, tcfg = _class_configs(3, 1, 2, (24, 24, 24), 6)
    g = torch.Generator().manual_seed(5)
    ssm = SSM(tcfg)
    with torch.no_grad():
        for p in ssm.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
        consts = fused_step.prepare(ssm)
    t1, b, k, dx = 5, 3, 256, 3
    width = fused_step.coef_width(consts)
    coef = torch.randn((t1, b, width), generator=g)
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
