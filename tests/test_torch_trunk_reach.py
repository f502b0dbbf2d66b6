"""The trunk class at the reference's reach, against the JAX reference.

The reference's trunk gate (`pallas_trunk.usable`, pallas_trunk.py:84-121)
takes every (Dx, Dy, Di) with max(Dx + Di, Dy) + 1 <= 56 state rows and
relu q1/f/g trunks of one uniform width that is a multiple of 8. The
port's trunk class (`trunk.usable`) takes the same, widths 8 to 64, every
shape outside the presets' built into a trunk shape library of its own on
the card, the weights in shared memory where they fit beside the tiles and
in device memory where they do not (`trunk.k9_weights`, `k10_weights`).
Its holes, where the filter raises on CUDA tensors before any launch:
widths above 64, and nets deeper than K10's tiles hold with the weights in
device memory (`trunk.shape_ok`).

Held here, on the CPU, at B = 8 (the reference trunk kernel's row block),
K = 128, T = 4: the port's trunk path (K7-K11's plain versions) against the
reference's trunk path with its trunk and resampling kernels in interpret
mode, on the same params (`bridge`) and the reference's key-derived draws,
at Lorenz-96 with D = 20 (width 48), FHN seen through one channel (Dy = 1)
with ESS-adaptive resampling (width 8), and (Dx, Dy) = (5, 5) with Di = 2
controls: values at 2e-4, every gradient leaf at rtol 5e-3 / atol
5e-4; the gate against `smc.reference_path` over a grid of shapes, widths,
depths and K; the plans of every admitted shape within a CTA's shared
memory.
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
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import trunk
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT
from tests._torch_port import assert_close, key_noise, models, observations, to_torch

torch.set_num_threads(1)

B, K, T = 8, 128, 4
_RTOL, _ATOL = 5e-3, 5e-4
_FIELDS = ("log_z", "increments", "filtered_means", "x_last", "logw_last", "xs", "logws")

# label -> (datatype, Dx, Dy, Di, hidden, smc changes)
SHAPES = {
    "lorenz96 d20 width 48": ("lorenz96", 20, 20, 0, (48, 48), {}),
    "fhn dy1 ess width 8": ("fhn", 2, 1, 0, (8, 8), {"ess_threshold": 0.7}),
    "d5 controls": ("lorenz96", 5, 5, 2, (16, 16), {"ess_threshold": 0.7}),
}


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_step, pallas_resample, pallas_trunk):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "BF16_RESIDUALS", False)


def _configs(label):
    datatype, dx, dy, di, hidden, smc_kw = SHAPES[label]
    net = jconfig.NetConfig(hidden=hidden)
    data = dict(datatype=datatype, dx=dx, dy=dy, t_steps=T)
    if di:
        data.update(di=di, control_scale=0.5)
    jcfg = jconfig.Config(
        name="trunk_reach_test", data=jconfig.DataConfig(**data),
        smc=jconfig.SMCConfig(n_particles=K, n_smoothing_particles=4, **smc_kw),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5),
                qb=net)
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def _loss(fwd, mean):
    """log Ẑ with the last weights and particles, so that K10 sees more than
    α's cotangents."""
    return -mean(fwd.log_z) + 1e-3 * mean(fwd.logw_last) + 1e-2 * mean(fwd.x_last)


@pytest.mark.parametrize("label", sorted(SHAPES))
def test_trunk_path_at_new_shapes_matches_reference(_interpret, label):
    """The port's trunk path against the reference's trunk path in interpret
    mode on its draws, at shapes outside the kernels' library (each a trunk
    shape library of its own on the card): the filter with its cache, then
    the loss and every gradient leaf; K9 and K10 once a step."""
    jcfg, tcfg = _configs(label)
    jssm, params, tssm = models(jcfg, tcfg)
    dx, dy, di = jcfg.data.dx, jcfg.data.dy, jcfg.data.di
    hidden = jcfg.net("q1").hidden
    assert tsmc.reference_path(tssm, tcfg.smc) == "trunk" and trunk.usable(tssm, tcfg.smc)
    assert tsmc.filter_route(tssm, tcfg.smc, T, cuda=True) == "trunk"
    assert trunk.lib_key(dx, dy, hidden[0], len(hidden) - 1, True) is not None
    ys = observations(B, T, dy=dy, seed=3)
    key = jax.random.key(11)
    u = None
    if di:
        u = (0.5 * np.random.default_rng(7).standard_normal((B, T, di))).astype(np.float32)

    def reference(p):
        return jsmc._forward_filter_trunk(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                          encoder_inputs=None,
                                          controls=None if u is None else jnp.asarray(u))

    def loss_and_filter(p):
        fwd = reference(p)
        return _loss(fwd, jnp.mean), fwd

    (want_loss, want), want_grads = jax.value_and_grad(loss_and_filter, has_aux=True)(params)
    noise = to_torch(key_noise(key, B, T, dx, K, jcfg.smc.resampling))
    calls = (trunk.trunk_forward_reference.calls, trunk.trunk_backward_reference.calls)
    got = tsmc._forward_filter_trunk(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=True,
                                     streams=noise,
                                     controls=None if u is None else torch.from_numpy(u))
    for f in _FIELDS:
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    loss = _loss(got, torch.mean)
    loss.backward()
    assert (trunk.trunk_forward_reference.calls - calls[0],
            trunk.trunk_backward_reference.calls - calls[1]) == (T - 1, T - 1)
    assert_close(loss.detach(), want_loss, 2e-4)
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_grads)
    flat_got = jax.tree_util.tree_leaves(bridge.grads_to_numpy(tssm))
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


# (Dx, Dy, Di) over the class and one beyond its 55 state rows (40 + 16 + 1 = 57)
_GRID_DIMS = ((1, 1, 0), (2, 1, 0), (2, 2, 0), (3, 3, 0), (5, 5, 2), (10, 10, 0), (20, 20, 0),
              (40, 40, 0), (40, 40, 2), (48, 48, 0), (50, 55, 5), (55, 55, 0), (40, 40, 16))
_GRID_WIDTHS = (8, 48, 64, 72)
_GRID_K = (128, 8192, 32768, 65536)
HOLES = {"a width above 64": lambda h, depth: h > trunk.MAX_WIDTH}


def _grid_model(dx, dy, di, h, depth):
    cfg = tconfig.PRESETS["lorenz96_fivo_k8192_sharded"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, di=di))
    net = tconfig.NetConfig(hidden=(h,) * depth)
    return SSM(cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net)), cfg.smc


@pytest.mark.parametrize("dims", _GRID_DIMS)
def test_trunk_gate_equals_the_reference_path_but_the_holes(dims):
    """Over widths 8, 48, 64, 72, depths 1-3 and K in {128, 8192, 32768,
    65536}, with ESS-adaptive resampling (the reference's trunk path at
    every small shape): trunk.usable is reference_path == "trunk", but the
    holes (a width above 64), where filter_route raises on CUDA tensors; and
    every admitted shape has K9's and K10's plans within a CTA's shared
    memory, the weights in shared memory where they fit."""
    dx, dy, di = dims
    for h in _GRID_WIDTHS:
        for depth in (1, 2, 3):
            ssm, smc0 = _grid_model(dx, dy, di, h, depth)
            for k in _GRID_K:
                sc = dataclasses.replace(smc0, n_particles=k, ess_threshold=0.5)
                ref = tsmc.reference_path(ssm, sc) == "trunk"
                hole = ref and any(f(h, depth) for f in HOLES.values())
                assert trunk.usable(ssm, sc) == (ref and not hole), (dims, h, depth, k)
                if hole:
                    assert tsmc.filter_route(ssm, sc, 5, cuda=True) == "raise"
                elif ref:
                    assert tsmc.filter_route(ssm, sc, 5, cuda=True) == "trunk"
            if trunk.usable(ssm, dataclasses.replace(smc0, ess_threshold=0.5)):
                n_mid = depth - 1
                pair, prefetch = trunk.k9_plan(dx, dy, h, n_mid)
                w9 = trunk.k9_weights(dx, dy, h, n_mid)
                assert trunk.k9_smem_bytes(dx, dy, h, n_mid, pair, prefetch,
                                           w9 == "stream") <= SMEM_LIMIT
                if w9 == "stream":
                    assert all(trunk.k9_smem_bytes(dx, dy, h, n_mid, *pl) > SMEM_LIMIT
                               for pl in trunk.K9_PLANS)
                design = trunk.k10_design(dx, dy, h, n_mid)
                w10 = trunk.k10_weights(dx, dy, h, n_mid)
                assert trunk.k10_smem_bytes(dx, dy, h, n_mid, design, w10 == "stream") <= SMEM_LIMIT
                assert (w10 == "stream") == (
                    trunk.k10_smem_bytes(dx, dy, h, n_mid, design) > SMEM_LIMIT)


def test_the_deep_hole_raises_up_front():
    """A net deeper than K10's tiles hold even with the weights in device
    memory (nine hidden layers of 64 at (55, 55)) is a hole: the reference
    runs its trunk kernel, trunk.usable refuses, filter_route raises; eight
    layers are in the class, both kernels' weights in device memory."""
    for depth, admitted in ((8, True), (9, False)):
        ssm, sc = _grid_model(55, 55, 0, 64, depth)
        assert tsmc.reference_path(ssm, sc) == "trunk"
        assert trunk.usable(ssm, sc) is admitted
        assert tsmc.filter_route(ssm, sc, 5, cuda=True) == ("trunk" if admitted else "raise")
    assert trunk.k9_weights(55, 55, 64, 7) == "stream" == trunk.k10_weights(55, 55, 64, 7)


@pytest.mark.parametrize("dx, dy, h, n_mid, want", [
    (40, 40, 64, 1, ("smem", "smem", "tf32x3", None)),
    (2, 2, 16, 1, ("smem", "smem", "simt", None)),
    (20, 20, 64, 1, ("smem", "smem", "simt", ("trunk", 20, 20, 64, 0, 0))),
    (55, 55, 64, 1, ("smem", "stream", "simt", ("trunk", 55, 55, 64, 0, 1))),
    (48, 48, 64, 1, ("smem", "stream", "simt", ("trunk", 48, 48, 64, 0, 1))),
    (40, 40, 64, 2, ("stream", "stream", "simt", ("trunk", 40, 40, 64, 1, 1))),
    (40, 40, 48, 1, ("smem", "smem", "simt", ("trunk", 40, 40, 48, 0, 0))),
])
def test_plans_and_libraries(dx, dy, h, n_mid, want):
    """Where each kernel keeps its weights, K10's design and the library a
    launch takes: the presets' shapes the kernels' own (None, the tensor-core
    K10 at Lorenz-96's width); K9's weights in device memory at (40, 40)
    with three layers of 64, K10's from (48, 48) with two; the tensor-core
    K10 at the library's widths alone."""
    got = (trunk.k9_weights(dx, dy, h, n_mid), trunk.k10_weights(dx, dy, h, n_mid),
           trunk.k10_design(dx, dy, h, n_mid), trunk.lib_key(dx, dy, h, n_mid, True))
    assert got == want
    assert trunk.smem_bytes(55, 55, 64, 1) == 226848  # K9's tile layout, resident, at (55, 55)
