"""The smoothing sweeps' kernels (K5/K6, K12/K13) over the reference's whole
classes, against `psvo_tpu`.

Small sizes only (B = 8, K = 128, T <= 6). Values are held at 2e-4 and
gradient leaves at rtol 5e-3 / atol 5e-4: the reference's own kernel-vs-scan
tolerances (tests/test_pallas_ffbsi.py, tests/test_pallas_svo.py).

- The plain versions of the wide kernels' shapes: K5/K6 through `FFBSiSweep`
  on CPU tensors at Dx = 1, 5 and 40 (the wide kernels) and at M = 264 past
  the staged K6's 256 paths, against `pallas_ffbsi.run_ffbsi_scan` and its
  `jax.vjp` in interpret mode; K12/K13 through `svo.run_svo_sweep` at
  (Dx, Dy, width) = (3, 1, 8), (4, 3, 24) and (5, 2, 48) with Di = 2 against
  `pallas_svo.run_svo_sweep` in interpret mode (its M >= 32 speed gate
  lowered to 1, as the reference's own tests lower it), on the same numpy
  inputs.
- The objectives the widened classes newly serve on the card: PSVO on a
  Lorenz-96 (Dx = Dy = 40) and SVO at (Dx, Dy) = (4, 3), loss and every
  gradient leaf against `jax.value_and_grad` of the reference on the same
  noise, through the port's dispatch (the kernels' plain versions on CPU
  tensors).
- The class grids: over every (Dx, Dy, Di) of the reference's SVO class x
  widths 8..64 x depths 1..3 x M in {32, 128, 4096}, and over Dx 1..64 x K
  in {128, 2048} x M in {8, 256, 4096} for FFBSi, the port's class takes
  every configuration the reference sends to its kernel (`_svo_route` /
  `_ffbsi_route` say "kernel" on CUDA tensors), and every plan of the
  kernels (`k5_smem_bytes`, `k6_smem_bytes`, `k12_plan`, `k13_tile_rows`)
  fits a CTA's 232,448 bytes. The grids use stand-ins for the model: the
  gates read its shapes and modes only.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_ffbsi, pallas_resample, pallas_step, pallas_svo
from psvo_tpu_torch import bridge, objectives, smc
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, svo
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, psvo_noise, svo_noise,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K = 8, 128


@pytest.fixture
def _interpret(monkeypatch):
    for mod in (pallas_ffbsi, pallas_resample, pallas_step, pallas_svo):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    monkeypatch.setattr(pallas_svo, "MIN_M", 1)


# ---------------------------------------------------------------------------
# K5/K6's plain versions at the wide kernels' shapes
# ---------------------------------------------------------------------------


def _ffbsi_inputs(seed, dx, m, t1=3, scale=8.0):
    """One sweep's operands (tests/test_torch_psvo.py's, at any Dx and M):
    support particles, the diagonal support terms of a transition whose
    means lie near them, normalized log-weights, emission terms, Gumbels and
    anchors near the last support step."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t1, B, dx, K)) * scale
    mean = xs + rng.standard_normal(xs.shape)
    sd = rng.uniform(0.5, 2.0, xs.shape)
    r = 1.0 / sd**2
    c = -0.5 * np.sum(mean * mean * r, axis=2) - np.sum(np.log(sd), axis=2) \
        - dx * 0.5 * np.log(2 * np.pi)
    lw = rng.standard_normal((t1, B, K)) * 2.0
    lwn = lw - np.log(np.sum(np.exp(lw), axis=-1, keepdims=True))
    lg = rng.standard_normal((t1, B, K))
    gum = rng.gumbel(size=(t1, B, m, K))
    pick = rng.integers(0, K, size=m)
    x_anchor = xs[-1][:, :, pick].transpose(0, 2, 1) + 0.5 * rng.standard_normal((B, m, dx))
    return [np.asarray(a, np.float32) for a in (x_anchor, xs, r, mean * r, c, lwn, lg, gum)]


# (Dx, M, the support's scale): Lorenz-96's states are O(1)-O(10) at Dx = 40
_FFBSI_SHAPES = [(1, 8, 8.0), (5, 8, 8.0), (40, 8, 2.0), (3, 264, 8.0)]


@pytest.mark.parametrize("dx,m,scale", _FFBSI_SHAPES,
                         ids=[f"Dx{d}-M{m}" for d, m, _ in _FFBSI_SHAPES])
def test_ffbsi_plain_versions_match_reference_kernel(_interpret, dx, m, scale):
    """K5's and K6's plain versions, through FFBSiSweep on CPU tensors,
    against the whole-sweep Pallas kernels in interpret mode at shapes only
    the wide kernels take (Dx outside {2, 3}; M past the staged K6's 256):
    the four outputs and the VJP of random cotangents on all four to the
    anchors, the support and its terms, the weights and the emission terms."""
    assert ffbsi.usable(dx, m, k=K)
    assert ffbsi.staged_kernel(dx, m, backward=True) == "wide"
    x_anchor, xs, r, mr, c, lwn, lg, gum = _ffbsi_inputs(dx + m, dx, m, scale=scale)
    rng = np.random.default_rng(1)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, m, dx), (B, m), (B, m), (xs.shape[0], B, m, dx))]

    def ref(xa, xs_, r_, mr_, c_, lwn_, lg_):
        return pallas_ffbsi.run_ffbsi_scan(None, {"r": r_, "mr": mr_, "c": c_}, xs_, lwn_, lg_,
                                           gum, xa, dx)

    want, vjp = jax.vjp(ref, x_anchor, xs, r, mr, c, lwn, lg)
    want_grads = vjp(tuple(cots))
    tensors = [torch.from_numpy(a).requires_grad_() for a in (x_anchor, xs, r, mr, c, lwn, lg)]
    calls = (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls)
    got = ffbsi.FFBSiSweep.apply(*tensors, torch.from_numpy(gum))
    for a, w in zip(got, want):
        assert_close(a.detach(), w, _TOL)
    got_grads = torch.autograd.grad(got, tensors, [torch.from_numpy(v) for v in cots])
    assert (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    for a, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=_RTOL, atol=_ATOL)


# ---------------------------------------------------------------------------
# K12/K13's plain versions across the SVO class
# ---------------------------------------------------------------------------


def _svo_configs(dx, dy, di, hidden, t=5, m=8, k=K, **smc_kw):
    """(reference Config, port Config): Lorenz-63's SVO preset at (Dx, Dy,
    Di), qb/f/g (and the proposals) at `hidden`, K, T and M small."""
    net = jconfig.NetConfig(hidden=hidden)
    base = jconfig.PRESETS["lorenz63_svo_k256"]
    jcfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, dx=dx, dy=dy, di=di, t_steps=t),
        smc=dataclasses.replace(base.smc, n_particles=k, n_smoothing_particles=m,
                                kernel_rng=False, **smc_kw))
    jcfg = jcfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                          g=dataclasses.replace(net, sigma_init=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


_SVO_SHAPES = [(3, 1, 0, 8), (4, 3, 0, 24), (5, 2, 2, 48)]


@pytest.mark.parametrize("dx,dy,di,h", _SVO_SHAPES,
                         ids=[f"{dx}x{dy}-Di{di}-H{h}" for dx, dy, di, h in _SVO_SHAPES])
def test_svo_plain_versions_match_reference_kernel(_interpret, dx, dy, di, h):
    """K12's and K13's plain versions, through SVOSweep on CPU tensors,
    against the whole-sweep Pallas kernel in interpret mode at shapes
    outside the kernels' library (built into shape libraries on the card):
    the four outputs and the VJP of random cotangents on all four to the
    anchors and to every parameter (qb, f and g weights, biases and scales;
    f's control rows with Di = 2)."""
    m, t = 8, 5
    jcfg, tcfg = _svo_configs(dx, dy, di, (h, h), t=t, m=m)
    jssm, params, tssm = models(jcfg, tcfg)
    assert svo.usable(tssm, m) and svo.lib_key(dx, dy, h) == ("svo", dx, dy, h)
    rng = np.random.default_rng(dx * 10 + dy)
    ys_tm = (rng.standard_normal((t, B, dy)) * 4.0).astype(np.float32)
    ctrl = rng.standard_normal((t, B, di)).astype(np.float32) if di else None
    eps = rng.standard_normal((t - 1, B, m, dx)).astype(np.float32)
    x_anchor = (rng.standard_normal((B, m, dx)) * 4.0).astype(np.float32)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, m, dx), (B, m), (B, m), (t - 1, B, m, dx))]

    def ref(p, xa):
        return pallas_svo.run_svo_sweep(jssm, p, ys_tm, ctrl, eps, xa, m)

    want, vjp = jax.vjp(ref, params, x_anchor)
    want_params, want_anchor = vjp(tuple(cots))
    xa = torch.from_numpy(x_anchor).requires_grad_()
    for p in tssm.parameters():
        p.grad = None
    calls = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    got = svo.run_svo_sweep(tssm, torch.from_numpy(ys_tm), torch.from_numpy(eps), xa,
                            None if ctrl is None else torch.from_numpy(ctrl))
    for a, w in zip(got, want):
        assert_close(a.detach(), w, _TOL)
    torch.autograd.backward(got, [torch.from_numpy(v) for v in cots])
    assert (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls) == (
        calls[0] + 1, calls[1] + 1)
    np.testing.assert_allclose(xa.grad.numpy(), np.asarray(want_anchor), rtol=_RTOL, atol=_ATOL)
    assert_grads_close(bridge.grads_to_numpy(tssm), want_params, _RTOL, _ATOL)


# ---------------------------------------------------------------------------
# the objectives the widened classes newly serve on the card
# ---------------------------------------------------------------------------


def _compare(jcfg, tcfg, noise_fn, key_seed, extra):
    jssm, params, tssm = models(jcfg, tcfg)
    t, dx, dy = jcfg.data.t_steps, jcfg.data.dx, jcfg.data.dy
    k, m = jcfg.smc.n_particles, jcfg.smc.n_smoothing_particles
    ys = observations(B, t, dy=dy, seed=key_seed)
    key = jax.random.key(key_seed)
    j_obj = j_make_objective(jssm, jcfg)
    (want_loss, want_out), want = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o.loss, o))(j_obj(p, key, ys)), has_aux=True))(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=noise_fn(key, B, t, dx, k, m))
    got.loss.backward()
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want_out.elbo, _TOL)
    for name in extra:
        assert_close(got.metrics[name].detach(), want_out.metrics[name], _TOL)
    assert_close(got.smoothed.detach(), want_out.smoothed, _TOL)
    assert_grads_close(bridge.grads_to_numpy(tssm), want, _RTOL, _ATOL)


def test_psvo_lorenz96_matches_reference():
    """PSVO on the Lorenz-96 preset (Dx = Dy = 40) at K = 128, M = 8, T = 5,
    hidden (16, 16): the reference's plain code (use_pallas off) against the
    port's dispatch, the FFBSi sweep through K5/K6's class (their plain
    versions; on the card the wide kernels, where the sweep raised before)."""
    net = jconfig.NetConfig(hidden=(16, 16))
    base = jconfig.PRESETS["lorenz96_fivo_k8192_sharded"]
    jcfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, t_steps=5),
        smc=dataclasses.replace(base.smc, objective="psvo", n_particles=K, n_smoothing_particles=8,
                                kernel_rng=False),
        mesh=dataclasses.replace(base.mesh, data=1, particle=1), use_pallas=False)
    jcfg = jcfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                          g=dataclasses.replace(net, sigma_init=0.5))
    tcfg = tconfig.from_dict(jcfg.to_dict())
    tssm = SSM(tcfg)
    assert objectives._ffbsi_route(tssm, K, 8, True) == "kernel"
    assert smc.reference_ffbsi_path(tssm, K, 8) == "kernel"
    calls = (ffbsi.ffbsi_forward_reference.calls, ffbsi.ffbsi_backward_reference.calls)
    _compare(jcfg, tcfg, psvo_noise, 41, ("elbo_psvo_direct", "log_joint_smoothed"))
    assert (ffbsi.ffbsi_forward_reference.calls - calls[0],
            ffbsi.ffbsi_backward_reference.calls - calls[1]) == (1, 1)


def test_svo_dx4_dy3_matches_reference():
    """SVO at (Dx, Dy) = (4, 3), K = 128, M = 8, T = 5, hidden (16, 16): the
    reference's plain code against the port's dispatch, the q_b sweep
    through K12/K13's class (their plain versions; on the card a shape
    library of the split designs, where the sweep raised before)."""
    jcfg, tcfg = _svo_configs(4, 3, 0, (16, 16), t=5, m=8)
    jcfg = dataclasses.replace(jcfg, use_pallas=False)
    tssm = SSM(tcfg)
    assert objectives._svo_route(tssm, 8, True) == "kernel"
    calls = svo.svo_sweep_forward_reference.calls
    _compare(jcfg, tcfg, svo_noise, 42, ("elbo_svo",))
    assert svo.svo_sweep_forward_reference.calls - calls == 1


# ---------------------------------------------------------------------------
# the class grids
# ---------------------------------------------------------------------------


def _stand_in(dx, dy, di, hidden, f_tril=False):
    """The model as the smoothing gates read it: shapes and modes only."""
    net = SimpleNamespace(hidden=hidden, activation="relu", cov_type="const")
    return SimpleNamespace(dx=dx, dy=dy, di=di, nets={n: net for n in ("qb", "f", "g")},
                           qb_rnn=False, transition_known=False, emission="linear_gaussian",
                           f_tril=f_tril, f_tril_head=False, g_tril=False)


_SVO_TRIPLES = [(dx, dy, di) for dx in range(1, 7) for dy in range(1, 8 - dx)
                for di in range(0, 8 - dx)]


@pytest.mark.parametrize("dx", range(1, 7))
def test_svo_class_grid(dx):
    """Every (Dx, Dy, Di) of the reference's SVO class with this Dx, every
    width 8..64, depths 1..3 and M in {32, 128, 4096}: where the reference
    sends the sweep to its kernel, the port's route is "kernel" on CUDA
    tensors, and K12's plan (B = 8, T - 1 = 99, 132 SMs) and K13's tile fit
    a CTA's shared memory; widths above 64 still raise (the hole every
    kernel family shares)."""
    seen = 0
    for _, dy, di in [t for t in _SVO_TRIPLES if t[0] == dx]:
        for h in range(8, 73, 8):
            for depth in (1, 2, 3):
                ssm = _stand_in(dx, dy, di, (h,) * depth)
                for m in (32, 128, 4096):
                    assert smc.reference_svo_path(ssm, m) == "kernel"
                    label = (dx, dy, di, h, depth, m)
                    if h > 64:
                        assert objectives._svo_route(ssm, m, True) == "raise", label
                        continue
                    seen += 1
                    assert svo.usable(ssm, m), label
                    assert objectives._svo_route(ssm, m, True) == "kernel", label
                    n_mid, n_w = depth - 1, svo._n_weights(dx, dy, h, depth - 1)
                    paths, rows, steps = svo.k12_plan(dx, dy, h, n_mid, B * m, 132, 99)
                    assert svo.k12_smem_bytes(dx, dy, h, n_mid, paths, rows, steps) <= SMEM_LIMIT
                    assert paths * svo.chain_group(h) <= 256 and rows % 4 == 0
                    rows13 = svo.k13_tile_rows(dx, dy, h, n_mid, n_w)
                    assert rows13 is not None and rows13 % 4 == 0 and rows13 * h <= 4096, label
                    assert svo.k13_smem_bytes(dx, dy, h, n_mid, n_w) <= SMEM_LIMIT, label
    assert seen == 3 * 8 * 3 * sum(1 for t in _SVO_TRIPLES if t[0] == dx)


@pytest.mark.parametrize("dx", range(1, 65))
def test_ffbsi_class_grid(dx):
    """Dx with K in {128, 2048} and M in {8, 256, 4096}: the reference sends
    every one to its FFBSi kernel, and the port's route is "kernel" on CUDA
    tensors; K5's shared memory (each count of paths a CTA) and K6's fit a
    CTA's; a full-covariance f stays out, as in the reference's gate."""
    for k in (128, 2048):
        for m in (8, 256, 4096):
            ssm = _stand_in(dx, dx, 0, (16,))
            assert smc.reference_ffbsi_path(ssm, k, m) == "kernel"
            assert ffbsi.usable(dx, m, k=k) and objectives._ffbsi_route(ssm, k, m, True) == "kernel"
            for p in ffbsi.PATHS_PER_CTA:
                assert ffbsi.k5_smem_bytes(dx, k, p) <= SMEM_LIMIT - 24576
            assert ffbsi.k6_smem_bytes(dx, m, k) <= SMEM_LIMIT
            assert not ffbsi.usable(dx, m, f_tril=True, k=k)


@pytest.mark.parametrize("t_len,batch,want", [(2, 3, 6), (99, 8, 264), (99, 32, 264)])
def test_ffbsi_wide_kernels_stop_at_the_reference_class_and_bound_their_scratch(
        t_len, batch, want):
    """The wide kernels' class stops at the reference's K <= 2048 while the
    staged kernels (Dx in {2, 3}) take any K; K6 wide's persistent grid has
    one CTA a (t, b) row up to two an SM, so its scratch [ctas, M, K + 2 +
    Dx] stops growing with T and B (132 SMs)."""
    assert ffbsi.usable(40, 16, ffbsi.MAX_K) and not ffbsi.usable(40, 16, ffbsi.MAX_K + 1)
    assert ffbsi.usable(3, 16, 8192) and not ffbsi.usable(3, 264, 8192)
    assert ffbsi.k6_wide_ctas(t_len, batch, 132) == want
