"""The Lorenz-96 serving slice of the torch port against the JAX reference.

At small sizes on the CPU: the Lorenz-96 stepper and data, the params
snapshot loader, the plain versions of the large-K resample kernels (K7
indices, K8 gather) against the reference's Pallas kernels in interpret
mode, the trunk filter path against the reference's
`smc._forward_filter_trunk` in interpret mode on the reference's key-derived
noise, and the serving entry points on a cut Lorenz-96 config. Tolerances:
1e-5 on the stepper; 2e-4 on the filter outputs and the entry points' ELBO,
means and R² (those of the reference's own trunk-vs-plain tests,
tests/test_pallas_trunk.py), 2e-3 on ESS; exact equality for the snapshot
and the gather.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import benchmark as jbenchmark
from psvo_tpu import config as jconfig
from psvo_tpu import infer as jinfer
from psvo_tpu import smc as jsmc
from psvo_tpu import train as jtrain
from psvo_tpu.models import dynamics as jdyn
from psvo_tpu.models.ssm import init_ssm as j_init_ssm
from psvo_tpu.ops import pallas_resample, pallas_step, pallas_trunk
from psvo_tpu.ops import resampling as jresampling
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import data as tdata
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.models import dynamics as tdyn
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.ops import fused_step, resample_gather, trunk
from tests._torch_port import assert_close, key_noise, models, observations, to_torch

torch.set_num_threads(1)

L96 = "lorenz96_fivo_k8192_sharded"
SNAPSHOT = "checkpoints/l96_pretrained.npz"


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "_INTERPRET", True)
    monkeypatch.setattr(pallas_trunk, "BF16_RESIDUALS", False)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_lorenz96_stepper_matches_reference(integrator):
    x = np.random.default_rng(3).standard_normal((4, 40, 6)).astype(np.float32) * 3.0
    want_m = jdyn.Lorenz96(integrator=integrator)
    got_m = tdyn.Lorenz96(integrator=integrator)
    assert_close(got_m.drift(torch.from_numpy(x), axis=-2), want_m.drift(x, axis=-2), 1e-5)
    want, got = x, torch.from_numpy(x)
    for _ in range(3):
        want, got = want_m.step(want, axis=-2), got_m.step(got, axis=-2)
        assert_close(got, want, 1e-5)
    xt = np.swapaxes(x, 1, 2).copy()
    assert_close(got_m.step(torch.from_numpy(xt)), want_m.step(xt), 1e-5)
    cfg = tconfig.DataConfig(datatype="lorenz96", dx=40, dy=40, dyn_overrides=(("forcing", 6.0),))
    assert tdyn.make_stepper(cfg) == tdyn.Lorenz96(forcing=6.0)


def test_lorenz96_dataset_shape_format_and_burn_in(tmp_path):
    """After the 500-step burn-in the chaotic states cannot be compared value
    by value: shapes, finiteness, the attractor's scale and the shared npz
    format are checked instead."""
    cfg = tconfig.DataConfig(datatype="lorenz96", dx=40, dy=40, t_steps=12, n_train=3,
                             n_test=2, obs_scale=0.5)
    ds = tdata.generate_dataset(cfg, seed=0)
    assert tuple(ds.obs_train.shape) == (3, 12, 40) and tuple(ds.hidden_test.shape) == (2, 12, 40)
    assert bool(torch.isfinite(ds.hidden_train).all())
    assert 1.0 < float(ds.hidden_train.std()) < 10.0  # on the attractor, not near x0
    torch.testing.assert_close(ds.emission_matrix, torch.eye(40))
    tdata.save_dataset(ds, tmp_path / "l96.npz")
    from psvo_tpu import data as jdata

    back = jdata.load_dataset(tmp_path / "l96.npz")
    assert_close(back.obs_test, ds.obs_test, 0.0)
    assert back.controls_train is None


def test_load_params_npz_equals_the_reference_loader(tmp_path):
    jcfg = jconfig.preset(L96)
    tcfg = tconfig.from_dict(jcfg.to_dict())
    _, template = j_init_ssm(jcfg, jax.random.key(0))
    want = jbenchmark.load_params_npz(template, SNAPSHOT)
    tssm = bridge.load_params_npz(SSM(tcfg), SNAPSHOT)
    got = bridge.params_to_numpy(tssm)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g) == 44
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))

    with np.load(SNAPSHOT) as z:
        arrays = dict(z)
    bad = dict(arrays)
    del bad["['g']['raw_scale']"]
    np.savez(tmp_path / "missing.npz", **bad)
    with pytest.raises(ValueError, match="no leaf"):
        bridge.load_params_npz(SSM(tcfg), tmp_path / "missing.npz")
    bad = dict(arrays, **{"['f']['mean'][1]": np.zeros(39, np.float32)})
    np.savez(tmp_path / "shape.npz", **bad)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_params_npz(SSM(tcfg), tmp_path / "shape.npz")


# The count form on an fp64 CDF and the reference's float32 triangular cumsum
# with its two-level count can differ at a CDF boundary tie: at most this many
# of the 32768 indices, each by one.
MAX_TIES = 8


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_large_k_indices_plain_version_matches_reference(_interpret, method):
    rng = np.random.default_rng(1)
    batch, k = 8, 4096
    logw = rng.standard_normal((batch, k)).astype(np.float32) * 3
    logw[3] = -200.0
    logw[3, 3131] = 0.0  # all mass on one particle
    u_raw = rng.uniform(size=(batch,) if method == "systematic" else (batch, k)).astype(np.float32)
    u = np.asarray(jresampling.quantile_positions_from_raw(jnp.asarray(u_raw), k, method))
    want = np.asarray(pallas_resample._indices_large(jnp.asarray(u), jnp.asarray(logw)))
    calls = resample_gather.ancestor_indices_large_reference.calls
    got = resample_gather.ancestor_indices_large(torch.from_numpy(logw), torch.from_numpy(u))
    assert resample_gather.ancestor_indices_large_reference.calls == calls + 1
    diff = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= MAX_TIES, (diff.max(), (diff > 0).sum())
    assert np.all(got.numpy()[3] == 3131)
    assert np.all(np.diff(got.numpy(), axis=-1) >= 0)


def test_large_k_gather_plain_version_matches_reference(_interpret):
    """The windowed regime (near-identity indices) and the compact one (few
    distinct ancestors far apart, the degenerate-weights regime): exact."""
    rng = np.random.default_rng(9)
    batch, d, k = 8, 5, 4096
    x = rng.standard_normal((batch, d, k)).astype(np.float32)
    near = np.clip(np.sort(np.arange(k) + rng.integers(-60, 60, size=(batch, k)), axis=-1),
                   0, k - 1)
    few = np.sort(rng.choice(np.array([5, 700, 2222, 4000]), size=(batch, k)), axis=-1)
    for windowed, idx in ((True, near), (False, few)):
        idx = idx.astype(np.int32)
        _, ok = pallas_resample._gather_meta(jnp.asarray(idx), k, pallas_resample.W_TILES)
        assert bool(ok) == windowed  # else the compact branch: 4 distinct ancestors
        want = np.asarray(pallas_resample._win_gather(jnp.asarray(idx), jnp.asarray(x), k))
        got = resample_gather.gather_particles(torch.from_numpy(x), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def _trunk_configs(k=128):
    """The reference's trunk-test config (tests/test_pallas_trunk.py::_cfg):
    Lorenz-96 data at Dx = Dy = 10, B = 8, T = 5, hidden (16, 16)."""
    net = jconfig.NetConfig(hidden=(16, 16))
    jcfg = jconfig.Config(
        name="trunk_port_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=10, dy=10, t_steps=5),
        smc=jconfig.SMCConfig(objective="fivo", n_particles=k, n_smoothing_particles=4),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5),
                qb=net)
    return jcfg, tconfig.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("k, large_index_branch", [(128, False), (256, True)])
def test_trunk_path_plain_versions_match_reference(_interpret, monkeypatch, k,
                                                   large_index_branch):
    """The port's `_forward_filter_trunk` on CPU (K7/K8/K9's plain versions)
    against the reference's trunk path in interpret mode, cache on. At K=256
    with the fused resample capped at 128 the reference takes
    `_indices_large`."""
    if large_index_branch:
        monkeypatch.setattr(pallas_resample, "MAX_K", 128)
    jcfg, tcfg = _trunk_configs(k)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_trunk.usable(jssm, jcfg.smc, 8) and not pallas_step.usable(jssm, jcfg.smc, 8)
    ys = observations(8, 5, dy=10, seed=3)
    key = jax.random.key(11)
    want = jsmc._forward_filter_trunk(jssm, params, key, jnp.asarray(ys), jcfg.smc, cache=True,
                                      encoder_inputs=None)
    calls = trunk.trunk_forward_reference.calls
    with torch.no_grad():
        got = tsmc._forward_filter_trunk(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=True,
                                         streams=to_torch(key_noise(key, 8, 5, 10, k)))
    assert trunk.trunk_forward_reference.calls == calls + 4
    for name in ("log_z", "increments", "filtered_means", "x_last", "logw_last", "xs", "logws"):
        assert_close(getattr(got, name), getattr(want, name), 2e-4)
    assert_close(got.ess, want.ess, 2e-3)


def _l96_small():
    """The Lorenz-96 preset cut to B = 8, K = 128, T = 6, hidden (16, 16);
    Dx = Dy = 40 and mse_k_steps = 10 as published."""
    net = jconfig.NetConfig(hidden=(16, 16))
    jcfg = jconfig.preset(L96)
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, t_steps=6),
        smc=dataclasses.replace(jcfg.smc, n_particles=128),
    ).with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=dataclasses.replace(net, sigma_init=0.5))
    return jcfg, tconfig.from_dict(jcfg.to_dict())


def test_l96_serving_entry_points_match_reference(_interpret, monkeypatch):
    """filter_posterior and make_eval_step on the cut preset: the reference
    serves it through its trunk path (interpret mode); the port replays the
    reference's draws through its own trunk path (the noise hook alone would
    take the plain step body, whose histogram-form indices can flip one
    ancestor at a tie)."""
    from psvo_tpu_torch import objectives as tobjectives

    def trunk_filter(ssm, generator, ys, cfg, *, cache=False, encoder_inputs=None, noise=None):
        return tsmc._forward_filter_trunk(ssm, generator, ys, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tinfer, "forward_filter", trunk_filter)
    monkeypatch.setattr(tobjectives, "forward_filter", trunk_filter)
    calls = trunk.trunk_forward_reference.calls
    jcfg, tcfg = _l96_small()
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_trunk.usable(jssm, jcfg.smc, 8)
    ys = observations(8, 6, dy=40, seed=4) * 3.0
    key = jax.random.key(21)
    want = jinfer.filter_posterior(jssm, params, ys, jcfg, key, return_particles=True)
    got = tinfer.filter_posterior(tssm, torch.from_numpy(ys), tcfg, return_particles=True,
                                  noise=to_torch(key_noise(key, 8, 6, 40, 128)))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a, b, 2e-4)

    want_m = jtrain.make_eval_step(jssm, jcfg)(params, key, ys)
    noise = to_torch(key_noise(jax.random.split(key)[0], 8, 6, 40, 128))
    got_m = ttrain.make_eval_step(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert got_m["r2_k"].shape == (5,)
    for name in ("elbo", "mse_k", "r2_k"):
        assert_close(got_m[name], want_m[name], 2e-4)
    assert trunk.trunk_forward_reference.calls == calls + 10


def test_dispatch_and_in_kernel_rng_replay_on_cpu():
    """The Lorenz-96 preset is in the trunk class and not the whole-scan
    one; the FHN and Lorenz-63 presets stay in K1's. On CPU tensors the
    trunk class runs the plain versions, cfg.kernel_rng replaying K2's plain
    streams, equal to the same path fed those streams."""
    l96 = tconfig.PRESETS[L96]
    assert trunk.usable(SSM(l96), l96.smc) and not fused_step.usable(SSM(l96), l96.smc)
    for name in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024"):
        cfg = tconfig.PRESETS[name]
        assert fused_step.usable(SSM(cfg), cfg.smc), name
    multinomial = dataclasses.replace(l96.smc, resampling="multinomial")
    assert trunk.usable(SSM(l96), multinomial)  # K7 searches any sorted positions
    deep = l96.with_nets(**{n: tconfig.NetConfig(hidden=(64, 64, 64, 64)) for n in ("q1", "f", "g")})
    assert trunk.usable(SSM(deep), deep.smc)  # the weights stay in device memory
    assert trunk.k9_weights(40, 40, 64, 3) == "stream" == trunk.k10_weights(40, 40, 64, 3)
    wide = l96.with_nets(**{n: tconfig.NetConfig(hidden=(72, 72)) for n in ("q1", "f", "g")})
    assert not trunk.usable(SSM(wide), wide.smc)  # a width above 64: a hole
    assert resample_gather.k_ok(resample_gather.MAX_K)
    assert not resample_gather.k_ok(resample_gather.MAX_K + 256)

    _, tcfg = _l96_small()
    tcfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, n_particles=64))
    tssm = SSM(tcfg).init(torch.Generator().manual_seed(0))
    ys = torch.from_numpy(observations(2, 4, dy=40, seed=6))
    calls = (trunk.trunk_forward_reference.calls, fused_step.scan_forward_reference.calls)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, torch.Generator().manual_seed(2), ys, tcfg.smc, cache=True)
    assert trunk.trunk_forward_reference.calls == calls[0] + 3
    assert fused_step.scan_forward_reference.calls == calls[1]
    gen = torch.Generator().manual_seed(2)
    eps0 = torch.randn((2, 40, 64), generator=gen)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen))
    u = tsmc.resampling.bulk_positions(gen, 3, 2, 64, "systematic")
    eps = fused_step.stream_noise_reference(seed, 3, 2, 40, 64)[0]
    with torch.no_grad():
        want = tsmc._forward_filter_trunk(tssm, None, ys, tcfg.smc, cache=True,
                                          streams=(eps0, eps, u))
    for name in ("log_z", "xs", "logws", "ess", "filtered_means"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0)
