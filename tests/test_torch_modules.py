"""The torch port's modules against the JAX reference, one by one.

Same numpy-made inputs through both packages: distributions, MLP heads, the
FHN and Lorenz-63 steppers and simulators, the dataset file format, resampling indices
(ties included), and the plain versions of the CUDA kernels — the
Philox4x32-10 known answers, the noise streams, the count-form indices.
The kernels themselves are checked on a GPU by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import data as jdata
from psvo_tpu import distributions as jdist
from psvo_tpu import networks as jnet
from psvo_tpu.models import dynamics as jdyn
from psvo_tpu.ops import pallas_resample
from psvo_tpu.ops import resampling as jres
from psvo_tpu_torch import data as tdata
from psvo_tpu_torch import distributions as tdist
from psvo_tpu_torch import networks as tnet
from psvo_tpu_torch.config import DataConfig
from psvo_tpu_torch.models import dynamics as tdyn
from psvo_tpu_torch.ops import fused_step
from psvo_tpu_torch.ops import resampling as tres
from tests._torch_port import assert_close, models, small_configs

torch.set_num_threads(1)

T = torch.from_numpy


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def test_distributions_match_reference():
    r = _rng()
    x, mean = _f32(r.standard_normal((3, 2, 5))), _f32(r.standard_normal((3, 2, 5)))
    scale = _f32(r.uniform(0.1, 2.0, (3, 2, 5)))
    assert_close(tdist.mvn_diag_log_prob_cm(T(x), T(mean), T(scale)),
                 jdist.mvn_diag_log_prob_cm(x, mean, scale), 1e-5)
    xs, ms, ss = (np.swapaxes(a, -1, -2).copy() for a in (x, mean, scale))
    assert_close(tdist.mvn_diag_log_prob(T(xs), T(ms), T(ss)),
                 jdist.mvn_diag_log_prob(xs, ms, ss), 1e-5)
    # the finiteness floor
    huge = np.full_like(x, 1e20)
    assert_close(tdist.mvn_diag_log_prob_cm(T(huge), T(mean), T(scale)),
                 jdist.mvn_diag_log_prob_cm(huge, mean, scale), 1e-5)
    s2 = _f32(r.uniform(0.1, 2.0, (3, 2, 5)))
    for a, b in zip(tdist.mvn_product(T(mean), T(scale), T(x), T(s2)),
                    jdist.mvn_product(mean, scale, x, s2)):
        assert_close(a, b, 1e-5)
    logw = _f32(r.standard_normal((4, 64)) * 5)
    for a, b in zip(tdist.log_normalize(T(logw)), jdist.log_normalize(logw)):
        assert_close(a, b, 1e-5)
    assert_close(tdist.effective_sample_size(T(logw)), jdist.effective_sample_size(logw), 1e-4)


@pytest.mark.parametrize("hidden", [(16,), (16, 16), (8, 8, 8)])
def test_mlp_heads_match_reference(hidden):
    jcfg, tcfg = small_configs(hidden=hidden)
    _, params, tssm = models(jcfg, tcfg, seed=1)
    r = _rng(1)
    x_cm = _f32(r.standard_normal((3, 2, 7)))
    x_fl = _f32(r.standard_normal((3, 4, 2)))
    sigma_min = 1e-2
    for name in ("q1", "f", "g"):
        jp, th = params[name], tssm.heads[name]
        for a, b in zip(tnet.mlp_mean_scale_cm(th, T(x_cm), sigma_min=sigma_min),
                        jnet.mlp_mean_scale_cm(jp, x_cm, sigma_min=sigma_min)):
            assert_close(a.detach(), b, 1e-5)
        assert_close(tnet.mlp_mean_cm(th, T(x_cm)).detach(), jnet.mlp_mean_cm(jp, x_cm), 1e-5)
        for a, b in zip(tnet.mlp_mean_scale(th, T(x_fl), sigma_min=sigma_min),
                        jnet.mlp_mean_scale(jp, x_fl, sigma_min=sigma_min)):
            assert_close(a.detach(), b, 1e-5)
    raw = _f32(np.linspace(-30, 30, 13))
    assert_close(tnet.scale_from_raw(T(raw), 1e-2), jnet.scale_from_raw(raw, 1e-2), 1e-6)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_fhn_stepper_matches_reference(integrator):
    x = _f32(_rng(2).standard_normal((4, 2, 6)))
    want = jdyn.FitzHughNagumo(integrator=integrator)
    got = tdyn.FitzHughNagumo(integrator=integrator)
    assert_close(got.step(T(x), axis=-2), want.step(x, axis=-2), 1e-5)
    xt = np.swapaxes(x, 1, 2).copy()
    assert_close(got.step(T(xt)), want.step(xt), 1e-5)
    cfg = DataConfig(dyn_overrides=(("dt", 0.1),))
    assert tdyn.make_stepper(cfg) == tdyn.FitzHughNagumo(dt=0.1)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_lorenz63_stepper_matches_reference(integrator):
    x = _f32(_rng(3).standard_normal((4, 3, 6)) * 10.0 + np.array([0.0, 0.0, 25.0])[:, None])
    want = jdyn.Lorenz63(integrator=integrator)
    got = tdyn.Lorenz63(integrator=integrator)
    assert_close(got.step(T(x), axis=-2), want.step(x, axis=-2), 1e-5)
    xt = np.swapaxes(x, 1, 2).copy()
    assert_close(got.step(T(xt)), want.step(xt), 1e-5)
    cfg = DataConfig(datatype="lorenz63", dx=3, dy=3, dyn_overrides=(("rho", 20.0),))
    assert tdyn.make_stepper(cfg) == tdyn.Lorenz63(rho=20.0)
    lg = jdyn.make_stepper(jdata.DataConfig(datatype="lgssm"))
    got_lg = tdyn.make_stepper(DataConfig(datatype="lgssm"))
    assert isinstance(got_lg, tdyn.LinearDynamics)
    np.testing.assert_allclose(np.asarray(got_lg.matrix), np.asarray(lg.matrix), rtol=1e-6)
    x2 = xt[..., :2].copy()
    assert_close(got_lg.step(T(x2)), lg.step(x2), 1e-6)
    with pytest.raises(NotImplementedError):
        tdyn.make_stepper(DataConfig(datatype="no_such_dynamics"))


def test_fhn_simulator_matches_reference_on_its_noise():
    cfg_j = jdata.DataConfig(t_steps=12, n_train=3, n_test=2)
    cfg_t = DataConfig(t_steps=12, n_train=3, n_test=2)
    ds = jdata.generate_dataset(cfg_j, seed=4)
    # the reference's own draws (psvo_tpu/data.py::_simulate's key schedule)
    n = cfg_j.n_train + cfg_j.n_test
    k_x0, k_proc, k_obs, _, _, _ = jax.random.split(jax.random.key(4), 6)
    x0 = jax.random.normal(k_x0, (n, 2))
    draw = jax.vmap(lambda k: jax.random.normal(k, (n, 2)))
    proc, obs = draw(jax.random.split(k_proc, 12)), draw(jax.random.split(k_obs, 12))
    hidden, ys = tdata.simulate_from_noise(
        cfg_t, torch.eye(2), *(torch.tensor(np.asarray(a)) for a in (x0, proc, obs))
    )
    assert_close(hidden, np.concatenate([ds.hidden_train, ds.hidden_test]), 1e-4)
    assert_close(ys, np.concatenate([ds.obs_train, ds.obs_test]), 1e-4)
    port = tdata.generate_dataset(cfg_t, seed=4)
    assert port.obs_train.shape == (3, 12, 2) and port.hidden_test.shape == (2, 12, 2)
    assert bool(torch.isfinite(port.hidden_train).all())


def test_lorenz63_simulator_matches_reference_on_its_noise():
    """Burn-in and the x0 offset included: 500 noise-free RK4 steps from
    (0, 0, 25) + x0_scale·noise before the first recorded step. The chaos
    grows a one-ulp difference by about 1e5 over the burn-in, and XLA's fused
    loop rounds otherwise than op-by-op arithmetic, so the reference runs op
    by op here (jax.disable_jit): its own simulator and draws, rounded as
    the port rounds."""
    kw = dict(datatype="lorenz63", dx=3, dy=3, t_steps=12, n_train=3, n_test=2, obs_scale=0.5)
    cfg_j, cfg_t = jdata.DataConfig(**kw), DataConfig(**kw)
    n = cfg_j.n_train + cfg_j.n_test
    with jax.disable_jit():
        ds = jdata.generate_dataset(cfg_j, seed=6)
        k_x0, k_proc, k_obs, _, _, _ = jax.random.split(jax.random.key(6), 6)
        x0 = jax.random.normal(k_x0, (n, 3))
        proc, obs = (jnp.stack([jax.random.normal(k, (n, 3)) for k in jax.random.split(key, 12)])
                     for key in (k_proc, k_obs))
    hidden, ys = tdata.simulate_from_noise(
        cfg_t, torch.eye(3), *(torch.tensor(np.asarray(a)) for a in (x0, proc, obs))
    )
    assert_close(hidden, np.concatenate([ds.hidden_train, ds.hidden_test]), 1e-4)
    assert_close(ys, np.concatenate([ds.obs_train, ds.obs_test]), 1e-4)
    assert float(hidden.abs().max()) > 5.0  # on the attractor, not near the origin
    port = tdata.generate_dataset(cfg_t, seed=6)
    assert port.obs_train.shape == (3, 12, 3) and port.hidden_test.shape == (2, 12, 3)
    assert bool(torch.isfinite(port.hidden_train).all())


def test_dataset_file_is_shared(tmp_path):
    cfg = jdata.DataConfig(t_steps=6, n_train=3, n_test=2)
    ds = jdata.generate_dataset(cfg, seed=0)
    jdata.save_dataset(ds, tmp_path / "jax.npz")
    got = tdata.load_dataset(tmp_path / "jax.npz")
    for f in ("obs_train", "obs_test", "hidden_train", "hidden_test", "emission_matrix"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ds, f)))
    assert got.controls_train is None
    tdata.save_dataset(got, tmp_path / "torch.npz")
    back = jdata.load_dataset(tmp_path / "torch.npz")
    np.testing.assert_array_equal(np.asarray(back.obs_test), np.asarray(ds.obs_test))


def _weight_rows(k, rng):
    """Log-weight rows with ties, zero weights, floors and a dominant particle."""
    return _f32(np.stack([
        rng.standard_normal(k) * 3,
        np.zeros(k),
        -rng.integers(0, 3, k).astype(np.float64),
        np.where(np.arange(k) % 3 == 0, 0.0, -1e30),
        np.full(k, -50.0) + 50.0 * (np.arange(k) == k // 3),
        np.linspace(-100.0, 0.0, k),
    ]))


def test_resampling_indices_match_reference():
    rng = _rng(5)
    k = 128
    logw = _weight_rows(k, rng)
    u0 = _f32([0.0, 0.5, 0.25, 0.99999994, 0.3, 0.7])
    pos = np.asarray(jres.quantile_positions_from_raw(u0, k, "systematic"))
    assert_close(tres.quantile_positions_from_raw(T(u0), k, "systematic"), pos, 0)
    logw_norm, _ = jdist.log_normalize(logw)
    cumw = _f32(np.cumsum(np.exp(np.asarray(logw_norm)), axis=-1))
    np.testing.assert_array_equal(
        tres.inverse_cdf_indices(T(cumw), T(pos)).numpy(),
        np.asarray(jres.inverse_cdf_indices(cumw, pos)))
    np.testing.assert_array_equal(
        tres.systematic_indices_histogram(T(cumw), T(u0)).numpy(),
        np.asarray(jres.systematic_indices_histogram(cumw, u0)))
    x = _f32(rng.standard_normal((6, 2, k)))
    got = tres.maybe_resample(T(pos), T(logw), T(x))
    want = jres.maybe_resample(pos, logw, x)
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 3:  # ESS: float32 reductions in another order
            assert_close(a, b, 1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # ESS-adaptive: only rows below the threshold resample
    got = tres.maybe_resample(T(pos), T(logw), T(x), ess_threshold=0.5)
    want = jres.maybe_resample(pos, logw, x, ess_threshold=0.5)
    for a, b in zip(got, want):
        assert_close(a, b, 1e-5)


def test_count_form_indices_match_reference_two_level():
    """K3's plain version against the index function the TPU megakernel
    inlines (pallas_resample._two_level_indices, plain array math), on rows
    with ties, zero weights, floors and a dominant particle."""
    rng = _rng(6)
    k = 256
    logw = _weight_rows(k, rng)
    u0 = _f32(rng.uniform(size=logw.shape[0]))
    pos = np.asarray(jres.quantile_positions_from_raw(u0, k, "systematic"))
    want = np.asarray(pallas_resample._two_level_indices(jnp.asarray(logw), jnp.asarray(pos), k))
    got = fused_step.ancestor_indices(T(logw), T(u0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got, axis=-1) >= 0).all()


@pytest.mark.parametrize(
    "ctr, key, want",
    [
        ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         "d16cfe09 94fdcceb 5001e420 24126ea1"),
    ],
)
def test_philox_known_answers(ctr, key, want):
    out = fused_step.philox4x32_reference(
        tuple(torch.tensor(c, dtype=torch.int64) for c in ctr), key)
    assert " ".join(f"{int(w):08x}" for w in out) == want


def test_stream_noise_layout_and_distribution():
    seed, (t1, b, dx, k) = (12345, 678), (5, 3, 2, 256)
    eps, u0 = fused_step.stream_noise(seed, t1, b, dx, k, "cpu")
    assert eps.shape == (t1, b, dx, k) and u0.shape == (t1, b)
    again, _ = fused_step.stream_noise_reference(seed, t1, b, dx, k)
    assert torch.equal(eps, again)
    # Box-Muller pair form: particles p and p + K/2 share one radius
    r2 = eps[..., : k // 2] ** 2 + eps[..., k // 2 :] ** 2
    u1 = 1.0 - fused_step._unit24(fused_step.philox4x32_reference(
        (torch.arange(k // 2), torch.tensor(0), torch.tensor(0), torch.tensor(1)), seed)[0])
    assert_close(r2[0, 0, 0], -2.0 * torch.log(u1), 1e-4)
    assert ((u0 >= 0) & (u0 < 1)).all()
    flat = eps.flatten()
    assert abs(float(flat.mean())) < 0.05 and abs(float(flat.std()) - 1) < 0.05
    other, _ = fused_step.stream_noise((12345, 679), t1, b, dx, k, "cpu")
    assert not torch.equal(eps, other)
