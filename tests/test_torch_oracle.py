"""The torch port against the framework-neutral oracles of
`tests/reference_numpy/`: the trusted NumPy SMC, FFBSi and SVO, and the
Kalman filter and RTS smoother on a linear-Gaussian SSM.

Port-side versions of the reference's oracle tests, at their shapes and
bands, run on CPU tensors:

- `test_smoothing_reference.py`: the SVO bound and the three PSVO terms
  against `numpy_svo_elbo` / `numpy_psvo_terms` on FHN and Lorenz-63
  (K = 128, M = 8, T = 12, B = 4, 12 replicates, means within 4 standard
  errors plus 2%, `_bands`), and FIVO log Ẑ against `numpy_forward_filter`
  the same way. The oracle's model is the port's own parameters
  (`bridge.params_to_numpy`), its scale floor passed explicitly.
- `test_oracle_kalman.py`: bootstrap FIVO log Ẑ (systematic and
  multinomial resampling) and IWAE log Ẑ on a short prefix against the
  Kalman log-likelihood, PSVO's ELBO equal to the forward bound and near
  it, the FFBSi paths' means against the RTS smoother and nearer the true
  latents than the filtering means, and the segmented PSVO (S = 4) against
  both oracles, with a gradient; SVO a lower bound on it, with and without
  the qb GRU. The model is the reference's
  exact LGSSM (`tests/helpers.lgssm_setup`, linear heads with hidden=(),
  bootstrap mode), loaded into the port through `bridge.load_numpy_params`.
- The port's bootstrap filter against the reference's on the same draws
  (2e-4), and each kernel gate excluding bootstrap mode.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu.smc import forward_filter as j_forward_filter
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.data import generate_dataset
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.objectives import make_objective
from psvo_tpu_torch.ops import fused_step, svo, trunk
from psvo_tpu_torch.smc import forward_filter
from tests import helpers
from tests._torch_port import assert_close, key_noise
from tests.reference_numpy import kalman_filter, rts_smoother
from tests.reference_numpy.numpy_smc import NumpySSMParams, numpy_forward_filter
from tests.reference_numpy.numpy_smoothing import numpy_psvo_terms, numpy_svo_elbo
from tests.test_smoothing_reference import _bands

torch.set_num_threads(1)

K, M, T, B, REPS = 128, 8, 12, 4, 12  # the reference's test_smoothing_reference sizes


def _setup(datatype, objective, **data_kw):
    """The reference's `_setup` in the port: heads (16, 16), K = 128, M = 8,
    T = 12, B = 4 trajectories of the port's own simulator, random weights;
    and the NumPy oracle's view of the same model."""
    dx = 2 if datatype == "fhn" else 3
    net = tconfig.NetConfig(hidden=(16, 16))
    cfg = tconfig.Config(
        name=f"smoothing_ref_{datatype}",
        data=tconfig.DataConfig(datatype=datatype, dx=dx, dy=dx, t_steps=T, n_train=B,
                                n_test=B, **data_kw),
        smc=tconfig.SMCConfig(objective=objective, n_particles=K, n_smoothing_particles=M,
                              resampling="systematic"),
    ).with_nets(q0=net, q1=net, q2=net, f=net, g=dataclasses.replace(net, sigma_init=0.5),
                qb=net)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = generate_dataset(cfg.data, 1).obs_train[:B]
    oracle = NumpySSMParams(params=bridge.params_to_numpy(ssm), use_2q=cfg.smc.use_2q,
                            use_bootstrap=cfg.smc.use_bootstrap,
                            activation=net.activation, sigma_min=net.sigma_min)
    return cfg, ssm, ys, oracle


def _port_runs(cfg, ssm, ys, metrics, seed0):
    objective = make_objective(ssm, cfg)
    with torch.no_grad():
        outs = [objective(torch.Generator().manual_seed(seed0 + r), ys) for r in range(REPS)]
    return np.array([[float(torch.mean(o.elbo)) if name == "elbo" else float(o.metrics[name])
                      for name in metrics] for o in outs])


_DATA = [("fhn", {}), ("lorenz63", {"obs_scale": 0.5})]


@pytest.mark.parametrize("datatype,kw", _DATA)
def test_svo_bound_matches_numpy(datatype, kw):
    cfg, ssm, ys, oracle = _setup(datatype, "svo", **kw)
    port = _port_runs(cfg, ssm, ys, ["elbo"], 100)[:, 0]
    want = [float(np.mean(numpy_svo_elbo(oracle, ys.numpy(), K, M, seed=200 + 3 * r)))
            for r in range(REPS)]
    _bands(port, np.array(want))


@pytest.mark.parametrize("datatype,kw", _DATA)
def test_psvo_terms_match_numpy(datatype, kw):
    """All three PSVO quantities: forward log Ẑ, the smoothed-path
    log-joint (the EM surrogate) and the direct bound."""
    cfg, ssm, ys, oracle = _setup(datatype, "psvo", **kw)
    port = _port_runs(cfg, ssm, ys, ["elbo", "log_joint_smoothed", "elbo_psvo_direct"], 300)
    want = np.array([[np.mean(v) for v in numpy_psvo_terms(oracle, ys.numpy(), K, M,
                                                            seed=400 + 3 * r)]
                     for r in range(REPS)])
    for c in range(3):
        _bands(port[:, c], want[:, c])


@pytest.mark.parametrize("datatype,kw", _DATA)
def test_fivo_logz_matches_numpy(datatype, kw):
    cfg, ssm, ys, oracle = _setup(datatype, "fivo", **kw)
    port = _port_runs(cfg, ssm, ys, ["elbo"], 500)[:, 0]
    want = [float(np.mean(numpy_forward_filter(oracle, ys.numpy(), K, seed=600 + r)))
            for r in range(REPS)]
    _bands(port, np.array(want))


# ---------------------------------------------------------------------------
# The Kalman / RTS oracle (tests/test_oracle_kalman.py)
# ---------------------------------------------------------------------------

KB, KT = 4, 20


def _kalman(p, ys):
    q, r = p["q_scale"] ** 2 * np.eye(2), p["r_scale"] ** 2 * np.eye(2)
    s0 = p["s0_scale"] ** 2 * np.eye(2)
    kf = np.array([kalman_filter(y, p["a"], p["c"], q, r, p["mu0"], s0)[0] for y in ys])
    rts = np.stack([rts_smoother(y, p["a"], p["c"], q, r, p["mu0"], s0)[0] for y in ys])
    return kf, rts


@pytest.fixture(scope="module")
def lgssm():
    p = helpers.default_lgssm()
    xs, ys = helpers.simulate_lgssm(np.random.default_rng(42), t_steps=KT, batch=KB, **p)
    kf, rts = _kalman(p, ys)
    return dict(p=p, xs=xs, ys=ys, kf_loglik=kf, rts_means=rts)


def _lgssm_port(p, **kw):
    """The reference's exact LGSSM model (bootstrap, linear heads) in both
    packages: (reference cfg, reference ssm, its params, port cfg, port ssm)."""
    jcfg, jssm, params = helpers.lgssm_setup(**kw, **p)
    tcfg = tconfig.from_dict(jcfg.to_dict())
    tssm = SSM(tcfg)
    bridge.load_numpy_params(tssm, jax.tree_util.tree_map(np.asarray, params))
    return jcfg, jssm, params, tcfg, tssm


def _run(lgssm, objective, k, m=16, seed=0, **kw):
    *_, tcfg, tssm = _lgssm_port(lgssm["p"], objective=objective, n_particles=k, n_smoothing=m,
                                 t_steps=KT, **kw)
    with torch.no_grad():
        return make_objective(tssm, tcfg)(torch.Generator().manual_seed(seed),
                                          torch.from_numpy(lgssm["ys"]))


def test_fivo_logz_matches_kalman(lgssm):
    """Bootstrap FIVO with K = 4096 sits within a fraction of a nat of the
    Kalman log-likelihood, with no upward bias."""
    logz = np.mean([_run(lgssm, "fivo", 4096, seed=s).elbo.numpy() for s in range(4)], axis=0)
    err = logz - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.35), err
    assert np.mean(err) < 0.1


def test_iwae_logz_matches_kalman_short_horizon(lgssm):
    """IWAE (no resampling) degenerates in T, so a short prefix: downward
    biased at finite K, never above the Kalman log-likelihood by a quarter
    nat."""
    t_short = 8
    ys = lgssm["ys"][:, :t_short]
    kf, _ = _kalman(lgssm["p"], ys)
    *_, tcfg, tssm = _lgssm_port(lgssm["p"], objective="iwae", n_particles=8192,
                                 resampling="none", t_steps=t_short)
    objective = make_objective(tssm, tcfg)
    with torch.no_grad():
        outs = [objective(torch.Generator().manual_seed(s), torch.from_numpy(ys)).elbo.numpy()
                for s in range(8)]
    err = np.mean(outs, axis=0) - kf
    assert np.all(err < 0.25), err
    assert np.all(err > -0.8), err


def test_multinomial_resampling_also_unbiased(lgssm):
    outs = [_run(lgssm, "fivo", 4096, resampling="multinomial", seed=s).elbo.numpy()
            for s in range(4)]
    err = np.mean(outs, axis=0) - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.5), err


def test_psvo_elbo_equals_forward_bound_and_matches_kalman(lgssm):
    out = _run(lgssm, "psvo", 2048, m=32)
    np.testing.assert_allclose(float(out.elbo.mean()), float(out.metrics["log_z_fwd"]),
                               rtol=1e-6)
    err = out.elbo.numpy() - lgssm["kf_loglik"]
    assert np.all(np.abs(err) < 0.6), err


@pytest.mark.parametrize("qb_rnn", [False, True])
def test_svo_is_a_lower_bound(lgssm, qb_rnn):
    """With an untrained backward proposal SVO is loose but stays a bound on
    the Kalman log-likelihood (K = 1024, M = 32); with the qb GRU too (q_b
    then a relu head (16,) on [x; y; h] with its GRU drawn at random, the
    LGSSM's f, g and prior as they are)."""
    if not qb_rnn:
        out = _run(lgssm, "svo", 1024, m=32)
    else:
        *_, tcfg, tssm = _lgssm_port(lgssm["p"], objective="svo", n_particles=1024,
                                     n_smoothing=32, t_steps=KT)
        rnn_cfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, qb_rnn=True))
        rnn_cfg = rnn_cfg.with_nets(qb=dataclasses.replace(tcfg.net("qb"), hidden=(16,)))
        rnn = SSM(rnn_cfg).init(torch.Generator().manual_seed(1))
        tree = bridge.params_to_numpy(rnn)
        tree.update({k: v for k, v in bridge.params_to_numpy(tssm).items() if k != "qb"})
        bridge.load_numpy_params(rnn, tree)
        with torch.no_grad():
            out = make_objective(rnn, rnn_cfg)(torch.Generator().manual_seed(0),
                                               torch.from_numpy(lgssm["ys"]))
    elbo = out.elbo.numpy()
    assert np.all(np.isfinite(elbo))
    assert np.all(elbo < lgssm["kf_loglik"] + 1.0), elbo - lgssm["kf_loglik"]


def test_ffbsi_smoothed_means_match_rts(lgssm):
    """PSVO's FFBSi trajectories average to the RTS smoothed means."""
    outs = [_run(lgssm, "psvo", 2048, m=64, seed=s).smoothed.numpy() for s in range(3)]
    sm = np.swapaxes(np.mean(outs, axis=(0, 3)), 0, 1)  # [B, T, Dx]
    rmse = np.sqrt(np.mean((sm - lgssm["rts_means"]) ** 2))
    assert rmse < 0.12, rmse


def test_smoothing_beats_filtering_rmse(lgssm):
    """The FFBSi paths' means sit nearer the true latents than the filtering
    means do."""
    out = _run(lgssm, "psvo", 2048, m=64)
    fwd = out.filter_result
    w = torch.softmax(fwd.logws, dim=-1)  # [T, B, K]
    filt = torch.einsum("tbk,tbdk->btd", w, fwd.xs).numpy()
    sm = np.swapaxes(out.smoothed.numpy().mean(2), 0, 1)
    rmse_f = np.sqrt(np.mean((filt - lgssm["xs"]) ** 2))
    rmse_s = np.sqrt(np.mean((sm - lgssm["xs"]) ** 2))
    assert rmse_s < rmse_f * 1.02, (rmse_s, rmse_f)


def test_segmented_psvo_matches_kalman_and_rts():
    """Segmented FFBSi (S = 4 segments of 6 steps on a T = 25 dataset) hits
    the same oracles as the full-cache sweep, and its gradient is finite and
    nonzero."""
    p = helpers.default_lgssm()
    _, ys = helpers.simulate_lgssm(np.random.default_rng(7), t_steps=25, batch=3, **p)
    kf, rts = _kalman(p, ys)
    *_, tcfg, tssm = _lgssm_port(p, objective="psvo", n_particles=2048, n_smoothing=64,
                                 t_steps=25)
    tcfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, ffbsi_segments=4))
    objective = make_objective(tssm, tcfg)
    ys_t = torch.from_numpy(ys)
    with torch.no_grad():
        outs = [objective(torch.Generator().manual_seed(s), ys_t) for s in range(3)]
    elbo = np.mean([o.elbo.numpy() for o in outs], axis=0)
    assert np.all(np.abs(elbo - kf) < 0.7), elbo - kf
    sm = np.swapaxes(np.mean([o.smoothed.numpy() for o in outs], axis=(0, 3)), 0, 1)
    assert sm.shape == rts.shape
    rmse = np.sqrt(np.mean((sm - rts) ** 2))
    assert rmse < 0.12, rmse
    objective(torch.Generator().manual_seed(0), ys_t).loss.backward()
    gn = sum(float(q.grad.abs().sum()) for q in tssm.parameters() if q.grad is not None)
    assert np.isfinite(gn) and gn > 0


def test_bootstrap_filter_matches_reference_on_the_same_draws(lgssm):
    """The port's plain bootstrap filter (t = 0 from the prior, α0 = log g;
    each step from f, α = log g) against the reference's on the draws of one
    key: log Ẑ, the increments, the ESS and the filtered means."""
    jcfg, jssm, params, tcfg, tssm = _lgssm_port(lgssm["p"], n_particles=256, t_steps=KT)
    key = jax.random.key(3)
    want = j_forward_filter(jssm, params, key, lgssm["ys"], jcfg.smc)
    noise = tuple(torch.from_numpy(np.array(a, np.float32))
                  for a in key_noise(key, KB, KT, 2, 256))
    with torch.no_grad():
        got = forward_filter(tssm, None, torch.from_numpy(lgssm["ys"]), tcfg.smc, noise=noise)
    for name in ("log_z", "increments", "ess", "filtered_means"):
        assert_close(getattr(got, name), getattr(want, name), 2e-4)


def _in_class(gate, cfg):
    if gate == "svo":
        return svo.usable(SSM(cfg), cfg.smc.n_smoothing_particles)
    return {"fused_step": fused_step, "trunk": trunk}[gate].usable(SSM(cfg), cfg.smc)


@pytest.mark.parametrize("gate, preset", [("fused_step", "lorenz63_psvo_k1024"),
                                          ("trunk", "lorenz96_fivo_k8192_sharded"),
                                          ("svo", "lorenz63_svo_k256")])
def test_kernel_gate_excludes_bootstrap(gate, preset):
    """Each kernel gate holds its preset's model in its class, and the same
    model in bootstrap mode where the reference's gate does: the filter
    kernels' gates exclude it (their proposal is q1/q2, bootstrap's is f);
    the SVO sweep's keeps it (`pallas_svo.usable` has no bootstrap test: the
    sweep reads q_b, f and g, never the forward proposal)."""
    cfg = tconfig.PRESETS[preset]
    boot = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, use_bootstrap=True))
    assert _in_class(gate, cfg)
    assert _in_class(gate, boot) == (gate == "svo")
