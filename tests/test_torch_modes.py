"""The port's model modes against `psvo_tpu`, on CPU tensors.

Port-side versions of `tests/test_parity_modes.py`'s mode tests (the tril and
tril_head Kalman/RTS cases, known dynamics with and without controls, Dirac,
the pairwise densities, the tril_head density and sample against NumPy, the
invalid combinations), and the pieces of each mode held to the reference on
the same numbers: the distributions, the heads of every cov_type, the
model's channel-major and feature-last densities and means, the k-step
predictions, the simulator's Poisson and Dirac emissions, and the bridge and
checkpoint round trips of every parameter layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu import distributions as jdist
from psvo_tpu import networks as jnet
from psvo_tpu import train as jtrain
from psvo_tpu.models.ssm import init_ssm as j_init_ssm
from psvo_tpu_torch import bridge
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch import distributions as tdist
from psvo_tpu_torch import networks as tnet
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.data import generate_dataset
from psvo_tpu_torch.models.dynamics import make_stepper
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.objectives import _pairwise_query_logp, _pairwise_support_terms, make_objective
from psvo_tpu_torch.utils.checkpoint import Checkpointer
from tests import helpers
from tests._torch_port import assert_close, models
from tests.reference_numpy import kalman_filter, rts_smoother

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rng(seed):
    return np.random.default_rng(seed)


# -- distributions -----------------------------------------------------------------


def _chol(rng, *lead, d=3):
    """Random lower-triangular factors with a positive diagonal."""
    c = np.tril(rng.standard_normal((*lead, d, d)) * 0.4)
    idx = np.arange(d)
    c[..., idx, idx] = np.abs(c[..., idx, idx]) + 0.3
    return c.astype(np.float32)


def test_full_covariance_densities_match_reference():
    rng = _rng(0)
    x, mean = rng.standard_normal((2, 5, 3)), rng.standard_normal((2, 5, 3))
    chol = _chol(rng, 2, 5)
    assert_close(tdist.mvn_full_log_prob(_t(x), _t(mean), _t(chol)),
                 jdist.mvn_full_log_prob(x, mean, chol), 1e-5)
    chol1 = _chol(rng)
    assert_close(tdist.mvn_full_log_prob(_t(x), _t(mean), _t(chol1)),
                 jdist.mvn_full_log_prob(x, mean, chol1), 1e-5)
    x_cm, m_cm = rng.standard_normal((2, 3, 7)), rng.standard_normal((2, 3, 7))
    assert_close(tdist.mvn_full_log_prob_cm(_t(x_cm), _t(m_cm), _t(chol1)),
                 jdist.mvn_full_log_prob_cm(x_cm, m_cm, chol1), 1e-5)


def test_packed_tril_density_and_sample_match_reference():
    rng = _rng(1)
    x, mean, eps = (rng.standard_normal((2, 3, 7)).astype(np.float32) for _ in range(3))
    diag = (np.abs(rng.standard_normal((2, 3, 7))) + 0.3).astype(np.float32)
    off = rng.standard_normal((2, 3, 7)).astype(np.float32) * 0.5
    assert_close(tdist.mvn_tril_log_prob_cm(_t(x), _t(mean), _t(diag), _t(off)),
                 jdist.mvn_tril_log_prob_cm(x, mean, diag, off), 1e-5)
    assert_close(tdist.mvn_tril_sample_cm(_t(eps), _t(mean), _t(diag), _t(off)),
                 jdist.mvn_tril_sample_cm(eps, mean, diag, off), 1e-6)


def test_poisson_and_dirac_match_reference():
    rng = _rng(2)
    y = np.round(np.abs(rng.standard_normal((4, 3))) * 3).astype(np.float32)
    lr = (rng.standard_normal((4, 3)) * 50).astype(np.float32)  # some beyond the ±80 clamp
    assert_close(tdist.poisson_log_prob(_t(y), _t(lr)), jdist.poisson_log_prob(y, lr), 1e-5)
    assert_close(tdist.poisson_log_prob_cm(_t(y.T[None]), _t(lr.T[None])),
                 jdist.poisson_log_prob_cm(y.T[None], lr.T[None]), 1e-5)
    draws = tdist.poisson_sample(torch.Generator().manual_seed(0), torch.zeros(20000))
    assert draws.dtype == torch.float32 and abs(float(draws.mean()) - 1.0) < 0.05
    m = _t(rng.standard_normal((4, 3)))
    assert torch.equal(tdist.dirac_sample(None, m), m)
    assert torch.equal(tdist.dirac_log_prob(m, m), torch.zeros(4))
    full = tdist.mvn_full_sample(torch.Generator().manual_seed(1), torch.zeros(50000, 2),
                                 torch.tensor([[1.0, 0.0], [0.5, 0.5]]))
    cov = np.cov(full.numpy().T)
    np.testing.assert_allclose(cov, [[1.0, 0.5], [0.5, 0.5]], atol=0.03)


# -- heads ---------------------------------------------------------------------------


@pytest.mark.parametrize("cov", ["const", "head", "tril", "tril_head", "none"])
def test_head_of_each_cov_type_matches_reference(cov):
    """Each cov_type's leaves cross the bridge both ways, and the port's apply
    functions give the reference's values on them (feature-last and
    channel-major)."""
    params = jnet.init_mlp_head(jax.random.key(0), 3, 3, (8,), cov_type=cov, sigma_init=0.7)
    if cov in ("head", "tril_head"):  # strongly state-dependent
        for name in ("scale_head", "tril_diag_head", "tril_off_head"):
            if name in params:
                params[name] = (params[name][0] * 30, params[name][1])
    head = tnet.MLPHead(3, 3, (8,), cov)
    leaves = dict(bridge._head_leaves(head))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    assert set(leaves) == set(np_params)
    with torch.no_grad():
        for key, dst in leaves.items():
            bridge._copy_node(dst, np_params[key], key)
    back = {k: bridge._map(v, lambda t: t.detach().numpy()) for k, v in leaves.items()}
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    x = _rng(3).standard_normal((2, 5, 3)).astype(np.float32)
    x_cm = np.swapaxes(x, -1, -2)
    with torch.no_grad():
        assert_close(tnet.mlp_mean(head, _t(x)), jnet.mlp_mean(params, x), 1e-5)
        assert_close(tnet.mlp_mean_cm(head, _t(x_cm)), jnet.mlp_mean_cm(params, x_cm), 1e-5)
        if cov in ("const", "head"):
            for got, want in zip(tnet.mlp_mean_scale(head, _t(x), sigma_min=1e-3),
                                 jnet.mlp_mean_scale(params, x, sigma_min=1e-3)):
                assert_close(got, want, 1e-5)
            for got, want in zip(tnet.mlp_mean_scale_cm(head, _t(x_cm), sigma_min=1e-3),
                                 jnet.mlp_mean_scale_cm(params, x_cm, sigma_min=1e-3)):
                assert_close(got, want, 1e-5)
        if cov == "tril":
            assert_close(head.chol(1e-3), jnet.tril_from_raw(params["raw_tril"], 1e-3), 1e-6)
        if cov == "tril_head":
            for got, want in zip(tnet.mlp_mean_tril(head, _t(x), sigma_min=1e-3),
                                 jnet.mlp_mean_tril(params, x, sigma_min=1e-3)):
                assert_close(got, want, 1e-5)
            for got, want in zip(tnet.mlp_mean_tril_cm(head, _t(x_cm), sigma_min=1e-3),
                                 jnet.mlp_mean_tril_cm(params, x_cm, sigma_min=1e-3)):
                assert_close(got, want, 1e-5)


# -- the model's modes ----------------------------------------------------------------

# (preset or base, config changes): the mode configurations held to the reference
_MODEL_MODES = {
    "known dynamics": ("fhn_fivo_known_dynamics", {}),
    "known dynamics, controls": ("fhn_fivo_known_dynamics", {"di": 2}),
    "tril": ("fhn_fivo_tril", {}),
    "tril_head": ("fhn_fivo_k128", {"nets": {"f": "tril_head", "g": "tril_head"}}),
    "head": ("fhn_fivo_k128", {"nets": {"f": "head", "g": "head"}}),
    "dirac": ("fhn_fivo_dirac", {}),
    "poisson": ("fhn_fivo_k128", {"emission": "poisson"}),
    "q_uses_true_x": ("fhn_fivo_k128", {"q_uses_true_x": True}),
}


def _mode_config(mode):
    base, kw = _MODEL_MODES[mode]
    jcfg = jconfig.PRESETS[base]
    data = dataclasses.replace(jcfg.data, t_steps=6, di=kw.get("di", jcfg.data.di),
                               emission=kw.get("emission", jcfg.data.emission))
    smc = dataclasses.replace(jcfg.smc, q_uses_true_x=kw.get("q_uses_true_x", False))
    jcfg = dataclasses.replace(jcfg, data=data, smc=smc, use_pallas=False)
    jcfg = jcfg.with_nets(**{n: dataclasses.replace(jcfg.net(n), hidden=(16,),
                                                    cov_type=kw.get("nets", {}).get(
                                                        n, jcfg.net(n).cov_type))
                             for n, _ in jcfg.nets})
    return jcfg, tconfig.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("mode", sorted(_MODEL_MODES))
def test_model_densities_and_means_match_reference(mode):
    """The SSM's transition and emission densities (channel-major and
    feature-last), means and k-step predictions in each mode, on bridged
    parameters."""
    jcfg, tcfg = _mode_config(mode)
    jssm, params, tssm = models(jcfg, tcfg)
    if jcfg.data.di:  # a non-zero drift map
        params["f"]["ctrl_w"] = jnp.asarray([[0.3, -0.2], [0.1, 0.4]])
        bridge.load_numpy_params(tssm, jax.tree_util.tree_map(np.asarray, params))
    rng = _rng(4)
    x_cm, x_new = (rng.standard_normal((3, 2, 8)).astype(np.float32) for _ in range(2))
    y = np.round(np.abs(rng.standard_normal((3, 2))) * 2).astype(np.float32)
    x_fl, x_fl2 = (rng.standard_normal((3, 5, 2)).astype(np.float32) for _ in range(2))
    y_fl = np.round(np.abs(rng.standard_normal((3, 5, 2))) * 2).astype(np.float32)
    u = rng.standard_normal((3, 2)).astype(np.float32) if jcfg.data.di else None
    tu = None if u is None else _t(u)
    with torch.no_grad():
        assert_close(tssm.transition_log_prob_cm(_t(x_cm), _t(x_new), tu),
                     jssm.transition_log_prob_cm(params, x_cm, x_new, u), 2e-5)
        assert_close(tssm.emission_log_prob_cm(_t(x_new), _t(y)),
                     jssm.emission_log_prob_cm(params, x_new, y), 2e-5)
        assert_close(tssm.transition_log_prob(_t(x_fl), _t(x_fl2), tu),
                     jssm.transition_log_prob(params, x_fl, x_fl2, u), 2e-5)
        assert_close(tssm.emission_log_prob(_t(x_fl), _t(y_fl)),
                     jssm.emission_log_prob(params, x_fl, y_fl), 2e-5)
        assert_close(tssm.transition_mean(_t(x_fl), tu), jssm.transition_mean(params, x_fl, u),
                     2e-5)
        assert_close(tssm.emission_mean(_t(x_fl)), jssm.emission_mean(params, x_fl), 2e-5)
        controls = None if u is None else np.repeat(u[:, None], 5, axis=1)
        want = jtrain.k_step_predictions(jssm, params, x_fl, 3, controls)
        got = ttrain.k_step_predictions(tssm, _t(x_fl), 3,
                                        None if controls is None else _t(controls))
        assert_close(got, want, 2e-5)


def test_known_dynamics_transition_is_the_stepper():
    """transition='known': f holds only raw_scale (and ctrl_w with controls,
    zero at init); its mean is the true stepper, feature-last and
    channel-major, plus u·ctrl_w."""
    jcfg, tcfg = _mode_config("known dynamics")
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n for n, _ in ssm.heads["f"].named_parameters()} == {"raw_scale"}
    assert set(bridge.params_to_numpy(ssm)["f"]) == {"raw_scale"}
    stepper = make_stepper(tcfg.data)
    x = torch.randn((4, 2), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(ssm.transition_params(x)[0], stepper.step(x))
        x_cm = torch.randn((3, 2, 8), generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(ssm.transition_params_cm(x_cm)[0], stepper.step(x_cm, axis=-2))
    _, ccfg = _mode_config("known dynamics, controls")
    cssm = init_ssm(ccfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(bridge.params_to_numpy(cssm)["f"]) == {"raw_scale", "ctrl_w"}
    u = torch.randn((4, 2), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        torch.testing.assert_close(cssm.transition_params(x, u)[0], stepper.step(x))  # zero init
        cssm.heads["f"].ctrl_w.copy_(torch.tensor([[0.3, -0.2], [0.1, 0.4]]))
        torch.testing.assert_close(cssm.transition_params(x, u)[0],
                                   stepper.step(x) + u @ cssm.heads["f"].ctrl_w)


def test_known_dynamics_trains():
    """Proposal-only training with the frozen true dynamics: the FIVO steps
    are finite, and the noise scale moves."""
    _, tcfg = _mode_config("known dynamics")
    tcfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, n_particles=16))
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = generate_dataset(dataclasses.replace(tcfg.data, n_train=8, n_test=4), 0).obs_train
    step = ttrain.make_train_step(ssm, tcfg, ttrain.make_optimizer(tcfg))
    before = ssm.heads["f"].raw_scale.detach().clone()
    for i in range(3):
        m = step(torch.Generator().manual_seed(i), ys)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert not torch.equal(before, ssm.heads["f"].raw_scale)


def test_dirac_emission_pipeline():
    """emission='dirac': the data is y = x·C exactly, g adds 0 to every
    weight, and the objective is finite."""
    _, tcfg = _mode_config("dirac")
    tcfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, n_particles=8))
    ds = generate_dataset(dataclasses.replace(tcfg.data, t_steps=10, n_train=8, n_test=4), 0)
    assert torch.equal(ds.obs_test, ds.hidden_test @ ds.emission_matrix)
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert ssm.heads["g"].cov_type == "none"
    x, y = torch.randn((3, 4, 2)), torch.randn((3, 4, 2))
    assert torch.equal(ssm.emission_log_prob(x, y), torch.zeros(3, 4))
    assert torch.equal(ssm.emission_log_prob_cm(torch.randn((3, 2, 8)), y[:, 0]),
                       torch.zeros(3, 8))
    out = make_objective(ssm, tcfg)(torch.Generator().manual_seed(4), ds.obs_test)
    assert np.isfinite(float(out.loss))


def test_poisson_dataset_draws_counts():
    """emission='poisson': non-negative integer counts of rate exp(tanh(x·C)),
    drawn after the other draws (the latents equal the Gaussian dataset's)."""
    cfg = dataclasses.replace(jconfig.DataConfig(), t_steps=20, n_train=16, n_test=4)
    tcfg = tconfig.from_dict(jconfig.Config(data=cfg).to_dict()).data
    gauss = generate_dataset(tcfg, 0)
    pois = generate_dataset(dataclasses.replace(tcfg, emission="poisson"), 0)
    assert torch.equal(pois.hidden_train, gauss.hidden_train)
    assert torch.equal(pois.obs_train, pois.obs_train.round()) and bool((pois.obs_train >= 0).all())
    rate = torch.exp(torch.tanh(pois.hidden_train @ pois.emission_matrix))
    assert abs(float(pois.obs_train.mean() - rate.mean())) < 0.15


def test_invalid_mode_combinations_rejected():
    base = tconfig.Config(
        name="bad",
        data=tconfig.DataConfig(datatype="fhn", dx=2, dy=2, t_steps=4),
        smc=tconfig.SMCConfig(objective="fivo", n_particles=8),
    )
    with pytest.raises(ValueError):  # tril proposals
        SSM(base.with_nets(q1=tconfig.NetConfig(cov_type="tril")))
    with pytest.raises(ValueError):  # tril_head proposals
        SSM(base.with_nets(q2=tconfig.NetConfig(cov_type="tril_head")))
    with pytest.raises(ValueError):  # known dynamics: diagonal noise only
        SSM(dataclasses.replace(base.with_nets(f=tconfig.NetConfig(cov_type="tril")),
                                smc=dataclasses.replace(base.smc, transition="known")))
    with pytest.raises(ValueError):  # poisson has no covariance head
        SSM(dataclasses.replace(base.with_nets(g=tconfig.NetConfig(cov_type="tril")),
                                data=dataclasses.replace(base.data, emission="poisson")))
    # the qb GRU builds (it is ported): the GRU on y and the widened qb input
    rnn = SSM(dataclasses.replace(base, smc=dataclasses.replace(base.smc, qb_rnn=True)))
    h = rnn.qb_rnn_dim
    assert rnn.gru.z_w.shape == (2 + h, h)
    assert rnn.heads["qb"].weights[0].shape == (2 + 2 + h, base.net("qb").hidden[0])


# -- pairwise densities ------------------------------------------------------------


@pytest.mark.parametrize("cov", ["tril", "tril_head"])
def test_full_covariance_pairwise_matches_direct_density(cov):
    """The whitened (tril) and precision-contraction (tril_head) pairwise
    forms equal the direct full-covariance density taken pair by pair, and
    the reference's pairwise form."""
    from psvo_tpu.objectives import _pairwise_transition_logp

    jcfg = jconfig.Config(
        name="pw", data=jconfig.DataConfig(datatype="fhn", dx=3, dy=3, t_steps=4),
        smc=jconfig.SMCConfig(objective="psvo", n_particles=16), use_pallas=False,
    ).with_nets(f=jconfig.NetConfig(cov_type=cov, hidden=(8,), sigma_init=0.7))
    jssm, params = j_init_ssm(jcfg, jax.random.key(0))
    if cov == "tril_head":
        for name in ("tril_diag_head", "tril_off_head"):
            params["f"][name] = (params["f"][name][0] * 30, params["f"][name][1])
    else:
        params["f"]["raw_tril"]["off"] = jnp.asarray([0.3, -0.2, 0.1])
    tssm = SSM(tconfig.from_dict(jcfg.to_dict()))
    bridge.load_numpy_params(tssm, jax.tree_util.tree_map(np.asarray, params))
    xs = _t(jax.random.normal(jax.random.key(1), (2, 3, 16)))
    xq = _t(jax.random.normal(jax.random.key(2), (2, 5, 3)))
    with torch.no_grad():
        got = _pairwise_query_logp(tssm, _pairwise_support_terms(tssm, xs), xq)
        if cov == "tril_head":
            mean, chol = tssm._mean_tril("f", xs.transpose(-1, -2))
            want = tdist.mvn_full_log_prob(xq[:, :, None, :], mean[:, None], chol[:, None])
        else:
            mean, chol = tssm.transition_full_cm(xs)
            want = tdist.mvn_full_log_prob(xq[:, :, None, :], mean.transpose(-1, -2)[:, None],
                                           chol)
    assert_close(got, want, 2e-4)
    assert_close(got, _pairwise_transition_logp(jssm, params, np.asarray(xs), np.asarray(xq)),
                 2e-4)


def test_trilhead_density_and_sample_match_numpy():
    """The state-dependent packed-Cholesky density and draw against
    per-sample SciPy/NumPy linear algebra, channel-major against
    feature-last."""
    from scipy.stats import multivariate_normal

    d, k, b = 3, 8, 2
    head = tnet.init_mlp_head(torch.Generator().manual_seed(3), d, d, (16,),
                              cov_type="tril_head", sigma_init=0.8)
    with torch.no_grad():
        head.tril_diag_w.mul_(50)
        head.tril_off_w.mul_(50)
        g = torch.Generator().manual_seed(4)
        x_cm, y_cm, eps = (torch.randn((b, d, k), generator=g) for _ in range(3))
        mean, diag, off = tnet.mlp_mean_tril_cm(head, x_cm, sigma_min=1e-3)
        got = tdist.mvn_tril_log_prob_cm(y_cm, mean, diag, off).numpy()
        mean_fl, chol_fl = tnet.mlp_mean_tril(head, x_cm.transpose(-1, -2), sigma_min=1e-3)
        draw = tdist.mvn_tril_sample_cm(eps, mean, diag, off).transpose(-1, -2).numpy()
    mean_fl, chol_fl = mean_fl.numpy(), chol_fl.numpy()
    np.testing.assert_allclose(mean.transpose(-1, -2).numpy(), mean_fl, rtol=1e-5, atol=1e-5)
    assert np.abs(np.diff(chol_fl, axis=1)).max() > 1e-3  # the factor varies with the state
    y_fl = y_cm.transpose(-1, -2).numpy()
    want = np.array([[multivariate_normal(mean_fl[i, j], chol_fl[i, j] @ chol_fl[i, j].T)
                      .logpdf(y_fl[i, j]) for j in range(k)] for i in range(b)])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want_draw = mean_fl + np.einsum("bkde,bke->bkd", chol_fl, eps.transpose(-1, -2).numpy())
    np.testing.assert_allclose(draw, want_draw, rtol=1e-5, atol=1e-5)


# -- the Kalman / RTS oracle with correlated noise -----------------------------------


def _full_cov_case():
    theta = 0.4
    a = 0.85 * np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]],
                        np.float32)
    c = np.eye(2, dtype=np.float32)
    q_chol = np.array([[0.5, 0.0], [0.3, 0.4]], np.float32)
    r_chol = np.array([[0.4, 0.0], [-0.2, 0.3]], np.float32)
    return a, c, q_chol, r_chol, np.zeros(2, np.float32)


def _oracle_port(jcfg, params):
    tssm = SSM(tconfig.from_dict(jcfg.to_dict()))
    bridge.load_numpy_params(tssm, jax.tree_util.tree_map(np.asarray, params))
    return tconfig.from_dict(jcfg.to_dict()), tssm


def _trilhead_oracle(a, c, q_chol, r_chol, mu0, k, t):
    """The reference's tril_head oracle model (test_parity_modes.py:365):
    heads with hidden=() and zero state weights, so each factor is constant."""
    from psvo_tpu.models.ssm import SSM as JSSM

    lin = jconfig.NetConfig(hidden=(), cov_type="const", sigma_init=1.0,
                            sigma_min=helpers.SIGMA_MIN)
    th = dataclasses.replace(lin, cov_type="tril_head")
    jcfg = jconfig.Config(
        name="lgssm_trilhead_oracle", data=jconfig.DataConfig(datatype="lgssm", dx=2, dy=2, t_steps=t),
        smc=jconfig.SMCConfig(objective="fivo", n_particles=k, use_bootstrap=True),
        use_pallas=False,
    ).with_nets(q0=lin, q1=lin, q2=lin, f=th, g=th, qb=lin)
    params = JSSM(jcfg).init(jax.random.key(0))
    for name, mat, chol in (("f", a, q_chol), ("g", c, r_chol)):
        head = params[name]
        head["mean"] = (jnp.asarray(mat.T, jnp.float32), jnp.zeros((2,)))
        head["tril_diag_head"] = (jnp.zeros_like(head["tril_diag_head"][0]), jnp.asarray(
            [helpers.raw_from_scale(float(chol[i, i]), helpers.SIGMA_MIN) for i in range(2)],
            jnp.float32))
        head["tril_off_head"] = (jnp.zeros_like(head["tril_off_head"][0]),
                                 jnp.asarray([chol[1, 0]], jnp.float32))
    params["prior"]["mean"] = jnp.asarray(mu0)
    params["prior"]["raw_scale"] = jnp.full((2,), helpers.raw_from_scale(1.0, 1e-3))
    return jcfg, params


@pytest.mark.parametrize("cov", ["tril", "tril_head"])
def test_full_covariance_bootstrap_matches_kalman(cov):
    """Bootstrap FIVO with f and g set to the true correlated-noise LGSSM
    ("tril": the constant factor; "tril_head": the packed per-particle one,
    its weights zero) reproduces the Kalman log-likelihood (K = 2048, T = 20,
    four seeds, every row within 0.5 nats)."""
    a, c, q_chol, r_chol, mu0 = _full_cov_case()
    t = 20
    _, ys = helpers.simulate_lgssm_full(_rng(11), a, c, q_chol, r_chol, mu0, 1.0, t, 3)
    kf = np.array([kalman_filter(ys[b], a, c, q_chol @ q_chol.T, r_chol @ r_chol.T, mu0,
                                 np.eye(2))[0] for b in range(3)])
    if cov == "tril":
        jcfg, _, params = helpers.lgssm_full_setup(a=a, c=c, q_chol=q_chol, r_chol=r_chol, mu0=mu0,
                                                   s0_scale=1.0, n_particles=2048, t_steps=t)
    else:
        jcfg, params = _trilhead_oracle(a, c, q_chol, r_chol, mu0, 2048, t)
    tcfg, tssm = _oracle_port(jcfg, params)
    objective = make_objective(tssm, tcfg)
    with torch.no_grad():
        outs = [objective(torch.Generator().manual_seed(s), torch.from_numpy(ys)).elbo.numpy()
                for s in range(4)]
    err = np.mean(outs, axis=0) - kf
    assert np.all(np.abs(err) < 0.5), err


def test_tril_psvo_smoothed_means_match_rts():
    """PSVO over the tril (whitened pairwise) path on CPU tensors hits the RTS
    oracle with correlated noise (K = 2048, M = 64, three seeds)."""
    a, c, q_chol, r_chol, mu0 = _full_cov_case()
    t = 20
    _, ys = helpers.simulate_lgssm_full(_rng(12), a, c, q_chol, r_chol, mu0, 1.0, t, 3)
    rts = np.stack([rts_smoother(ys[b], a, c, q_chol @ q_chol.T, r_chol @ r_chol.T, mu0,
                                 np.eye(2))[0] for b in range(3)])
    jcfg, _, params = helpers.lgssm_full_setup(a=a, c=c, q_chol=q_chol, r_chol=r_chol, mu0=mu0,
                                               s0_scale=1.0, objective="psvo", n_particles=2048,
                                               n_smoothing=64, t_steps=t)
    tcfg, tssm = _oracle_port(jcfg, params)
    objective = make_objective(tssm, tcfg)
    with torch.no_grad():
        outs = [objective(torch.Generator().manual_seed(s), torch.from_numpy(ys)).smoothed.numpy()
                for s in range(3)]
    sm = np.swapaxes(np.mean(outs, axis=(0, 3)), 0, 1)  # [B, T, Dx]
    rmse = np.sqrt(np.mean((sm - rts) ** 2))
    assert rmse < 0.15, rmse


# -- parameter layouts across the bridge and checkpoints ----------------------------


@pytest.mark.parametrize("mode", sorted(_MODEL_MODES))
def test_layouts_round_trip_bridge_and_checkpoint(mode, tmp_path):
    """Every parameter layout: the reference's tree into the port and back
    bit for bit, an .npz snapshot in the reference's keystr keys, and a
    checkpoint saved and restored into a fresh model."""
    jcfg, tcfg = _mode_config(mode)
    _, params, tssm = models(jcfg, tcfg)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    back = jax.tree_util.tree_leaves(bridge.params_to_numpy(tssm))
    assert len(back) == len(flat)
    for (_, want), got in zip(flat, back):
        np.testing.assert_array_equal(got, np.asarray(want))
    path = tmp_path / "params.npz"
    np.savez(path, **{jax.tree_util.keystr(p): np.asarray(v) for p, v in flat})
    fresh = bridge.load_params_npz(SSM(tcfg), path)
    for a, b in zip(fresh.state_dict().values(), tssm.state_dict().values()):
        assert torch.equal(a, b)
    tr = ttrain.Trainer(tcfg, tssm)
    Checkpointer(tmp_path / "ck", tcfg.resume_hash()).save(tr.state, force=True)
    other = ttrain.Trainer(tcfg, SSM(tcfg).init(torch.Generator().manual_seed(5)))
    assert Checkpointer(tmp_path / "ck", tcfg.resume_hash()).restore(other.state) is not None
    for a, b in zip(other.state.model.state_dict().values(), tssm.state_dict().values()):
        assert torch.equal(a, b)
