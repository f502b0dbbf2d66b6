"""SVO's GRU backward proposal (smc.qb_rnn) in the port against `psvo_tpu`.

The reference summarizes y_{t:T} with a GRU run backwards over the
observations (`networks.init_gru` / `gru_step`, `SSM.backward_rnn_summaries`)
and feeds the summary h_t to q_b beside x_{t+1} and y_t
(`objectives._svo_backward`, objectives.py:290-303). Such a model never
enters the reference's SVO kernel, so its sweep is the lax.scan body; the
port's counterpart is `objectives._svo_scan`.

Small sizes: B = 8, K = 128, M = 8, T = 5, hidden (16, 16) (GRU width 16).
The same parameters reach both packages through `bridge.load_numpy_params`,
the same noise through `tests/_torch_port.svo_noise`. The GRU cell is held
to 1e-6, the summaries to 1e-5, the objective's values to 2e-4 and every
gradient leaf (the GRU's included) to rtol 5e-3 / atol 5e-4: the
tolerances of `tests/test_torch_svo.py`.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import infer as jinfer
from psvo_tpu import networks as jnet
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu_torch import bridge
from psvo_tpu_torch import cli as tcli
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import networks as tnet
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import svo
from psvo_tpu_torch.utils.checkpoint import Checkpointer
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, small_configs, svo_noise,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K, M, T = 8, 128, 8, 5


def _configs(datatype="lorenz63", hidden=(16, 16), m=M):
    jcfg, tcfg = small_configs(objective="svo", datatype=datatype, hidden=hidden, t=T,
                               n_smoothing_particles=m, qb_rnn=True)
    return dataclasses.replace(jcfg, use_pallas=False), tcfg


def _dy(datatype):
    return 3 if datatype == "lorenz63" else 2


@pytest.mark.parametrize("din, dh", [(3, 16), (2, 8)])
def test_gru_cell_matches_reference(din, dh):
    """The port's GRU cell against `networks.gru_step` on the reference's
    own `init_gru` parameters, with random biases so every term shows."""
    key = jax.random.key(din * 10 + dh)
    params = jnet.init_gru(key, din, dh)
    rng = np.random.default_rng(0)
    params = {g: (np.asarray(w), rng.standard_normal(dh).astype(np.float32))
              for g, (w, _) in params.items()}
    cell = tnet.GRU(din, dh)
    with torch.no_grad():
        for g, (w, b) in cell.gates().items():
            w.copy_(torch.tensor(params[g][0]))
            b.copy_(torch.tensor(params[g][1]))
    h = rng.standard_normal((4, 5, dh)).astype(np.float32)
    x = rng.standard_normal((4, 5, din)).astype(np.float32)
    want = jnet.gru_step({g: tuple(map(jnp.asarray, v)) for g, v in params.items()},
                         jnp.asarray(h), jnp.asarray(x))
    got = tnet.gru_step(cell, torch.from_numpy(h), torch.from_numpy(x))
    assert got.shape == (4, 5, dh)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_qb_rnn_model_has_the_gru_and_the_widened_qb_input():
    """The SSM builds with the GRU (input Dy, width the qb trunk's first
    hidden size), the qb head reads Dx + Dy + H, and `init` draws the GRU
    last, so a model without it keeps its draws."""
    _, tcfg = _configs()
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert ssm.qb_rnn_dim == 16
    assert ssm.gru.z_w.shape == (3 + 16, 16) and ssm.gru.h_b.shape == (16,)
    assert ssm.heads["qb"].weights[0].shape == (3 + 3 + 16, 16)
    assert all(float(w.detach().abs().sum()) > 0 for w, _ in ssm.gru.gates().values())
    plain_cfg = dataclasses.replace(tcfg, smc=dataclasses.replace(tcfg.smc, qb_rnn=False))
    plain = init_ssm(plain_cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not hasattr(plain, "gru")
    for name in ("q0", "q1", "q2", "f", "g"):
        for a, b in zip(plain.heads[name].parameters(), ssm.heads[name].parameters()):
            assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="h_t"):
        ssm.backward_propose(torch.zeros(2, 3), torch.zeros(2, 3))
    flat = dataclasses.replace(tcfg).with_nets(qb=dataclasses.replace(tcfg.net("qb"), hidden=()))
    with pytest.raises(ValueError, match="hidden"):
        SSM(flat)


@pytest.mark.parametrize("datatype", ["lorenz63", "fhn"])
def test_backward_rnn_summaries_match_reference(datatype):
    """h_t = GRU(h_{t+1}, y_t) from h = 0, [T, B, H], against the reference's
    on the same parameters to 1e-5; a change in the last observation moves
    every h_t (h_t has consumed y_{t:T}), as tests/test_smc.py:303 checks."""
    jcfg, tcfg = _configs(datatype)
    jssm, params, tssm = models(jcfg, tcfg)
    dy = _dy(datatype)
    ys = observations(B, T, dy=dy, seed=4)
    ys_tm = np.swapaxes(ys, 0, 1)
    want = jssm.backward_rnn_summaries(params, jnp.asarray(ys_tm))
    got = tssm.backward_rnn_summaries(torch.from_numpy(ys_tm))
    assert got.shape == (T, B, tssm.qb_rnn_dim) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    moved = ys_tm.copy()
    moved[-1] += 1.0
    got2 = tssm.backward_rnn_summaries(torch.from_numpy(moved))
    for t in range(T):
        assert not torch.allclose(got[t], got2[t]), t


@pytest.mark.parametrize("datatype, hidden, m", [("lorenz63", (16, 16), 8),
                                                 ("fhn", (16,), 4)])
def test_svo_with_qb_rnn_matches_reference(datatype, hidden, m):
    """The SVO objective with the GRU against `jax.value_and_grad` of the
    reference's (its lax.scan body) on the same noise: the loss, the
    ELBO, the smoothed paths and the metrics to 2e-4, every gradient leaf,
    the GRU's included, at rtol 5e-3 / atol 5e-4, and the GRU's gradient
    not zero. The port takes its eager q_b sweep, not K12/K13's class."""
    jcfg, tcfg = _configs(datatype, hidden, m)
    jssm, params, tssm = models(jcfg, tcfg)
    assert not svo.usable(tssm, m)
    dy = _dy(datatype)
    ys = observations(B, T, dy=dy, seed=5)
    key = jax.random.key(13)

    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    (want_loss, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    plain = (svo.svo_sweep_forward_reference.calls, svo.svo_sweep_backward_reference.calls)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys),
                                       noise=svo_noise(key, B, T, dy, K, m))
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert got.smoothed.shape == want.smoothed.shape == (T, B, m, dy)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for name in ("elbo_svo", "log_z_fwd"):
        assert_close(got.metrics[name].detach(), want.metrics[name], _TOL)
    for p in tssm.parameters():
        p.grad = None
    got.loss.backward()
    grads = bridge.grads_to_numpy(tssm)
    assert "qb_rnn" in grads and "qb_rnn" in want_grads
    assert_grads_close(grads, want_grads, _RTOL, _ATOL)
    assert sum(float(np.abs(a).sum()) for a in jax.tree_util.tree_leaves(grads["qb_rnn"])) > 0
    assert (svo.svo_sweep_forward_reference.calls,
            svo.svo_sweep_backward_reference.calls) == plain


def test_qb_rnn_bridge_round_trip_and_checkpoint(tmp_path):
    """The reference's params tree with "qb_rnn" loads into the port and comes
    back bit-equal; a flat .npz snapshot keyed by keystr paths loads the GRU
    too; a tree without "qb_rnn" is refused for a GRU model; a checkpoint of
    a GRU model restores bit-equal."""
    jcfg, tcfg = _configs()
    _, params, tssm = models(jcfg, tcfg, seed=3)
    want = jax.tree_util.tree_map(np.asarray, params)
    got = bridge.params_to_numpy(tssm)
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)
    assert tree_w == tree_g
    for (path, a), b in zip(flat_w, flat_g):
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
    npz = tmp_path / "params.npz"
    np.savez(npz, **{jax.tree_util.keystr(p): a for p, a in flat_w})
    fresh = bridge.load_params_npz(SSM(tcfg), npz)
    for a, b in zip(fresh.parameters(), tssm.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="params keys"):
        bridge.load_numpy_params(SSM(tcfg), {k: v for k, v in want.items() if k != "qb_rnn"})

    opt = ttrain.make_optimizer(tcfg)
    state = ttrain.TrainState(tssm, opt.init(list(tssm.parameters())),
                              torch.Generator().manual_seed(5), step=3)
    ckpt = Checkpointer(tmp_path / "ckpt", "hash")
    ckpt.save(state)
    other = init_ssm(tcfg, torch.Generator().manual_seed(9), device="cpu")
    assert not torch.equal(other.gru.z_w, tssm.gru.z_w)
    back = ckpt.restore(ttrain.TrainState(other, opt.init(list(other.parameters())),
                                          torch.Generator().manual_seed(0)))
    assert back.step == 3
    for (n, a), b in zip(other.state_dict().items(), tssm.state_dict().values()):
        assert torch.equal(a, b), n


def test_qb_rnn_smooth_posterior_matches_reference():
    """`smooth_posterior(method="svo")` on a GRU model against the
    reference's `infer.smooth_posterior` on the same noise, to 2e-4."""
    jcfg, tcfg = _configs()
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, T, dy=3, seed=8)
    key = jax.random.key(23)
    want = jinfer.smooth_posterior(jssm, params, ys, jcfg, key, method="svo")
    got = tinfer.smooth_posterior(tssm, torch.from_numpy(ys), tcfg, method="svo",
                                  noise=svo_noise(key, B, T, 3, K, M))
    assert got.shape == want.shape == (B, M, T, 3)
    assert_close(got, want, _TOL)


def test_cli_trains_and_resumes_a_qb_rnn_model(tmp_path):
    """`--set smc.qb_rnn=true` reaches the SSM through the CLI: the run's
    params.json says so, the checkpoint holds the GRU, the history is finite,
    and a resume continues from the checkpoint."""
    sets = ["smc.qb_rnn=true", "data.n_train=8", "data.n_test=3", "data.t_steps=6",
            "smc.n_particles=32", "train.batch_size=4", "train.mse_k_steps=2",
            "train.steps_per_call=2", "train.eval_every=2", "train.save_every=2"]

    def run(root, *extra, steps):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tcli.main(["train", "--preset", "lorenz63_svo_k256", "--device", "cpu",
                            "--steps", str(steps), "--results-root", str(root),
                            *[a for s in sets for a in ("--set", s)], *extra])
        text = out.getvalue()
        path = next(line.split(": ", 1)[1] for line in text.splitlines()
                    if line.startswith("results: "))
        return rc, text, path

    rc, _, path = run(tmp_path / "runs", steps=2)
    assert rc == 0
    assert json.loads(open(os.path.join(path, "params.json")).read())["smc"]["qb_rnn"] is True
    saved = torch.load(os.path.join(path, "checkpoints", "2.pt"), weights_only=True)
    assert "gru.z_w" in saved["params"]
    history = json.loads(open(os.path.join(path, "history.json")).read())
    assert history and all(np.isfinite(r["test_elbo"]) for r in history)
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(path, "checkpoints"), ckpt)
    rc, text, _ = run(tmp_path / "runs", "--resume", str(ckpt), steps=4)
    assert rc == 0 and "resumed from step 2" in text
