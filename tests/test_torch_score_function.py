"""The full FIVO gradient (smc.use_stop_gradient=False) in the torch port,
against the JAX reference.

With multinomial resampling the reference adds the score-function term of
the resampling distribution: each step's log-prob of the chosen ancestors,
Σ_k log Ŵ_t[a_k], weighted by the stop-gradient return-to-go Σ_{s>=t} ℓ_s
(`psvo_tpu/smc.py:156-169`, `_score_surrogate` at :759-767), and the FIVO
objective puts `sur − stopgrad(sur)` into the loss
(`psvo_tpu/objectives.py:774-778`). The port's plain body keeps the
ancestors of `resampling.maybe_resample` for it (`smc._ancestor_score`) and
its objective adds the same zero-valued term.

Small sizes: B = 8, K = 128, T = 6, hidden (16, 16), FHN; the reference's
key-derived noise fed to the port through the `noise=` hook. The loss and
the surrogate to 2e-4, every gradient leaf at rtol 5e-3 / atol 5e-4, the
tolerances of tests/test_torch_slice.py.
"""

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import smc as jsmc
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample
from psvo_tpu_torch import bridge
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from tests._torch_port import (
    assert_close, assert_grads_close, key_noise, models, observations, small_configs, to_torch,
)

torch.set_num_threads(1)

B, T, K = 8, 6, 128
_RTOL, _ATOL = 5e-3, 5e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The reference's plain scan resamples through its resampling kernel:
    in interpret mode on the CPU (its whole-step and trunk kernels stay off,
    so the reference runs its plain scan, as the port's noise hook does)."""
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


def _objective(stop_gradient: bool, ess_threshold: float = 1.0):
    """(the port's ObjectiveOutput, the reference's loss, its gradient tree,
    the port's gradient tree) of one FIVO objective on the reference's draws
    from one key, multinomial resampling."""
    jcfg, tcfg = small_configs(t=T, resampling="multinomial", use_stop_gradient=stop_gradient,
                               ess_threshold=ess_threshold)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, T, seed=5)
    key = jax.random.key(13)
    # the objective splits the key before the filter draws its noise
    noise = to_torch(key_noise(jax.random.split(key)[0], B, T, 2, K, "multinomial"))
    j_obj = j_make_objective(jssm, jcfg)
    want_loss, want_grads = jax.value_and_grad(lambda p: j_obj(p, key, ys).loss)(params)
    got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    got.loss.backward()
    return got, want_loss, want_grads, bridge.grads_to_numpy(tssm)


@pytest.mark.parametrize("ess_threshold", [1.0, 0.7])
def test_full_fivo_gradient_matches_reference(ess_threshold):
    """The loss and every gradient leaf of the full FIVO gradient (resampling
    at every step, and ESS-adaptive at 0.7, whose kept rows add no score)
    against jax.value_and_grad of the reference's objective."""
    got, want_loss, want_grads, got_grads = _objective(False, ess_threshold)
    assert got.filter_result.score_surrogate is not None
    assert_close(got.loss.detach(), want_loss, 2e-4)
    assert_grads_close(got_grads, want_grads, _RTOL, _ATOL)


def test_score_surrogate_matches_reference():
    """FilterResult.score_surrogate of the plain body against the
    reference's on the same draws; None under stop-gradient, as there."""
    jcfg, tcfg = small_configs(t=T, resampling="multinomial", use_stop_gradient=False)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, T, seed=5)
    noise = key_noise(jax.random.key(3), B, T, 2, K, "multinomial")
    want = jsmc.forward_filter(jssm, params, None, ys, jcfg.smc, noise=noise)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, None, torch.from_numpy(ys), tcfg.smc,
                                  noise=to_torch(noise))
    assert got.score_surrogate.shape == (B,)
    assert_close(got.score_surrogate, want.score_surrogate, 2e-4)
    assert_close(got.log_z, want.log_z, 2e-4)
    _, stop_cfg = small_configs(t=T, resampling="multinomial")
    with torch.no_grad():
        stop = tsmc.forward_filter(tssm, None, torch.from_numpy(ys), stop_cfg.smc,
                                   noise=to_torch(noise))
    assert stop.score_surrogate is None


def test_score_term_moves_the_gradient_not_the_loss():
    """The stop-gradient run gives the same loss and another gradient (the
    reference's tests/test_smc.py:228-272 pattern): the score term has zero
    value and a gradient of its own."""
    full, full_loss, _, full_grads = _objective(False)
    stop, stop_loss, _, stop_grads = _objective(True)
    np.testing.assert_allclose(float(full.loss.detach()), float(stop.loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(full_loss), float(stop_loss), rtol=1e-6)
    flat_full = np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(full_grads)])
    flat_stop = np.concatenate([np.ravel(g) for g in jax.tree_util.tree_leaves(stop_grads)])
    rel = np.linalg.norm(flat_full - flat_stop) / np.linalg.norm(flat_stop)
    assert rel > 1e-2, rel
