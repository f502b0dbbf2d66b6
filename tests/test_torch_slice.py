"""The torch port's forward FIVO slice against the JAX reference.

Both packages run the same model (params bridged) on the same observations
with the same noise — the reference's key-derived draws, handed to the port
through the `noise` hook — at a small size (B <= 8, K = 128, T <= 8, hidden
(16, 16)). Tolerances are those of the reference's own fused-vs-unfused
tests (tests/test_pallas_step.py): 2e-4 on log Z, the increments, the
filtered means and the particles, 2e-3 on ESS.

The plain filter body is held to the reference's plain scan; the kernel's
plain version (`fused_step.scan_forward_reference`, what `scan_forward`
runs on CPU tensors) to the reference's whole-scan Pallas kernel in
interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from psvo_tpu import infer as jinfer
from psvo_tpu import smc as jsmc
from psvo_tpu import train as jtrain
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import infer as tinfer
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import fused_step
from tests._torch_port import assert_close, key_noise, models, observations, small_configs, to_torch

torch.set_num_threads(1)

_FIELDS_2E4 = ("log_z", "increments", "filtered_means", "x_last", "logw_last")


def _compare_filter(got, want, cache):
    for f in _FIELDS_2E4 + (("xs", "logws") if cache else ()):
        assert_close(getattr(got, f).detach(), getattr(want, f), 2e-4)
    assert_close(got.ess.detach(), want.ess, 2e-3)


@pytest.mark.parametrize(
    "objective, resampling, cache",
    [("fivo", "systematic", True), ("fivo", "multinomial", False), ("iwae", "none", True)],
)
def test_plain_forward_filter_matches_reference(objective, resampling, cache):
    jcfg, tcfg = small_configs(objective=objective, resampling=resampling, t=7)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(4, 7)
    noise = key_noise(jax.random.key(5), 4, 7, 2, 128, resampling)
    want = jsmc.forward_filter(jssm, params, None, ys, jcfg.smc, cache=cache, noise=noise)
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=cache,
                                  noise=to_torch(noise))
    _compare_filter(got, want, cache)


def test_fivo_objective_and_eval_match_reference():
    jcfg, tcfg = small_configs(t=8)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(4, 8, seed=2)
    key = jax.random.key(9)
    # the objective splits the key before the filter draws its noise
    noise = to_torch(key_noise(jax.random.split(key)[0], 4, 8, 2, 128))
    want = j_make_objective(jssm, jcfg)(params, key, ys)
    with torch.no_grad():
        got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert_close(got.loss, want.loss, 2e-4)
    assert_close(got.elbo, want.elbo, 2e-4)
    for name in ("log_z_fwd", "ess_mean", "ess_min"):
        assert_close(got.metrics[name], want.metrics[name], 2e-3)

    want_m = jtrain.make_eval_step(jssm, jcfg)(params, key, ys)
    got_m = ttrain.make_eval_step(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    assert set(got_m) == set(want_m)
    for name in ("elbo", "mse_k", "r2_k"):
        assert_close(got_m[name], want_m[name], 2e-4)


def test_filter_posterior_matches_reference():
    jcfg, tcfg = small_configs(t=4)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(3, 4, seed=4)
    key = jax.random.key(21)
    noise = to_torch(key_noise(key, 3, 4, 2, 128))
    want = jinfer.filter_posterior(jssm, params, ys, jcfg, key, return_particles=True)
    got = tinfer.filter_posterior(tssm, torch.from_numpy(ys), tcfg, return_particles=True,
                                  noise=noise)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert_close(a, b, 2e-4)
    means = tinfer.filter_posterior(tssm, torch.from_numpy(ys), tcfg, noise=noise)
    assert_close(means, want[0], 2e-4)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


@pytest.mark.parametrize("cache", [True, False])
def test_kernel_plain_version_matches_reference_fused(_interpret, cache):
    """scan_forward_reference (through the port's fused path) against the
    reference's whole-scan kernel in interpret mode, on the noise the
    reference derives from the key (interpret mode keeps the streams)."""
    jcfg, tcfg = small_configs(t=5, kernel_rng=True)
    jssm, params, tssm = models(jcfg, tcfg)
    assert pallas_step.usable(jssm, jcfg.smc, 8) and fused_step.usable(tssm, tcfg.smc)
    ys = observations(8, 5, seed=3)
    key = jax.random.key(11)
    want = jsmc._forward_filter_fused(jssm, params, key, jnp.asarray(ys), jcfg.smc,
                                      cache=cache, encoder_inputs=None)
    calls = fused_step.scan_forward_reference.calls
    with torch.no_grad():
        got = tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc,
                                         cache=cache, streams=to_torch(key_noise(key, 8, 5, 2, 128)))
    assert fused_step.scan_forward_reference.calls == calls + 1
    _compare_filter(got, want, cache)


def test_cpu_dispatch_and_in_kernel_rng_replay():
    """On CPU tensors the kernel class runs the kernel's plain version, with
    cfg.kernel_rng replaying the plain Philox streams; the result equals the
    plain step body fed those same streams."""
    jcfg, tcfg = small_configs(t=5, kernel_rng=True)
    _, _, tssm = models(jcfg, tcfg)
    ys = torch.from_numpy(observations(4, 5, seed=6))
    gen = torch.Generator().manual_seed(2)
    ref_calls = fused_step.scan_forward_reference.calls
    noise_calls = fused_step.stream_noise_reference.calls
    launches = fused_step.scan_forward.launches
    with torch.no_grad():
        got = tsmc.forward_filter(tssm, gen, ys, tcfg.smc, cache=True)
    assert fused_step.scan_forward_reference.calls == ref_calls + 1
    assert fused_step.stream_noise_reference.calls == noise_calls + 1
    assert fused_step.scan_forward.launches == launches  # no kernel on CPU

    # replay: the same generator draws, then the seed's streams
    gen = torch.Generator().manual_seed(2)
    eps0 = torch.randn((4, 2, 128), generator=gen)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen))
    eps, u0 = fused_step.stream_noise_reference(seed, 4, 4, 2, 128)
    noise = (eps0, eps, fused_step.systematic_positions(u0, 128))
    with torch.no_grad():
        want = tsmc.forward_filter(tssm, None, ys, tcfg.smc, cache=True, noise=noise)
    _compare_filter(got, want, cache=True)

    # multinomial resampling is in the kernel class, on streamed positions
    # (no K2 replay); outside it (ESS-adaptive) the plain body runs
    _, multi_cfg = small_configs(t=5, resampling="multinomial", kernel_rng=True)
    calls = fused_step.scan_forward_reference.calls
    noise_calls = fused_step.stream_noise_reference.calls
    with torch.no_grad():
        tsmc.forward_filter(tssm, torch.Generator().manual_seed(0), ys, multi_cfg.smc)
    assert fused_step.scan_forward_reference.calls == calls + 1
    assert fused_step.stream_noise_reference.calls == noise_calls
    _, plain_cfg = small_configs(t=5, ess_threshold=0.5)
    calls = fused_step.scan_forward_reference.calls
    with torch.no_grad():
        tsmc.forward_filter(tssm, torch.Generator().manual_seed(0), ys, plain_cfg.smc)
    assert fused_step.scan_forward_reference.calls == calls


def test_preset_is_in_the_kernel_class_and_unported_modes_raise():
    from psvo_tpu_torch.config import PRESETS
    from psvo_tpu_torch.models.ssm import SSM

    for name in ("fhn_fivo_k1024_bench", "lorenz63_psvo_k1024", "fhn_fivo_controls"):
        cfg = PRESETS[name]
        assert fused_step.usable(SSM(cfg), cfg.smc), name
    for name in ("fhn_fivo_tril", "fhn_fivo_dirac", "fhn_fivo_known_dynamics"):
        cfg = PRESETS[name]  # ported: built, and outside the kernel class
        assert not fused_step.usable(SSM(cfg), cfg.smc), name
    qb_rnn = PRESETS["lorenz63_svo_k256"]
    qb_rnn = dataclasses.replace(qb_rnn, smc=dataclasses.replace(qb_rnn.smc, qb_rnn=True))
    rnn = SSM(qb_rnn)  # ported: the GRU on y (width 64) and the qb head on [x; y; h]
    assert rnn.gru.z_w.shape == (3 + 64, 64)
    assert rnn.heads["qb"].weights[0].shape == (3 + 3 + 64, 64)
    assert fused_step.usable(rnn, qb_rnn.smc)  # its forward stays in K1's class
    jcfg, tcfg = small_configs(use_stop_gradient=False)
    _, _, tssm = models(jcfg, tcfg)
    with pytest.raises(ValueError, match="multinomial"):
        t_make_objective(tssm, tcfg)
    # segmented PSVO is ported, with controls too: the objective builds
    _, seg_cfg = small_configs(objective="psvo", ffbsi_segments=2)
    seg_cfg = dataclasses.replace(seg_cfg, data=dataclasses.replace(seg_cfg.data, di=1))
    assert callable(t_make_objective(SSM(seg_cfg), seg_cfg))
