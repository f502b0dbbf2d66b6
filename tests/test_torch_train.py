"""The torch port's FIVO train step against the JAX reference.

Both packages run the same model (params bridged) on the same observations
with the same noise, at a small size (B <= 8, K = 128, T <= 8, hidden
(16, 16)). Gradients are compared leaf by leaf through
`bridge.grads_to_numpy` at rtol=5e-3, atol=5e-4, the tolerance of the
reference's own fused-vs-unfused gradient test
(tests/test_pallas_step.py::test_fused_gradients_match_unfused); the
optimizer is held to optax to 1e-6.

The plain filter body (autograd through the step loop) is held to
`jax.grad` through the reference's plain jnp scan (`use_pallas=False`:
the Pallas resampling VJP has no CPU lowering outside interpret mode). The
kernel path's plain versions (`fused_step.ScanForward` on CPU tensors: `scan_forward_reference`
forward, `scan_backward_reference` backward) are held to `jax.grad` through
the reference's whole-scan Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psvo_tpu import smc as jsmc
from psvo_tpu import train as jtrain
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample, pallas_step
from psvo_tpu_torch import bridge
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.config import PRESETS
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.ops import fused_step
from psvo_tpu_torch.utils.rng import run_generator
from tests._torch_port import assert_close, key_noise, models, observations, small_configs, to_torch

torch.set_num_threads(1)

_RTOL, _ATOL = 5e-3, 5e-4


def _assert_grads_close(got_tree, want_tree):
    flat_want, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_got = jax.tree_util.tree_leaves(got_tree)
    assert len(flat_got) == len(flat_want)
    for (path, want), got in zip(flat_want, flat_got):
        np.testing.assert_allclose(got, np.asarray(want), rtol=_RTOL, atol=_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def _backward(tssm, loss):
    for p in tssm.parameters():
        p.grad = None
    loss.backward()
    return bridge.grads_to_numpy(tssm)


@pytest.mark.parametrize("use_2q", [True, False])
def test_plain_path_gradients_match_reference(use_2q):
    """forward_filter with the noise hook (the plain step body, autograd) against
    jax.grad of −mean(log Z) through the reference's plain scan."""
    jcfg, tcfg = small_configs(t=6, use_2q=use_2q)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    ys = observations(4, 6, seed=7)
    noise = key_noise(jax.random.key(8), 4, 6, 2, 128)

    def loss(p):
        return -jnp.mean(jsmc.forward_filter(jssm, p, None, ys, jcfg.smc, noise=noise).log_z)

    want = jax.grad(loss)(params)
    fwd = tsmc.forward_filter(tssm, None, torch.from_numpy(ys), tcfg.smc, noise=to_torch(noise))
    _assert_grads_close(_backward(tssm, -torch.mean(fwd.log_z)), want)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_step, "_INTERPRET", True)
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)


def _fused_loss(fwd, cache, mean):
    """−mean(log Z) plus small terms on every other output, so that each
    cotangent the kernels honour (x_last, logw_last, and under cache the
    particle and weight histories) or drop (ESS, filtered means) is live."""
    loss = -mean(fwd.log_z) + 1e-2 * mean(fwd.x_last) + 1e-3 * mean(fwd.logw_last)
    loss = loss + 1e-3 * mean(fwd.ess) + 1e-2 * mean(fwd.filtered_means)
    if cache:
        loss = loss + 1e-2 * mean(fwd.xs * fwd.xs) + 1e-3 * mean(fwd.logws)
    return loss


@pytest.mark.parametrize("cache", [False, True])
def test_kernel_path_gradients_match_reference_fused(_interpret, cache):
    """ScanForward on CPU tensors (scan_forward_reference + scan_backward_reference)
    against jax.grad through the reference's whole-scan forward and backward
    Pallas kernels in interpret mode, on the noise the reference derives from
    the key (interpret mode keeps the streams). Each plain version runs once
    and no kernel launches."""
    jcfg, tcfg = small_configs(t=5, kernel_rng=True)
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(8, 5, seed=3)
    key = jax.random.key(11)

    def loss(p):
        fwd = jsmc._forward_filter_fused(jssm, p, key, jnp.asarray(ys), jcfg.smc, cache=cache,
                                         encoder_inputs=None)
        return _fused_loss(fwd, cache, jnp.mean)

    want = jax.grad(loss)(params)
    calls = (fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls)
    launches = (fused_step.scan_forward.launches, fused_step.scan_backward.launches)
    fwd = tsmc._forward_filter_fused(tssm, None, torch.from_numpy(ys), tcfg.smc, cache=cache,
                                     streams=to_torch(key_noise(key, 8, 5, 2, 128)))
    got = _backward(tssm, _fused_loss(fwd, cache, torch.mean))
    assert (fused_step.scan_forward_reference.calls,
            fused_step.scan_backward_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert (fused_step.scan_forward.launches, fused_step.scan_backward.launches) == launches
    _assert_grads_close(got, want)


def test_cpu_train_step_runs_each_plain_version_once():
    """The kernel class on CPU tensors with in-kernel RNG: one train step runs
    the forward and backward plain versions once each, replays K2's plain
    streams in both, and launches no kernel."""
    _, tcfg = small_configs(t=4, kernel_rng=True)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    before = [fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls,
              fused_step.stream_noise_reference.calls]
    launches = [f.launches for f in (fused_step.scan_forward, fused_step.scan_backward,
                                     fused_step.stream_noise, fused_step.ancestor_indices)]
    metrics = step(torch.Generator().manual_seed(1), torch.from_numpy(observations(2, 4)))
    after = [fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls,
             fused_step.stream_noise_reference.calls]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]
    assert launches == [f.launches for f in (fused_step.scan_forward, fused_step.scan_backward,
                                             fused_step.stream_noise, fused_step.ancestor_indices)]
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def _grad_sequence(shapes, rng):
    """Gradients for 8 steps, then 102 steps with a NaN in one leaf: one NaN
    step, one inf step, one step above clip_norm, and past 100 consecutive
    non-finite steps the update that zero_nans lets through."""
    seq = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(8)]
    seq[2][0].flat[0] = np.nan
    seq[3] = [g * 50.0 for g in seq[3]]  # global norm far above clip_norm = 10
    seq[5][1].flat[-1] = np.inf
    for _ in range(102):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        g[1].flat[0] = np.nan
        seq.append(g)
    return seq


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_optimizer_matches_optax(schedule):
    jcfg, tcfg = small_configs()
    train = dict(lr=3e-3, lr_schedule=schedule, n_steps=6, clip_norm=10.0)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **train))
    tcfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, **train))
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j_opt = jtrain.make_optimizer(jcfg)
    j_params = [jnp.asarray(a) for a in init]
    j_state = j_opt.init(j_params)
    t_opt = ttrain.make_optimizer(tcfg)
    t_params = [torch.tensor(a) for a in init]
    t_state = t_opt.init(t_params)

    @jax.jit
    def j_step(grads, state, params):
        updates, state = j_opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for i, grads in enumerate(_grad_sequence(shapes, rng)):
        j_params, j_state = j_step([jnp.asarray(g) for g in grads], j_state, j_params)
        t_opt.update(t_params, [torch.tensor(g) for g in grads], t_state)
        for got, want in zip(t_params, j_params):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i}")
    # two of the first 8 steps skipped; the last two of the NaN run forced through
    assert int(t_state.count) == 8 - 2 + 2


def test_train_step_matches_reference():
    """One train step with the noise hook: the same loss and raw-gradient norm
    as the reference's value_and_grad on the same noise."""
    jcfg, tcfg = small_configs(t=8)
    jcfg = dataclasses.replace(jcfg, use_pallas=False)  # the reference's plain scan
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(4, 8, seed=2)
    key = jax.random.key(9)
    # the objective splits the key before the filter draws its noise
    noise = to_torch(key_noise(jax.random.split(key)[0], 4, 8, 2, 128))

    def loss(p):
        return j_make_objective(jssm, jcfg)(p, key, ys).loss

    want_loss, want_grads = jax.value_and_grad(loss)(params)
    step = ttrain.make_train_step(tssm, tcfg, ttrain.make_optimizer(tcfg))
    metrics = step(None, torch.from_numpy(ys), noise=noise)
    assert_close(metrics["loss"], want_loss, _RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(want_grads)),
                               rtol=_RTOL)
    assert int(step.opt_state.count) == 1
    assert not np.array_equal(bridge.params_to_numpy(tssm)["q1"]["mean"][0],
                              np.asarray(params["q1"]["mean"][0]))


def test_steps_per_call_equals_single_steps():
    """steps_per_call = 3 on one seeded generator is bit-identical to three
    single calls, as tests/test_train.py holds for the reference."""
    _, tcfg = small_configs(t=4, kernel_rng=True)
    ys = torch.from_numpy(np.stack([observations(2, 4, seed=s) for s in range(3)]))
    results = {}
    for n in (1, 3):
        cfg = dataclasses.replace(tcfg, train=dataclasses.replace(tcfg.train, steps_per_call=n))
        tssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = ttrain.make_train_step(tssm, cfg, ttrain.make_optimizer(cfg))
        gen = torch.Generator().manual_seed(4)
        if n == 1:
            metrics = [step(gen, ys[i]) for i in range(3)][-1]
        else:
            metrics = step(gen, ys)
        results[n] = (bridge.params_to_numpy(tssm), metrics)
    for a, b in zip(jax.tree_util.tree_leaves(results[1][0]),
                    jax.tree_util.tree_leaves(results[3][0])):
        np.testing.assert_array_equal(a, b)
    for name, v in results[1][1].items():
        assert torch.equal(v, results[3][1][name]), name
    with pytest.raises(ValueError, match="steps_per_call"):
        step(torch.Generator().manual_seed(4), ys[:2])


def test_entry_points_default_to_the_card():
    """init_ssm and run_generator put their result on the card unless the
    caller asks for the CPU; without a card they raise, never fall back."""
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    if torch.cuda.is_available():
        assert next(init_ssm(cfg, torch.Generator().manual_seed(0)).parameters()).is_cuda
        assert run_generator(cfg).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            init_ssm(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError):
            run_generator(cfg)
    assert next(init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu").parameters()).device.type == "cpu"
    assert run_generator(cfg, device="cpu").device.type == "cpu"
