"""The torch port's segmented long-T PSVO (`smc.ffbsi_segments` > 1) against
the JAX reference and against its own unsegmented path.

Small sizes only: B=8, K=128, M=8, T=9 (S=2 or 4 segments), hidden (16, 16),
Lorenz-63's Dx = Dy = 3. Values are held at rtol=atol=2e-4 and gradients at
rtol=5e-3, atol=5e-4, the tolerances of `tests/test_torch_psvo.py` (the
reference's own kernel-vs-scan tolerances).

- The objective, both bounds, against `jax.value_and_grad` of the
  reference's segmented objective (`use_pallas=False`) on the draws its key
  gives (`segmented_psvo_noise`).
- The kernel path: ScanForward per segment and FFBSiSweep per segment (K1,
  K4, K5, K6's plain versions) against the reference's fused segmented
  path, whole-scan and FFBSi Pallas kernels in interpret mode.
- The port against itself on the same draws: the segmented forward's
  log Ẑ, increments, last particles and each replayed segment are bit-equal
  to the unsegmented forward's, on both paths; the loss is bit-equal and
  every gradient leaf within rtol 1e-4, atol 1e-5 (the sums are only
  reassociated); the smoothed paths are bit-equal.
- The chunked log-joint equals the direct one (value rtol 1e-6, gradients
  rtol 1e-5, atol 1e-6, the reference's test) at T − 1 = 1024.
- The bytes autograd saves (`saved_tensors_hooks`): at S = 4 they grow with
  neither T nor K the way S = 1's do.
- Refusals: (T − 1) % S; segmented PSVO with controls runs (zero controls
  equal none).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import objectives as jobjectives
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu_torch import bridge
from psvo_tpu_torch import objectives as tobjectives
from psvo_tpu_torch import smc as tsmc
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import ffbsi, fused_step
from tests._torch_port import (
    assert_close, assert_grads_close, models, observations, psvo_interpret, segmented_psvo_noise,
    small_configs,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
B, K, M, DX, T = 8, 128, 8, 3, 9


def _configs(segments, bound="forward", t=T, **kw):
    return small_configs(objective="psvo", datatype="lorenz63", t=t, n_smoothing_particles=M,
                         psvo_bound=bound, ffbsi_segments=segments, **kw)


def _reference(jssm, jcfg, params, key, ys):
    def loss(p):
        out = j_make_objective(jssm, jcfg)(p, key, ys)
        return out.loss, out

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


def _port(tssm, tcfg, ys, noise):
    out = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    for p in tssm.parameters():
        p.grad = None
    out.loss.backward()
    return out, bridge.grads_to_numpy(tssm)


@pytest.mark.parametrize("bound, segments", [("forward", 4), ("direct", 2)])
def test_segmented_psvo_matches_reference(bound, segments):
    """The plain segmented path (the reference's `forward_filter_segmented`
    and `_ffbsi_backward_segmented` with the lax.scan bodies) on the
    reference's draws: loss, elbo, smoothed paths, metrics, every gradient
    leaf. At S = 4 the last segment sweeps a single step."""
    jcfg, tcfg = _configs(segments, bound)
    jssm, params, tssm = models(dataclasses.replace(jcfg, use_pallas=False), tcfg)
    ys = observations(B, T, dy=DX, seed=5)
    key = jax.random.key(13)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys)
    got, got_grads = _port(tssm, tcfg, ys, segmented_psvo_noise(key, B, T, DX, K, M, segments))
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.elbo.detach(), want.elbo, _TOL)
    assert got.smoothed.shape == want.smoothed.shape == (T, B, M, DX)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    for name in ("log_joint_smoothed", "elbo_psvo_direct", "log_z_fwd", "ess_mean"):
        assert_close(got.metrics[name].detach(), want.metrics[name], _TOL)
    assert_grads_close(got_grads, want_grads, _RTOL, _ATOL)


def _fused_segmented(ssm, generator, ys, cfg, n_segments, *, encoder_inputs, noise):
    """The kernel path on given streams (the hook alone would pick the plain
    body on CPU tensors, as the reference does)."""
    return tsmc._forward_filter_segmented_fused(ssm, generator, ys, cfg, n_segments,
                                                encoder_inputs=encoder_inputs, streams=noise)


def test_segmented_kernel_path_matches_reference_kernels(psvo_interpret, monkeypatch):
    """K = 128, T = 9, B = 8, S = 2, as the reference's
    `test_fused_segmented_forward_and_recompute_bit_identical` sets it up:
    the port's per-segment ScanForward and FFBSiSweep (the four kernels'
    plain versions) against the reference's `_forward_filter_segmented_fused`,
    `_recompute_segment_fused` and per-segment `run_ffbsi_scan` in
    interpret mode, under the direct bound (every cotangent live)."""
    jcfg, tcfg = _configs(2, "direct")
    jssm, params, tssm = models(jcfg, tcfg)
    ys = observations(B, T, dy=DX, seed=9)
    key = jax.random.key(17)
    (want_loss, want), want_grads = _reference(jssm, jcfg, params, key, ys)
    monkeypatch.setattr(tobjectives, "forward_filter_segmented", _fused_segmented)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    calls = [f.calls for f in plain]
    got, got_grads = _port(tssm, tcfg, ys, segmented_psvo_noise(key, B, T, DX, K, M, 2))
    # K1: 2 forward segments and 2 replays, each again in its checkpoint's
    # backward; K4 once per segment and replay; K5: 2 segments twice and the
    # t = 0 step; K6: 2 segments and t = 0
    assert [f.calls - n for f, n in zip(plain, calls)] == [8, 4, 5, 3]
    assert_close(got.loss.detach(), want_loss, _TOL)
    assert_close(got.smoothed.detach(), want.smoothed, _TOL)
    assert_close(got.metrics["log_z_fwd"].detach(), want.metrics["log_z_fwd"], _TOL)
    assert_grads_close(got_grads, want_grads, _RTOL, _ATOL)


def _streams(seed, t=T, b=B, k=K):
    g = torch.Generator().manual_seed(seed)
    u0 = torch.rand((t - 1, b), generator=g)
    return (torch.randn((b, DX, k), generator=g), torch.randn((t - 1, b, DX, k), generator=g),
            fused_step.systematic_positions(u0, k))


@pytest.mark.parametrize("path", ["kernel", "plain"])
@pytest.mark.parametrize("segments", [2, 4])
def test_segmented_forward_and_replay_bit_equal_to_unsegmented(path, segments):
    """On the same streams, the segmented forward's log Ẑ, increments, ESS,
    filtered means and last particles are the unsegmented forward's bits, and
    each replayed segment is the unsegmented cache's slice, twice over."""
    _, tcfg = _configs(segments)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.from_numpy(observations(B, T, dy=DX, seed=3))
    streams = _streams(4)
    seg_fn = (tsmc._forward_filter_segmented_fused if path == "kernel"
              else tsmc._forward_filter_segmented_plain)
    with torch.no_grad():
        if path == "kernel":
            whole = tsmc._forward_filter_fused(tssm, None, ys, tcfg.smc, cache=True,
                                               streams=streams)
        else:
            whole = tsmc.forward_filter(tssm, None, ys, tcfg.smc, cache=True, noise=streams)
        fwd, cache = seg_fn(tssm, None, ys, tcfg.smc, segments, streams=streams)
        assert cache.fused == (path == "kernel") and fwd.xs is None
        for name in ("log_z", "increments", "ess", "filtered_means", "x_last", "logw_last"):
            assert torch.equal(getattr(fwd, name), getattr(whole, name)), name
        length = (T - 1) // segments
        for s in range(segments):
            rows = slice(1 + s * length, 1 + (s + 1) * length)
            xs, logws = tsmc.recompute_segment(cache, s)
            again = tsmc.recompute_segment(cache, s)
            assert torch.equal(xs, whole.xs[rows]) and torch.equal(logws, whole.logws[rows])
            assert torch.equal(xs, again[0]) and torch.equal(logws, again[1])
            assert torch.equal(cache.seg_x[s], whole.xs[rows.start - 1])


def test_segmented_kernel_rng_seeds_each_segment():
    """Under kernel_rng each segment takes K1's two-word seed of its own from
    the run's generator (K1's counter restarts at t = 0 in every launch):
    no two segments share a seed, and each replay (K2's plain Philox on CPU
    tensors) gives the forward's bits, its last step the next segment's
    carry."""
    _, tcfg = _configs(4, kernel_rng=True)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.from_numpy(observations(2, T, dy=DX, seed=3))
    calls = fused_step.stream_noise_reference.calls
    with torch.no_grad():
        fwd, cache = tsmc.forward_filter_segmented(tssm, torch.Generator().manual_seed(2), ys,
                                                   tcfg.smc, 4)
        replays = [tsmc.recompute_segment(cache, s) for s in range(4)]
    assert cache.fused and fused_step.stream_noise_reference.calls == calls + 8
    for s in range(3):
        assert torch.equal(replays[s][0][-1], cache.seg_x[s + 1])
        assert torch.equal(replays[s][1][-1], cache.seg_logw[s + 1])
    assert torch.equal(replays[3][0][-1], fwd.x_last)
    seeds = tsmc._segment_seeds(torch.Generator().manual_seed(2), 4, True)
    assert len(set(seeds)) == 4 and all(len(w) == 2 and 0 <= min(w) and max(w) < 2**32
                                        for w in seeds)


@pytest.mark.parametrize("bound", ["forward", "direct"])
def test_segmented_objective_agrees_with_unsegmented_on_the_same_draws(bound, monkeypatch):
    """The kernel path's plain versions, S = 4 against S = 1, on the same
    streams and Gumbels: smoothed paths and the loss bit-equal (forward
    bound; the direct bound's logq sums are reassociated, 1e-5), every
    gradient leaf within rtol 1e-4, atol 1e-5."""
    monkeypatch.setattr(tobjectives, "forward_filter_segmented", _fused_segmented)

    def fused_whole(ssm, generator, ys_, cfg, *, cache, encoder_inputs, noise):
        return tsmc._forward_filter_fused(ssm, generator, ys_, cfg, cache=cache,
                                          encoder_inputs=encoder_inputs, streams=noise)

    monkeypatch.setattr(tobjectives, "forward_filter", fused_whole)
    g = torch.Generator().manual_seed(6)
    gum = tobjectives._gumbel(g, (T, B, M, K))
    noise = (*_streams(5), gum[0], gum[1:])
    ys = observations(B, T, dy=DX, seed=4)
    runs = []
    for segments in (1, 4):
        _, tcfg = _configs(segments, bound)
        tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
        runs.append(_port(tssm, tcfg, ys, noise))
    (whole, g1), (seg, g4) = runs
    assert torch.equal(seg.smoothed, whole.smoothed)
    if bound == "forward":
        assert torch.equal(seg.loss, whole.loss)
    else:
        assert_close(seg.loss.detach(), whole.loss.detach(), 1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g4), jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_chunked_log_joint_matches_direct(monkeypatch):
    """At T − 1 = 1024 (two chunks of 512) the chunked log-joint's value and
    gradients (parameters and paths) equal the direct form's; at T = 9 with
    4-step chunks (monkeypatched in both packages) it equals the
    reference's chunked form."""
    _, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=T, hidden=(8,))
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1025, 2, 2, DX), generator=g) * 5.0
    ys = torch.randn((1025, 2, DX), generator=g) * 5.0

    def run(chunk, x_):
        monkeypatch.setattr(tobjectives, "_LOGJOINT_CHUNK", chunk)
        x_ = x_.clone().requires_grad_()
        for p in tssm.parameters():
            p.grad = None
        value = tobjectives._selected_path_log_joint(tssm, x_, ys[:x_.shape[0]])
        value.sum().backward()
        return value.detach(), [x_.grad] + [p.grad for p in tssm.parameters() if p.grad is not None]

    v_direct, g_direct = run(10**9, x)
    v_chunked, g_chunked = run(512, x)
    np.testing.assert_allclose(v_chunked, v_direct, rtol=1e-6)
    assert len(g_chunked) == len(g_direct)
    for a, b in zip(g_chunked, g_direct):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    jcfg, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=T, hidden=(8,))
    jssm, params, tssm = models(jcfg, tcfg)
    monkeypatch.setattr(jobjectives, "_LOGJOINT_CHUNK", 4)
    monkeypatch.setattr(tobjectives, "_LOGJOINT_CHUNK", 4)
    xs, yt = x[:T].numpy(), ys[:T].numpy()
    want = jobjectives._selected_path_log_joint(jssm, params, xs.reshape(T, 2, 2 * DX), yt,
                                                np.zeros((T, 2, 0), np.float32))
    got = tobjectives._selected_path_log_joint(tssm, torch.from_numpy(xs), torch.from_numpy(yt))
    assert_close(got.detach(), want, 1e-5)


def _saved_bytes(segments, t, k):
    """Bytes of the tensors autograd saves for one PSVO loss (distinct
    storages), from `saved_tensors_hooks`."""
    _, tcfg = small_configs(objective="psvo", datatype="lorenz63", t=t, k=k,
                            n_smoothing_particles=4, ffbsi_segments=segments)
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.from_numpy(observations(2, t, dy=DX, seed=2))
    seen = {}

    def pack(tensor):
        if tensor.device.type == "cpu" and tensor.numel():
            seen[tensor.untyped_storage().data_ptr()] = tensor.untyped_storage().nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda tensor: tensor):
        out = t_make_objective(tssm, tcfg)(torch.Generator().manual_seed(1), ys)
    out.loss.backward()
    return sum(seen.values())


def test_segmented_saved_bytes_do_not_grow_with_t_times_k():
    """S = 1 saves the particle cache, the Gumbels and K4's and K6's
    residuals, O(T·B·K); S = 4 saves the boundary carries, O(S·B·K), and
    the sweep's paths, the log-joint's activations and the coefficient rows,
    O(T·B·M·H) and O(T·B). The part of the saved bytes that grows with T·K
    (the mixed difference over T ∈ {17, 33} and K ∈ {128, 256}) is large at
    S = 1 and, but for a scalar's storage, none at S = 4."""
    def mixed(segments):
        b = {(t, k): _saved_bytes(segments, t, k) for t in (17, 33) for k in (128, 256)}
        return b[33, 256] - b[33, 128] - b[17, 256] + b[17, 128]

    whole, seg = mixed(1), mixed(4)
    assert whole > 2 * 16 * 128 * 4 * 10, whole  # ten float32 [B, K] tensors a step at least
    assert abs(seg) < 1e-3 * whole, (seg, whole)  # a scalar's storage at most


def test_segmented_refusals():
    """(T − 1) % S != 0 raises the reference's error; segmented PSVO with
    controls is no longer refused: it runs, finite, and zero controls give
    the loss of controls=None bit for bit."""
    _, tcfg = _configs(3)  # T − 1 = 8
    tssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.from_numpy(observations(2, T, dy=DX, seed=1))
    with pytest.raises(ValueError, match="not divisible by 3 segments"):
        t_make_objective(tssm, tcfg)(torch.Generator().manual_seed(0), ys)
    _, ccfg = _configs(2)
    ccfg = dataclasses.replace(ccfg, data=dataclasses.replace(ccfg.data, di=1))
    cssm = init_ssm(ccfg, torch.Generator().manual_seed(0), device="cpu")
    ys9 = torch.from_numpy(observations(2, T, dy=DX, seed=1))
    with torch.no_grad():
        outs = [t_make_objective(cssm, ccfg)(torch.Generator().manual_seed(0), ys9, controls=u)
                for u in (torch.zeros((2, T, 1)), None)]
    assert bool(torch.isfinite(outs[0].loss)) and torch.equal(outs[0].loss, outs[1].loss)
