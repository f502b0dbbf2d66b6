"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked `cuda` and skips without a CUDA device. The
machine with the card has no JAX, so this file imports none; run it there
without the suite's conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from psvo_tpu_torch.config import PRESETS, NetConfig
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.ops import fused_step

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weight_rows(k, dev):
    """Log-weight rows with ties, zero weights, floors and a dominant particle."""
    i = torch.arange(k, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    return torch.stack([
        torch.randn(k, generator=g, device=dev) * 3,
        torch.zeros(k, device=dev),
        -torch.randint(0, 3, (k,), generator=g, device=dev).float(),
        torch.where(i % 3 == 0, 0.0, -1e30),
        torch.where(i == k // 3, 0.0, -50.0),
        torch.linspace(-100.0, 0.0, k, device=dev),
    ]).contiguous()


def test_ancestor_indices_kernel_matches_plain():
    dev = _cuda()
    logw = _weight_rows(1024, dev)
    u0 = torch.tensor([0.0, 0.5, 0.25, 0.99999994, 0.3, 0.7], device=dev)
    before = fused_step.ancestor_indices.launches
    got = fused_step.ancestor_indices(logw, u0)
    assert fused_step.ancestor_indices.launches == before + 1
    assert torch.equal(got, fused_step.ancestor_indices_reference(logw, u0))


def test_stream_noise_kernel_is_bit_equal_to_plain_philox():
    dev = _cuda()
    got = fused_step.stream_noise((3, 4), 7, 4, 2, 512, dev)
    want = fused_step.stream_noise_reference((3, 4), 7, 4, 2, 512, dev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rng", [False, True])
def test_scan_forward_kernel_matches_plain(rng):
    dev = _cuda()
    net = NetConfig(hidden=(16, 16))
    cfg = PRESETS["fhn_fivo_k1024_bench"].with_nets(
        q0=net, q1=net, q2=net, f=net, qb=net, g=dataclasses.replace(net, sigma_init=0.5))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t1 = 4, 128, 5
    x0 = torch.randn((b, 2, k), generator=g, device=dev)
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, 9), generator=g, device=dev) + 0.1
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        if rng:
            eps, u0 = fused_step.stream_noise((5, 6), t1, b, 2, k, dev)
            pos = fused_step.systematic_positions(u0, k)
            got = fused_step.scan_forward(x0, a0, coef, consts, seed=(5, 6), cache=True)
        else:
            eps = torch.randn((t1, b, 2, k), generator=g, device=dev)
            pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
            got = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True)
        want = fused_step.scan_forward_reference(x0, a0, coef, consts, eps, pos, cache=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


def test_cuda_tensor_outside_the_kernel_class_raises():
    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.zeros((2, 5, 2), device=dev)
    from psvo_tpu_torch.smc import forward_filter

    multinomial = dataclasses.replace(cfg.smc, resampling="multinomial")
    with pytest.raises(NotImplementedError):
        forward_filter(ssm, torch.Generator(device=dev), ys, multinomial)


def _small_cfg(**smc):
    net = NetConfig(hidden=(16, 16))
    cfg = PRESETS["fhn_fivo_k1024_bench"].with_nets(
        q0=net, q1=net, q2=net, f=net, qb=net, g=dataclasses.replace(net, sigma_init=0.5))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=6),
                              smc=dataclasses.replace(cfg.smc, n_particles=128, **smc))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, steps_per_call=1))


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("rng", [False, True])
def test_scan_backward_kernel_matches_plain(rng):
    """K4 against scan_backward_reference on the residuals of one K1 run (so no
    ancestor can flip), with every cotangent live; scan_forward called
    directly on inputs that need a gradient still refuses."""
    dev = _cuda()
    cfg = _small_cfg()
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t1 = 4, 128, 5
    x0 = torch.randn((b, 2, k), generator=g, device=dev)
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, 9), generator=g, device=dev) + 0.1
    consts = fused_step.prepare(ssm)  # built with grad: its weights require it
    with pytest.raises(RuntimeError, match="ScanForward"):
        fused_step.scan_forward(x0, a0, coef, consts, seed=(5, 6))
    consts = {n: v.detach() if torch.is_tensor(v) else v for n, v in consts.items()}
    if rng:
        seed, noise = (5, 6), {"seed": (5, 6)}
        eps = fused_step.stream_noise(seed, t1, b, 2, k, dev)[0]
    else:
        eps = torch.randn((t1, b, 2, k), generator=g, device=dev)
        pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
        noise = {"eps": eps, "positions": pos}
    x_last, _, stats, x_all, _, idx = fused_step.scan_forward(
        x0, a0, coef, consts, cache=False, save_res=True, **noise)
    assert bool((idx[..., 1:] >= idx[..., :-1]).all())
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    cots = [torch.randn(s, generator=g, device=dev) * 0.1
            for s in (x0.shape, a0.shape, x_all.shape, (t1, b, k))]
    noise.pop("positions", None)
    got = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, *cots, **noise)
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats, *cots)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


def test_cuda_train_step_gradients_match_plain_replay():
    """One make_train_step step on the card (K1 forward, K4 backward) leaves
    the same raw gradients as the plain versions on CPU tensors replaying its
    noise: the CUDA generator's eps0 and seed, and K2's streams."""
    from psvo_tpu_torch import bridge
    from psvo_tpu_torch.smc import _forward_filter_fused
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _small_cfg()
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    launches = (fused_step.scan_forward.launches, fused_step.scan_backward.launches)
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys.to(dev))
    assert (fused_step.scan_forward.launches, fused_step.scan_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(metrics["loss"])

    gen.set_state(state)  # replay the step's draws
    eps0 = torch.randn((4, 2, 128), generator=gen, device=dev)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    eps, u0 = fused_step.stream_noise_reference(seed, 5, 4, 2, 128)
    fwd = _forward_filter_fused(ref, None, ys, cfg.smc, cache=False,
                                streams=(eps0.cpu(), eps, fused_step.systematic_positions(u0, 128)))
    (-torch.mean(fwd.log_z)).backward()
    got, want = bridge.grads_to_numpy(ssm), bridge.grads_to_numpy(ref)
    for name in want:
        for a, w in zip(_leaves(got[name]), _leaves(want[name])):
            assert _rel(torch.from_numpy(a), torch.from_numpy(w)) <= 1e-4, name


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
