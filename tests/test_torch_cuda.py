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


def test_scan_forward_kernel_refuses_inputs_that_need_grad():
    """No backward kernel yet: a differentiable call must not silently drop
    its gradient."""
    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    consts = fused_step.prepare(ssm)  # built with grad: its weights require it
    x0 = torch.zeros((2, 2, 128), device=dev)
    a0 = torch.zeros((2, 128), device=dev)
    coef = torch.ones((3, 2, 9), device=dev)
    with pytest.raises(RuntimeError, match="no_grad"):
        fused_step.scan_forward(x0, a0, coef, consts, seed=(1, 2))
