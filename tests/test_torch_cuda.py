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
from psvo_tpu_torch.ops import ffbsi, fused_step

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
    """Multinomial resampling is inside the whole-scan class: the filter
    launches K1 once on its streamed positions and runs no plain version.
    ESS-adaptive resampling is in the trunk class: K9 once a step, no plain
    version. With q1/f/g wider than the trunk class takes (72) it still
    raises."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.zeros((2, 5, 2), device=dev)
    from psvo_tpu_torch.smc import forward_filter

    multinomial = dataclasses.replace(cfg.smc, resampling="multinomial")
    launches, calls = fused_step.scan_forward.launches, fused_step.scan_forward_reference.calls
    with torch.no_grad():
        fwd = forward_filter(ssm, torch.Generator(device=dev), ys, multinomial)
    assert fused_step.scan_forward.launches == launches + 1
    assert fused_step.scan_forward_reference.calls == calls
    assert bool(torch.isfinite(fwd.log_z).all())
    ess = dataclasses.replace(cfg.smc, ess_threshold=0.5)
    launches, calls = trunk.trunk_forward.launches, trunk.trunk_forward_reference.calls
    with torch.no_grad():
        fwd = forward_filter(ssm, torch.Generator(device=dev), ys, ess)
    assert trunk.trunk_forward.launches == launches + 4
    assert trunk.trunk_forward_reference.calls == calls
    assert bool(torch.isfinite(fwd.log_z).all())
    net = NetConfig(hidden=(72, 72))
    wide = cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net)
    wide_ssm = init_ssm(wide, torch.Generator().manual_seed(0), device=dev)
    with pytest.raises(NotImplementedError):
        forward_filter(wide_ssm, torch.Generator(device=dev), torch.zeros((2, 5, 2), device=dev),
                       ess)


def _small_cfg(preset="fhn_fivo_k1024_bench", **smc):
    net = NetConfig(hidden=(16, 16))
    cfg = PRESETS[preset].with_nets(
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


def test_scan_kernels_match_plain_at_lorenz_dims():
    """K1 (stream mode) and K4 at Dx = Dy = 3 against their plain versions,
    with every cotangent live, the cache ones included."""
    dev = _cuda()
    cfg = _small_cfg("lorenz63_psvo_k1024")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t1 = 4, 128, 5
    x0 = torch.randn((b, 3, k), generator=g, device=dev) * 8.0
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, 13), generator=g, device=dev) + 0.1
    eps = torch.randn((t1, b, 3, k), generator=g, device=dev)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        got = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                      save_res=True)
        want = fused_step.scan_forward_reference(x0, a0, coef, consts, eps, pos, cache=True,
                                                 save_res=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
    x_last, _, stats, x_all, alpha_all, idx = got
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    cots = [torch.randn(t.shape, generator=g, device=dev) * 0.1
            for t in (x_last, a0, x_all, alpha_all)]
    k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, *cots, eps=eps)
    ref = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats, *cots)
    for a, w in zip(k4, ref):
        assert _rel(a, w) <= 1e-4
    consts_big = dict(consts, hidden=64, packed=torch.zeros(13836, device=dev))
    assert not fused_step._k4_ok(consts_big, 2048)  # shared memory: K <= 1536 at width 64
    assert fused_step._k4_ok(consts_big, 1024)


def _sweep(dev, dx, b=4, m=8, k=128, t1=9, seed=0):
    """One sweep's operands on the card: support terms of a transition with
    means near the support, normalized weights, Gumbels and anchors (the
    last step's particles m mod k)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((t1, b, dx, k), generator=g, device=dev) * 8.0
    mean = xs + torch.randn(xs.shape, generator=g, device=dev)
    scale = 0.5 + 1.5 * torch.rand(xs.shape, generator=g, device=dev)
    r = 1.0 / (scale * scale)
    c = -0.5 * (mean * mean * r).sum(2) - torch.log(scale).sum(2) - dx * 0.9189385332
    lwn = torch.log_softmax(torch.randn((t1, b, k), generator=g, device=dev) * 2.0, dim=-1)
    lg = torch.randn((t1, b, k), generator=g, device=dev)
    u = torch.rand((t1, b, m, k), generator=g, device=dev).clamp_min(1e-30)
    x_anchor = xs[-1][:, :, torch.arange(m, device=dev) % k].transpose(1, 2).contiguous()
    return [t.contiguous() for t in (x_anchor, xs, r, mean * r, c, lwn, lg, -torch.log(-torch.log(u)))]


@pytest.mark.parametrize("design", ffbsi.DESIGNS)
@pytest.mark.parametrize("dx", [2, 3])
def test_ffbsi_kernels_match_plain(dx, design):
    """K5 (each design) picks the plain version's particles (identical
    selections and paths, logp/logq to 1e-5); K6 on K5's selections matches
    the plain replay to 1e-4 relative per leaf, with all cotangents and with
    the paths' alone."""
    dev = _cuda()
    ops = _sweep(dev, dx)
    launches = (ffbsi.ffbsi_forward.launches, ffbsi.ffbsi_backward.launches)
    by_design = dict(ffbsi.ffbsi_forward.launches_by_design)
    got = ffbsi.ffbsi_forward(*ops, design=design)
    want = ffbsi.ffbsi_forward_reference(*ops)
    assert torch.equal(got[4], want[4]) and torch.equal(got[3], want[3])
    assert torch.equal(got[0], want[0])
    for a, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    x_anchor, xs, r, mr, c, lwn, lg, _ = ops
    sel, xtilde = got[4], got[3]
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in got[:4]]
    for live, needs in (((0, 1, 2, 3), (True,) * 5), ((0, 3), (False,) * 5)):
        kw = {n: cots[i] if i in live else None
              for i, n in enumerate(("d_x_first", "d_logp", "d_logq", "d_xtilde"))}
        k6 = ffbsi.ffbsi_backward(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde, needs=needs, **kw)
        ref = ffbsi.ffbsi_backward_reference(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde,
                                             needs=needs, **kw)
        for a, w in zip(k6, ref):
            assert (a is None) == (w is None)
            if a is not None:
                assert _rel(a, w) <= 1e-4
    assert (ffbsi.ffbsi_forward.launches, ffbsi.ffbsi_backward.launches) == (
        launches[0] + 1, launches[1] + 2)
    assert ffbsi.ffbsi_forward.launches_by_design == {
        d: n + (d == design) for d, n in by_design.items()}


@pytest.mark.parametrize("dx,b,m,k", [(3, 4, 8, 128), (3, 32, 16, 256), (2, 32, 16, 1000),
                                      (3, 32, 16, 4096), (3, 40, 64, 384), (2, 3, 5, 130)])
def test_ffbsi_forward_designs_agree(dx, b, m, k):
    """K5's staged design against the previous one (design="path") on the
    same operands: sel, x~, x_first and logp equal bit for bit, logq within
    1e-6 relative. The shapes reach 1, 4 and 8 paths a CTA (`k5_paths` on
    the card's SMs), the whole row staged and K = 4096 in chunks
    (`k5_chunk`), and K not a multiple of 4 (4-byte copies)."""
    dev = _cuda()
    ops = _sweep(dev, dx, b=b, m=m, k=k, t1=6, seed=k)
    staged = ffbsi.ffbsi_forward(*ops, design="staged")
    path = ffbsi.ffbsi_forward(*ops, design="path")
    for i in (4, 3, 0, 1):
        assert torch.equal(staged[i], path[i]), i
    assert float(((staged[2] - path[2]).abs() / path[2].abs()).max()) <= 1e-6


_K6_MODES = {  # live cotangents among d_x_first, d_logp, d_logq, d_xtilde; needs
    "all cotangents": ((0, 1, 2, 3), (True,) * 5),
    "paths only": ((0, 3), (False,) * 5),
    "pairs, no support wanted": ((1, 2, 3), (False,) * 5),
}


@pytest.mark.parametrize("dx", [2, 3])
@pytest.mark.parametrize("m", [1, 16, 256])
@pytest.mark.parametrize("k", [128, 1000, 8192])
def test_ffbsi_backward_staged_matches_row_and_plain(dx, m, k):
    """K6's staged design against the previous one (design="row") and the
    plain version on K5's selections: the paths alone bit-equal to the row
    design (d_xs, d_x_anchor), otherwise within 1e-5 relative L2 per leaf;
    1e-4 against the plain version; None where a leaf is not wanted; each
    design bit-equal on a relaunch; the launches counted by design. K = 8192
    takes the chunked rows, K = 1000 the 4-byte copies."""
    dev = _cuda()
    ops = _sweep(dev, dx, b=2, m=m, k=k, t1=4, seed=m + k)
    g = torch.Generator(device=dev).manual_seed(5)
    ops[0] = (torch.randn((2, m, dx), generator=g, device=dev) * 8.0).contiguous()  # M may pass K
    fwd = ffbsi.ffbsi_forward(*ops)
    x_anchor, xs, r, mr, c, lwn, lg, _ = ops
    args = (x_anchor, xs, r, mr, c, lwn, lg, fwd[4], fwd[3])
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in fwd[:4]]
    for mode, (live, needs) in _K6_MODES.items():
        kw = {n: cots[i] if i in live else None
              for i, n in enumerate(("d_x_first", "d_logp", "d_logq", "d_xtilde"))}
        before = dict(ffbsi.ffbsi_backward.launches_by_design)
        staged = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        again = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        row = ffbsi.ffbsi_backward(*args, needs=needs, design="row", **kw)
        assert ffbsi.ffbsi_backward.launches_by_design == {
            "staged": before["staged"] + 2, "row": before["row"] + 1}
        want = ffbsi.ffbsi_backward_reference(*args, needs=needs, **kw)
        for a, a2, w_row, w in zip(staged, again, row, want):
            assert (a is None) == (w is None) == (w_row is None)
            if a is None:
                continue
            assert torch.equal(a, a2)
            if mode == "paths only":
                assert torch.equal(a, w_row)
            assert _rel(a, w_row) <= 1e-5 and _rel(a, w) <= 1e-4, mode


@pytest.mark.parametrize("dx", [1, 2, 3, 40])
@pytest.mark.parametrize("k", [2, 1026, 8192])
def test_stream_noise_pair_matches_particle_and_plain(dx, k):
    """K2's pair design, bit for bit the previous one (design="particle")
    and the plain Philox; the launches counted by design."""
    dev = _cuda()
    before = dict(fused_step.stream_noise.launches_by_design)
    pair = fused_step.stream_noise((11, 12), 3, 2, dx, k, dev)
    particle = fused_step.stream_noise((11, 12), 3, 2, dx, k, dev, design="particle")
    want = fused_step.stream_noise_reference((11, 12), 3, 2, dx, k, dev)
    assert fused_step.stream_noise.launches_by_design == {
        "pair": before["pair"] + 1, "particle": before["particle"] + 1}
    for a, b, w in zip(pair, particle, want):
        assert torch.equal(a, b) and torch.equal(a, w)


def test_cuda_tensor_outside_the_k2_and_k6_classes_raises():
    dev = _cuda()
    with pytest.raises(ValueError, match="even K"):
        fused_step.stream_noise((1, 2), 2, 2, 2, 7, dev)
    ops = _sweep(dev, 3)
    fwd = ffbsi.ffbsi_forward(*ops)
    # the row design at Dx = 4 (not instantiated), the staged one past K6 wide's shared memory
    for design, dx in zip(ffbsi.K6_DESIGNS, (909, 4)):
        wide = (torch.zeros((4, 8, dx), device=dev), torch.zeros((9, 4, dx, 128), device=dev))
        with pytest.raises(ValueError, match=f"ffbsi_backward \\({design}\\): no kernel"):
            ffbsi.ffbsi_backward(*wide, *ops[2:7], fwd[4], fwd[3], design=design)
    with pytest.raises(ValueError, match="sel"):
        ffbsi.ffbsi_backward(*ops[:7], fwd[4].long(), fwd[3])


def test_cuda_tensor_outside_the_ffbsi_class_raises():
    dev = _cuda()
    ops = _sweep(dev, 3)
    # the path design at Dx = 4 (not instantiated), the staged one past K6 wide's shared memory
    for design, dx in zip(ffbsi.DESIGNS, (909, 4)):
        wide = (torch.zeros((4, 8, dx), device=dev), torch.zeros((9, 4, dx, 128), device=dev))
        with pytest.raises(ValueError, match=f"ffbsi_forward \\({design}\\): no kernel"):
            ffbsi.ffbsi_forward(*wide, *ops[2:], design=design)
    with pytest.raises(ValueError, match="gum"):
        ffbsi.ffbsi_forward(*ops[:7], ops[7][:, :, :4].contiguous())


def test_cuda_psvo_train_step_launches_the_four_kernels():
    """One PSVO train step on the card: K1, K4, K5 and K6 once each, no plain
    version, finite loss."""
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _small_cfg("lorenz63_psvo_k1024")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 1, 1]
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def _l96_cfg(hidden=16, k=128, t=6):
    """The Lorenz-96 preset cut to a small size: K, T and the trunk width."""
    net = NetConfig(hidden=(hidden, hidden))
    cfg = PRESETS["lorenz96_fivo_k8192_sharded"].with_nets(
        q0=net, q1=net, q2=net, f=net, qb=net, g=dataclasses.replace(net, sigma_init=0.5))
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t),
                               smc=dataclasses.replace(cfg.smc, n_particles=k))


def test_stream_noise_kernel_is_bit_equal_at_lorenz96_width():
    dev = _cuda()
    got = fused_step.stream_noise((3, 4), 3, 2, 40, 256, dev)
    want = fused_step.stream_noise_reference((3, 4), 3, 2, 40, 256, dev)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", [128, 4096])
def test_large_k_resample_kernels_match_plain(k):
    """K7 gives the plain version's indices (ties, zero weights, floors and a
    dominant particle included); K8 is bit-equal to the plain gather; each
    K7 design raises above its cap."""
    from psvo_tpu_torch.ops import resample_gather as rg

    dev = _cuda()
    logw = _weight_rows(k, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    u0 = torch.rand((logw.shape[0],), generator=g, device=dev)
    pos = fused_step.systematic_positions(u0, k).contiguous()
    launches = (rg.ancestor_indices_large.launches, rg.gather_particles.launches)
    idx = rg.ancestor_indices_large(logw, pos)
    assert torch.equal(idx, rg.ancestor_indices_large_reference(logw, pos))
    x = torch.randn((logw.shape[0], 40, k), generator=g, device=dev)
    assert torch.equal(rg.gather_particles(x, idx), rg.gather_particles_reference(x, idx))
    assert (rg.ancestor_indices_large.launches, rg.gather_particles.launches) == (
        launches[0] + 1, launches[1] + 1)
    for design, cap in (("cluster", rg.MAX_K), ("row", rg.ROW_MAX_K)):
        with pytest.raises(ValueError, match=f"no {design} kernel"):
            rg.ancestor_indices_large(torch.zeros((2, cap + 1), device=dev),
                                      torch.zeros((2, cap + 1), device=dev), design=design)


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("rng", [False, True])
def test_trunk_kernel_matches_plain(hidden, rng):
    """K9 against its plain version at 2e-4, with the streamed ε and with the
    in-kernel draw replayed through K2's extracted ε."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    cfg = _l96_cfg(hidden)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t = 3, 256, 4
    x_res = torch.randn((b, 40, k), generator=g, device=dev) * 3.0
    coef = torch.rand((b, 161), generator=g, device=dev) + 0.1
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        if rng:
            eps = fused_step.stream_noise((5, 6), t + 1, b, 40, k, dev)[0][t]
            got = trunk.trunk_forward(x_res, coef, consts, seed=(5, 6), t=t)
        else:
            eps = torch.randn((b, 40, k), generator=g, device=dev)
            got = trunk.trunk_forward(x_res, coef, consts, eps=eps)
        want = trunk.trunk_forward_reference(x_res, coef, consts, eps)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


def test_lorenz96_serving_launches_the_trunk_kernels():
    """filter_posterior and make_eval_step on the trunk path: K7, K8 and K9 T−1
    times per call, no plain version, finite outputs; the CPU replay of the
    same draws agrees."""
    from psvo_tpu_torch import infer, smc
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_eval_step

    dev = _cuda()
    cfg = _l96_cfg()
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 40), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward)
    plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             trunk.trunk_forward_reference, fused_step.stream_noise_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    means, xs, lws = infer.filter_posterior(ssm, ys, cfg, return_particles=True)
    metrics = make_eval_step(ssm, cfg)(torch.Generator(device=dev).manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [10, 10, 10]
    assert [f.calls for f in plain] == calls
    assert tuple(xs.shape) == (4, 6, 128, 40) and bool(torch.isfinite(means).all())
    assert torch.isfinite(metrics["elbo"]) and bool(torch.isfinite(metrics["r2_k"]).all())

    gen = torch.Generator(device=dev).manual_seed(4)
    state = gen.get_state()
    with torch.no_grad():
        got = smc.forward_filter(ssm, gen, ys, cfg.smc, cache=True)
    gen.set_state(state)  # replay the draws on the CPU
    eps0 = torch.randn((4, 40, 128), generator=gen, device=dev)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    u = smc.resampling.bulk_positions(gen, 5, 4, 128, "systematic")
    eps = fused_step.stream_noise_reference(seed, 5, 4, 40, 128)[0]
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        want = smc._forward_filter_trunk(ref, None, ys.cpu(), cfg.smc, cache=True,
                                         streams=(eps0.cpu(), eps, u.cpu()))
    torch.testing.assert_close(got.increments[:2].cpu(), want.increments[:2], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got.xs[:2].cpu(), want.xs[:2], rtol=2e-4, atol=2e-4)


def _trunk_backward_operands(hidden, rng, dev):
    """K10's operands on K9's own output at B=3, K=256, with row 1 below the
    −3e30 floor; returns (args, noise, eps)."""
    from psvo_tpu_torch.ops import trunk

    cfg = _l96_cfg(hidden)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t = 3, 256, 4
    x_res = torch.randn((b, 40, k), generator=g, device=dev) * 3.0
    coef = torch.rand((b, 161), generator=g, device=dev) + 0.1
    coef[1, 120:160] = 1e16
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        if rng:
            eps = fused_step.stream_noise((5, 6), t + 1, b, 40, k, dev)[0][t]
            noise = {"seed": (5, 6), "t": t}
        else:
            eps = torch.randn((b, 40, k), generator=g, device=dev)
            noise = {"eps": eps}
        x_new, alpha = trunk.trunk_forward(x_res, coef, consts, **noise)
    assert bool((alpha[1] == -3e30).all())
    d_x_new = torch.randn((b, 40, k), generator=g, device=dev)
    d_alpha = torch.randn((b, k), generator=g, device=dev)
    return (x_res, x_new, coef, consts, d_x_new, d_alpha), noise, eps


@pytest.mark.parametrize("design", ["tf32x3", "simt"])
@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("rng", [False, True])
def test_trunk_backward_kernel_matches_plain(hidden, rng, design):
    """K10 (the tensor-core design and the previous one) against
    trunk_backward_reference on K9's own output, per leaf to 1e-4 relative,
    with row 1 below the −3e30 floor (no α cotangent there); a second launch
    gives the same bits."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    args, noise, eps = _trunk_backward_operands(hidden, rng, dev)
    launches = trunk.trunk_backward.launches
    got = trunk.trunk_backward(*args, **noise, design=design)
    again = trunk.trunk_backward(*args, **noise, design=design)
    assert trunk.trunk_backward.launches == launches + 2
    want = trunk.trunk_backward_reference(*args[:4], eps, *args[4:])
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert _rel(a, w) <= 1e-4
    assert float(got[1][1, -1]) == 0.0 and bool((got[1][:, 120:160] == 0).all())


@pytest.mark.parametrize("hidden", [16, 32, 64])
def test_trunk_backward_designs_agree(hidden):
    """K10's tensor-core design (3xTF32) within 1e-5 relative L2 per leaf of
    the previous design (fp32 FMA), on the same operands."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    args, noise, _ = _trunk_backward_operands(hidden, True, dev)
    new = trunk.trunk_backward(*args, **noise)
    old = trunk.trunk_backward(*args, **noise, design="simt")
    for a, b in zip(new, old):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("k", [128, 2048, 8192])
def test_segment_sum_scatter_kernel_matches_plain(k):
    """K11 against the float64 plain version to 1e-6 relative on healthy rows,
    ties, floors and one dominant particle (one ancestor takes every child),
    sources with no child exactly 0, the same bits on a second launch."""
    from psvo_tpu_torch.ops import resample_gather as rg

    dev = _cuda()
    logw = _weight_rows(k, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    pos = fused_step.systematic_positions(torch.rand((logw.shape[0],), generator=gen, device=dev),
                                          k).contiguous()
    idx = rg.ancestor_indices_large(logw, pos)
    assert idx[4].unique().numel() == 1
    g = torch.randn((logw.shape[0], 40, k), generator=gen, device=dev)
    launches = rg.segment_sum_scatter.launches
    got = rg.segment_sum_scatter(g, idx)
    again = rg.segment_sum_scatter(g, idx)
    assert rg.segment_sum_scatter.launches == launches + 2
    want = rg.segment_sum_scatter_reference(g.double(), idx)
    assert torch.equal(got, again)
    assert _rel(got.double(), want) <= 1e-6
    assert bool((got[want == 0] == 0).all())


def test_cuda_tensor_outside_the_backward_kernels_raises():
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    ssm = init_ssm(_l96_cfg(), torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    x = torch.zeros((2, 40, 96), device=dev)  # K not a multiple of 64
    coef = torch.zeros((2, 161), device=dev)
    for design in trunk.DESIGNS:
        with pytest.raises(ValueError, match=f"no {design} kernel"):
            trunk.trunk_backward(x, x, coef, consts, x, torch.zeros((2, 96), device=dev), eps=x,
                                 design=design)
    with pytest.raises(ValueError, match="backward kernel"):
        trunk.TrunkForward.apply(x.requires_grad_(), coef, consts["packed"], consts["sconst"],
                                 consts, torch.zeros_like(x), None, 0)
    big = torch.zeros((1, 2, rg.MAX_K + 256), device=dev)
    with pytest.raises(NotImplementedError, match="K11's cap"):
        rg.segment_sum_scatter(big, torch.zeros((1, rg.MAX_K + 256), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="idx"):
        rg.segment_sum_scatter(big, torch.zeros((1, rg.MAX_K + 256), device=dev))


def test_lorenz96_train_step_launches_the_trunk_kernels(monkeypatch):
    """One make_train_step step of the cut Lorenz-96 preset on the card: K7,
    K8, K9, K10 and K11 T−1 times each, no plain version, finite loss and
    changed parameters; the raw gradients match the CPU replay of the same
    draws (on the card's ancestors) to 5e-3 relative per leaf."""
    from psvo_tpu_torch import bridge, smc
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = dataclasses.replace(_l96_cfg(), train=dataclasses.replace(
        PRESETS["lorenz96_fivo_k8192_sharded"].train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    before = [p.detach().clone() for p in ssm.parameters()]
    ys = torch.randn((4, 6, 40), generator=torch.Generator().manual_seed(2)).to(dev) * 3.0
    kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
               trunk.trunk_backward, rg.segment_sum_scatter)
    plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             trunk.trunk_forward_reference, trunk.trunk_backward_reference,
             rg.segment_sum_scatter_reference, fused_step.stream_noise_reference)
    ancestors, resample = [], rg.resample_and_gather

    def recorded(u, logw, x):  # the card's ancestors, for the CPU replay
        if x.is_cuda:
            idx, x_res = resample(u, logw, x)
            ancestors.append(idx.cpu())
            return idx, x_res
        idx = ancestors.pop(0)
        return idx, rg.gather_particles(x.contiguous(), idx)

    monkeypatch.setattr(rg, "resample_and_gather", recorded)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [5] * 5
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    assert any(not torch.equal(a, p) for a, p in zip(before, ssm.parameters()))

    gen.set_state(state)  # replay the draws on the CPU
    eps0 = torch.randn((4, 40, 128), generator=gen, device=dev)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    u = smc.resampling.bulk_positions(gen, 5, 4, 128, "systematic")
    eps = fused_step.stream_noise_reference(seed, 5, 4, 40, 128)[0]
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    fwd = smc._forward_filter_trunk(ref, None, ys.cpu(), cfg.smc, cache=False,
                                    streams=(eps0.cpu(), eps, u.cpu()))
    (-torch.mean(fwd.log_z)).backward()
    assert not ancestors
    got, want = bridge.grads_to_numpy(ssm), bridge.grads_to_numpy(ref)
    for name in want:
        for a, w in zip(_leaves(got[name]), _leaves(want[name])):
            assert _rel(torch.from_numpy(a), torch.from_numpy(w)) <= 5e-3, name


def _svo_operands(dev, hidden, preset="lorenz63_svo_k256", b=4, m=8, t1=9, seed=0, di=0):
    """An SVO sweep's operands on the card: a model (with di controls) with
    nudged random weights, anchors, ε and observations at Lorenz-63 scales."""
    from psvo_tpu_torch.ops import svo

    net = NetConfig(hidden=hidden)
    cfg = PRESETS[preset].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                    g=dataclasses.replace(net, sigma_init=0.5))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=di))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for p in ssm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
        consts = svo.prepare(ssm)
    dx, dy = ssm.dx, ssm.dy
    x_anchor = torch.randn((b, m, dx), generator=g, device=dev) * 3.0
    eps = torch.randn((t1, b, m, dx), generator=g, device=dev)
    y = torch.randn((t1, b, dy), generator=g, device=dev) * 3.0
    return ssm, consts, (x_anchor, eps, y)


_SVO_SHAPES = [("lorenz63_svo_k256", (16,)), ("lorenz63_svo_k256", (16, 16)),
               ("fhn_fivo_k1024_bench", (32, 32)), ("lorenz63_svo_k256", (64, 64))]


@pytest.mark.parametrize("design", ["split", "chain"])
@pytest.mark.parametrize("preset,hidden", _SVO_SHAPES)
def test_svo_sweep_kernels_match_plain(preset, hidden, design):
    """K12 matches its plain version (x~ to 1e-5, lp/lq to 1e-5 relative); K13
    (each design) on K12's x~ matches the plain replay to 1e-4 relative per
    leaf, with all cotangents and with d_lp alone, and gives the same bits on
    a second launch."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    _, consts, ops = _svo_operands(dev, hidden, preset)
    launches = (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches)
    by_design = dict(svo.svo_sweep_backward.launches_by_design)
    got = svo.svo_sweep_forward(*ops, consts)
    want = svo.svo_sweep_forward_reference(*ops, consts)
    for i in (0, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5)
    for i in (1, 2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-3)
    g = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in got]
    for live in ((0, 1, 2, 3), (1,)):
        kw = [cots[i] if i in live else None for i in range(4)]
        k13 = svo.svo_sweep_backward(*ops, consts, got[3], *kw, design=design)
        ref = svo.svo_sweep_backward_reference(*ops, consts, got[3], *kw)
        for a, w in zip(k13, ref):
            assert _rel(a, w) <= 1e-4
        again = svo.svo_sweep_backward(*ops, consts, got[3], *kw, design=design)
        assert all(torch.equal(a, b) for a, b in zip(k13, again))
    assert (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches) == (
        launches[0] + 1, launches[1] + 4)
    assert svo.svo_sweep_backward.launches_by_design == {
        d: n + 4 * (d == design) for d, n in by_design.items()}


@pytest.mark.parametrize("preset,hidden,b,m,t1", [
    ("lorenz63_svo_k256", (16,), 4, 8, 9), ("lorenz63_svo_k256", (16, 16), 4, 8, 40),
    ("fhn_fivo_k1024_bench", (32, 32), 8, 16, 20), ("lorenz63_svo_k256", (64, 64), 32, 16, 99),
    ("lorenz63_svo_k256", (16, 16, 16), 2, 3, 150)])
def test_svo_backward_designs_agree(preset, hidden, b, m, t1):
    """K13's split design within 1e-5 relative L2 per leaf of the previous
    one (design="chain") on K12's x~, with every cotangent; the paths with a
    relu tie (a pre-activation within 1e-5 of its size, where the mask is a
    coin toss between two float32 sums) get none. The shapes give groups of
    1 to 4 paths a CTA and 1 to 10 tiles a group."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    _, consts, ops = _svo_operands(dev, hidden, preset, b=b, m=m, t1=t1)
    xtilde = svo.svo_sweep_forward(*ops, consts)[3]
    keep = ~_svo_relu_ties(consts, ops, xtilde)
    g = torch.Generator(device=dev).manual_seed(7)
    cots = [torch.randn(s, generator=g, device=dev) for s in
            ((b, m, ops[0].shape[-1]), (b, m), (b, m), tuple(xtilde.shape))]
    cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep, cots[3] * keep[..., None]]
    split = svo.svo_sweep_backward(*ops, consts, xtilde, *cots, design="split")
    chain = svo.svo_sweep_backward(*ops, consts, xtilde, *cots, design="chain")
    for a, w in zip(split, chain):
        assert _rel(a, w) <= 1e-5


def _svo_relu_ties(consts, ops, xtilde, tol=1e-5, cbias=None):
    """[B, M] bool: paths where a relu pre-activation of qb, f or g lies
    within tol of the magnitude of its sum (float64); with cbias, f's first
    layer starts from b1 + cbias (the control mode)."""
    from psvo_tpu_torch.ops import svo

    x_anchor, _, y = ops
    x_next = torch.cat([xtilde[1:], x_anchor[None]])
    y_b = y[:, :, None, :].expand(-1, -1, x_next.shape[2], -1)
    flag = torch.zeros(x_anchor.shape[:2], dtype=torch.bool, device=x_anchor.device)
    inputs = (torch.cat([x_next, y_b], -1), xtilde, xtilde)
    for n, ((layers, _), inp) in enumerate(zip(svo._nets(consts), inputs)):
        h = inp.double()
        for i, (w, bias) in enumerate(layers):
            bias = bias.double()
            if cbias is not None and n == 1 and i == 0:
                bias = bias + cbias[:, :, None, :].double()
            pre = h @ w.double() + bias
            flag |= (pre.abs() < tol * (h.abs() @ w.double().abs() + bias.abs())).any(-1).any(0)
            h = torch.relu(pre)
    return flag


def test_cuda_tensor_outside_the_svo_class_runs_the_eager_sweep():
    """Uneven hidden widths lie outside K12/K13's class and the reference's SVO
    gate: the q_b sweep runs eagerly on the card (K1 for the forward, no K12,
    no plain version), finite; the sweep ops still refuse bad operands."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256")
    cfg = cfg.with_nets(qb=NetConfig(hidden=(16, 32)))  # not one uniform width
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert not svo.usable(ssm, cfg.smc.n_smoothing_particles)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, svo.svo_sweep_forward)
    launches, calls = [f.launches for f in kernels], svo.svo_sweep_forward_reference.calls
    with torch.no_grad():
        out = make_objective(ssm, cfg)(torch.Generator(device=dev).manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 0]
    assert svo.svo_sweep_forward_reference.calls == calls
    assert out.smoothed.device == ys.device and bool(torch.isfinite(out.loss))
    _, consts, ops = _svo_operands(dev, (16, 16))
    with pytest.raises(ValueError, match="x_anchor"):  # eps holds 4 paths per row, not 8
        svo.svo_sweep_forward(ops[0], ops[1][:, :, :4].contiguous(), ops[2], consts)
    xtilde = svo.svo_sweep_forward(*ops, consts)[3]
    for design in svo.DESIGNS:  # a width outside the class (above 64)
        with pytest.raises(ValueError, match=f"no {design} kernel"):
            svo.svo_sweep_backward(*ops, dict(consts, hidden=72), xtilde, design=design)


def test_cuda_svo_train_step_launches_the_four_kernels():
    """One SVO train step on the card: K1, K4, K12 and K13 once each, no
    plain version, finite loss and ELBO."""
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
               svo.svo_sweep_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference,
             fused_step.stream_noise_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 1, 1]
    assert [f.calls for f in plain] == calls
    for name in ("loss", "grad_norm", "elbo_svo"):
        assert torch.isfinite(metrics[name]), name


def _step_operands(dev, dx, hidden, b=4, k=128, t1=5, seed=0):
    """K1's operands on the card at Dx = Dy = dx with one hidden width."""
    preset = "fhn_fivo_k1024_bench" if dx == 2 else "lorenz63_psvo_k1024"
    net = NetConfig(hidden=(hidden, hidden))
    cfg = PRESETS[preset].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                    g=dataclasses.replace(net, sigma_init=0.5))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    x0 = torch.randn((b, dx, k), generator=g, device=dev) * 3.0
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, 4 * dx + 1), generator=g, device=dev) + 0.1
    eps = torch.randn((t1, b, dx, k), generator=g, device=dev)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
    return consts, x0, a0, coef, eps, pos, g


@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("dx", [2, 3])
def test_step_kernels_match_plain(dx, hidden):
    """K14, chained over T−1 steps, gives K1's bits on the same streams and
    each step agrees with step_forward_reference on its own inputs (same
    indices, values to 2e-4); K15 on each step's residuals matches
    step_backward_reference to 1e-4 relative per leaf, with random d x_new,
    d α and d ℓ, and gives the same bits on a second launch."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, g = _step_operands(dev, dx, hidden)
    launches = (fused_step.step_forward.launches, fused_step.step_backward.launches)
    with torch.no_grad():
        k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                     save_res=True)
        x, lw, steps = x0, a0, []
        for t in range(coef.shape[0]):
            out = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t])
            ref = fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t])
            assert torch.equal(out[3], ref[3])
            for a, w in zip(out[:3], ref[:3]):
                torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
            steps.append(out)
            x, lw = out[:2]
    for i, want in ((0, k1[3]), (1, k1[4]), (2, k1[2]), (3, k1[5])):
        assert torch.equal(torch.stack([s[i] for s in steps]), want)
    for t, (x_new, alpha, stats, idx) in enumerate(steps):
        x_in = x0 if t == 0 else steps[t - 1][0]
        d_stats = torch.randn(stats.shape, generator=g, device=dev)
        d_x_new = torch.randn(x_new.shape, generator=g, device=dev)
        d_alpha = torch.randn(alpha.shape, generator=g, device=dev)
        args = (x_in, x_new, idx, stats, coef[t], consts, eps[t], d_stats, d_x_new, d_alpha)
        got = fused_step.step_backward(*args)
        again = fused_step.step_backward(*args)
        want = fused_step.step_backward_reference(x_in, coef[t], consts, eps[t], idx, d_stats,
                                                  d_x_new, d_alpha)
        for a, a2, w in zip(got, again, want):
            assert torch.equal(a, a2)
            assert _rel(a, w) <= 1e-4
    t1 = coef.shape[0]
    assert (fused_step.step_forward.launches, fused_step.step_backward.launches) == (
        launches[0] + t1, launches[1] + 2 * t1)


def test_step_backward_covers_k2048_at_lorenz_dims_and_refuses_outside():
    """K15 at Dx = 3, K = 2048, hidden (64, 64), where K4's shared memory on
    one CTA per row does not reach, against its plain version; beyond its
    class (K = 4352 > MAX_K, or 14 hidden layers of 64, more than any plan's
    shared memory holds) step_backward and StepForward raise
    NotImplementedError."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, g = _step_operands(dev, 3, 64, b=2, k=2048, t1=1)
    assert not fused_step._k4_ok(consts, 2048) and fused_step._k15_ok(consts, 2048)
    with torch.no_grad():
        x_new, alpha, stats, idx = fused_step.step_forward(x0, a0, coef[0], consts, eps[0], pos[0])
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    d_x_new = torch.randn(x_new.shape, generator=g, device=dev)
    d_alpha = torch.randn(alpha.shape, generator=g, device=dev)
    got = fused_step.step_backward(x0, x_new, idx, stats, coef[0], consts, eps[0], d_stats,
                                   d_x_new, d_alpha)
    want = fused_step.step_backward_reference(x0, coef[0], consts, eps[0], idx, d_stats, d_x_new,
                                              d_alpha)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4
    big = torch.zeros((1, 3, 4352), device=dev)
    with pytest.raises(NotImplementedError, match="no kernel"):
        fused_step.step_backward(big, big, torch.zeros((1, 4352), dtype=torch.int32, device=dev),
                                 stats[:1], coef[0, :1], consts, big, d_stats[:1])
    deep = dict(consts, n_mid=13)
    with pytest.raises(NotImplementedError, match="backward kernel"):
        fused_step.StepForward.apply(x0.requires_grad_(), a0, coef[0], consts["packed"],
                                     consts["sconst"], deep, eps[0], pos[0])


def test_per_step_train_step_launches_k14_and_k15(monkeypatch):
    """One make_train_step step with fused_step.SCAN_FUSED off on the card:
    K14 and K15 T−1 times each, on the S that step_slices picks from the
    card's occupancy, no K1 or K4, no plain version; its raw gradients match
    the per-step plain versions on CPU tensors replaying the step's streams
    to 1e-4 relative per leaf."""
    from psvo_tpu_torch import bridge
    from psvo_tpu_torch.smc import _draw_noise, _forward_filter_fused
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    monkeypatch.setattr(fused_step, "SCAN_FUSED", False)
    dev = _cuda()
    cfg = _small_cfg()
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2))
    kernels = (fused_step.step_forward, fused_step.step_backward, fused_step.scan_forward,
               fused_step.scan_backward)
    plain = (fused_step.step_forward_reference, fused_step.step_backward_reference,
             fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.stream_noise_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys.to(dev))
    assert [f.launches - n for f, n in zip(kernels, launches)] == [5, 5, 0, 0]
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"])
    _assert_chosen_slices(ssm, 4, 128)

    gen.set_state(state)  # replay the step's streams
    streams = tuple(t.cpu() for t in _draw_noise(gen, cfg.smc, 6, 4, 2))
    fwd = _forward_filter_fused(ref, None, ys, cfg.smc, cache=False, streams=streams)
    (-torch.mean(fwd.log_z)).backward()
    got, want = bridge.grads_to_numpy(ssm), bridge.grads_to_numpy(ref)
    for name in want:
        for a, w in zip(_leaves(got[name]), _leaves(want[name])):
            assert _rel(torch.from_numpy(a), torch.from_numpy(w)) <= 1e-4, name


def _assert_chosen_slices(ssm, batch, k):
    """K14's and K15's last launches ran on the S of step_slices at the card's
    resident-CTA counts."""
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    for fn, kernel, min_slice in ((fused_step.step_forward, 0, fused_step.K1_MIN_SLICE),
                                  (fused_step.step_backward, 1, fused_step.K4_MIN_SLICE)):
        resident = fused_step.resident_ctas(kernel, consts["packed"].device, consts, k)
        assert resident >= 132  # at least one CTA per SM of an H100
        assert fn.last_slices == fused_step.step_slices(batch, k, min_slice, resident)


@pytest.mark.parametrize("dx", [2, 3])
def test_step_forward_on_slices_is_bit_equal_to_one_cta_per_row(dx):
    """K14 on S CTAs per row, chained over T−1 steps from its own state,
    gives every output of S = 1 (x_new, α, ℓ, ESS, the filtered mean and the
    ancestors) bit for bit at each S the gate admits at K = 1024."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, _ = _step_operands(dev, dx, 16, k=1024)

    def chain(slices):
        x, lw, outs = x0, a0, []
        for t in range(coef.shape[0]):
            out = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t], slices=slices)
            assert fused_step.step_forward.last_slices == slices
            outs.append(out)
            x, lw = out[:2]
        return [torch.stack([o[i] for o in outs]) for i in range(4)]

    with torch.no_grad():
        one = chain(1)
        for slices in (2, 4):
            assert all(torch.equal(a, b) for a, b in zip(chain(slices), one))


@pytest.mark.parametrize("slices", [2, 4, 8])
@pytest.mark.parametrize("dx", [2, 3])
def test_step_backward_on_slices_matches_one_cta_per_row(dx, slices):
    """K15 on S CTAs per row: d_x bit-equal to S = 1, d_coef and the weight
    and sconst gradients within 1e-6 relative (summed per slice first), the
    same bits on a relaunch, and within 1e-4 of the plain version."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, g = _step_operands(dev, dx, 16, k=512, t1=1)
    with torch.no_grad():
        x_new, alpha, stats, idx = fused_step.step_forward(x0, a0, coef[0], consts, eps[0], pos[0])
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in (stats, x_new, alpha)]
    args = (x0, x_new, idx, stats, coef[0], consts, eps[0], *cots)
    one = fused_step.step_backward(*args, slices=1)
    got = fused_step.step_backward(*args, slices=slices)
    assert fused_step.step_backward.last_slices == slices
    again = fused_step.step_backward(*args, slices=slices)
    assert torch.equal(got[0], one[0])
    for a, w in zip(got[1:], one[1:]):
        assert _rel(a, w) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fused_step.step_backward_reference(x0, coef[0], consts, eps[0], idx, *cots)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


def test_per_step_train_step_runs_k14_and_k15_on_slices(monkeypatch):
    """One fhn_fivo_k1024_bench train step on the per-step path at its full
    widths (B = 32, K = 1024, hidden (64, 64); T cut to 6): K14 and K15
    launch T−1 times each on the S that step_slices picks from the card's
    occupancy, which splits each row over S > 1 CTAs."""
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    monkeypatch.setattr(fused_step, "SCAN_FUSED", False)
    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=6),
                              train=dataclasses.replace(cfg.train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((32, 6, 2), generator=torch.Generator().manual_seed(2)).to(dev)
    launches = (fused_step.step_forward.launches, fused_step.step_backward.launches)
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    assert (fused_step.step_forward.launches, fused_step.step_backward.launches) == (
        launches[0] + 5, launches[1] + 5)
    assert torch.isfinite(metrics["loss"])
    _assert_chosen_slices(ssm, 32, 1024)
    assert min(fused_step.step_forward.last_slices, fused_step.step_backward.last_slices) > 1


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("dx", [2, 3])
def test_scan_forward_on_clusters_is_bit_equal_to_one_cta_per_row(dx, cluster):
    """K1 on clusters of C CTAs per row gives every output of C = 1 bit for
    bit, with the streamed noise and with the in-kernel draw."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, _ = _step_operands(dev, dx, 16, k=1024)
    with torch.no_grad():
        for noise in ({"eps": eps, "positions": pos}, {"seed": (5, 6)}):
            one = fused_step.scan_forward(x0, a0, coef, consts, cache=True, save_res=True,
                                          cluster=1, **noise)
            got = fused_step.scan_forward(x0, a0, coef, consts, cache=True, save_res=True,
                                          cluster=cluster, **noise)
            assert fused_step.scan_forward.last_cluster == cluster
            assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("dx", [2, 3])
def test_scan_backward_on_clusters_matches_one_cta_per_row(dx, cluster):
    """K4 on clusters of C CTAs per row: d_x0 bit-equal to C = 1, d_coef and
    the weight and sconst gradients within 1e-6 relative (summed per slice
    first), the same bits on a relaunch, and within 1e-4 of the plain version."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, g = _step_operands(dev, dx, 16, k=512)
    with torch.no_grad():
        x_last, alpha_last, stats, x_all, alpha_all, idx = fused_step.scan_forward(
            x0, a0, coef, consts, eps=eps, positions=pos, cache=True, save_res=True)
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    cots = [torch.randn(t.shape, generator=g, device=dev) * 0.1
            for t in (x_last, alpha_last, x_all, alpha_all)]
    args = (x0, x_all, idx, stats, coef, consts, d_stats, *cots)
    one = fused_step.scan_backward(*args, eps=eps, cluster=1)
    got = fused_step.scan_backward(*args, eps=eps, cluster=cluster)
    assert fused_step.scan_backward.last_cluster == cluster
    again = fused_step.scan_backward(*args, eps=eps, cluster=cluster)
    assert torch.equal(got[0], one[0])
    for a, w in zip(got[1:], one[1:]):
        assert _rel(a, w) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats, *cots)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


def test_train_step_runs_k1_and_k4_on_clusters():
    """One fhn_fivo_k1024_bench train step at its full widths (B = 32,
    K = 1024, hidden (64, 64); T cut to 6): K1 and K4 launch once each, on
    the cluster size that cluster_size picks from the card's occupancy, which
    splits each row over C > 1 CTAs."""
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=6),
                              train=dataclasses.replace(cfg.train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((32, 6, 2), generator=torch.Generator().manual_seed(2)).to(dev)
    launches = (fused_step.scan_forward.launches, fused_step.scan_backward.launches)
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    assert (fused_step.scan_forward.launches, fused_step.scan_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert torch.isfinite(metrics["loss"])
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    for fn, kernel, min_slice in ((fused_step.scan_forward, 0, fused_step.K1_MIN_SLICE),
                                  (fused_step.scan_backward, 1, fused_step.K4_MIN_SLICE)):
        max_active = fused_step.max_active_clusters(kernel, dev, consts, 1024)
        assert fn.last_cluster == fused_step.cluster_size(32, 1024, min_slice, max_active) > 1


def test_cluster_launch_outside_the_class_raises():
    """A forced cluster that does not split K into whole slices raises; so
    does K4 at Dx = 3, K = 2048 forced onto one CTA per row (no room), where
    the chosen cluster runs it."""
    dev = _cuda()
    consts, x0, a0, coef, eps, pos, g = _step_operands(dev, 3, 64, b=2, k=2048, t1=1)
    with torch.no_grad(), pytest.raises(ValueError, match="no cluster"):
        fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cluster=16)
    with torch.no_grad():
        _, _, stats, x_all, _, idx = fused_step.scan_forward(
            x0, a0, coef, consts, eps=eps, positions=pos, save_res=True)
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, eps=eps, cluster=1)
    got = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, eps=eps)
    assert fused_step.scan_backward.last_cluster > 1
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats)
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-4


@pytest.mark.parametrize("m", [1, 16, 33])
@pytest.mark.parametrize("preset,hidden", [("fhn_fivo_k1024_bench", 16), ("fhn_fivo_k1024_bench", 32),
                                           ("fhn_fivo_k1024_bench", 64), ("lorenz63_svo_k256", 16),
                                           ("lorenz63_svo_k256", 32), ("lorenz63_svo_k256", 64)])
def test_svo_forward_split_is_bit_equal_to_chain(preset, hidden, m):
    """K12's split design gives the chain design's bits in x_first, lp, lq and
    x~, at (Dx, Dy) = (2, 2) and (3, 3), hidden 16, 32 and 64, M in {1, 16,
    33}: with its own plan (one chunk) and with chunks of 7 steps."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    _, consts, ops = _svo_operands(dev, (hidden, hidden), preset, b=3, m=m, t1=20)
    by_design = dict(svo.svo_sweep_forward.launches_by_design)
    split = svo.svo_sweep_forward(*ops, consts)
    chain = svo.svo_sweep_forward(*ops, consts, design="chain")
    assert all(torch.equal(a, c) for a, c in zip(split, chain))
    paths = svo.k12_plan(consts["dx"], consts["dy"], hidden, 1, 3 * m, 132, 20)[0]
    plan = (paths, 64, 7)
    chunked = svo._launch_forward(*ops, consts, torch.cuda.current_stream(dev).cuda_stream,
                                  "split", plan=plan)
    assert all(torch.equal(a, c) for a, c in zip(chunked, chain))
    assert svo.svo_sweep_forward.launches_by_design == {
        "split": by_design["split"] + 2, "chain": by_design["chain"] + 1}
    with pytest.raises(ValueError, match="no design"):
        svo.svo_sweep_forward(*ops, consts, design="warp")


def _k9_launch(x_res, coef, consts, noise, t, pair, prefetch):
    """K9's async design with an explicit (pair, prefetch), through its C entry point."""
    from psvo_tpu_torch.ops import _build

    b, dx, k = x_res.shape
    x_new = torch.empty_like(x_res)
    alpha = torch.empty((b, k), device=x_res.device)
    seed = noise.get("seed") or (0, 0)
    lib = _build.load_library()
    _, off_f, off_g = consts["offsets"]
    err = lib.psvo_trunk_forward(
        x_res.data_ptr(), noise["eps"].data_ptr() if "eps" in noise else None, coef.data_ptr(),
        consts["packed"].data_ptr(), consts["sconst"].data_ptr(), x_new.data_ptr(),
        alpha.data_ptr(), seed[0], seed[1], int("seed" in noise), t, b, k, dx, consts["dy"],
        consts["hidden"], consts["n_mid"], consts["packed"].numel(), off_f, off_g, 0, int(pair),
        int(prefetch), 0, 0, torch.cuda.current_stream(x_res.device).cuda_stream)
    _build.check(lib, err, "psvo_trunk_forward")
    return x_new, alpha


@pytest.mark.parametrize("hidden", [16, 32, 64])
@pytest.mark.parametrize("rng", [False, True])
def test_trunk_forward_async_is_bit_equal_to_tile(hidden, rng):
    """K9's async design gives the tile design's bits in x_new and α, with the
    streamed ε and the in-kernel draw, at hidden 16, 32 and 64; K = 3840 at B
    = 3 is 180 tiles, a ragged second wave of the persistent grid; row 1 lies
    below the −3e30 floor. At hidden 64 every (pair, prefetch) part-set of
    the design gives the same bits too."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    ssm = init_ssm(_l96_cfg(hidden), torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, k, t = 3, 3840, 4
    x_res = torch.randn((b, 40, k), generator=g, device=dev) * 3.0
    coef = torch.rand((b, 161), generator=g, device=dev) + 0.1
    coef[1, 120:160] = 1e16
    noise = {"seed": (5, 6), "t": t} if rng else {"eps": torch.randn((b, 40, k), generator=g,
                                                                       device=dev)}
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        by_design = dict(trunk.trunk_forward.launches_by_design)
        new = trunk.trunk_forward(x_res, coef, consts, **noise)
        old = trunk.trunk_forward(x_res, coef, consts, **noise, design="tile")
        assert trunk.trunk_forward.launches_by_design == {
            "async": by_design["async"] + 1, "tile": by_design["tile"] + 1}
        assert all(torch.equal(a, o) for a, o in zip(new, old))
        assert bool((new[1][1] == -3e30).all())
        if hidden == 64:
            for pair, prefetch in trunk.K9_PLANS:
                got = _k9_launch(x_res, coef, consts, noise, t, pair, prefetch)
                assert all(torch.equal(a, o) for a, o in zip(got, old)), (pair, prefetch)
    with pytest.raises(ValueError, match="no design"):
        trunk.trunk_forward(x_res, coef, consts, **noise, design="simt")


def test_svo_paths_launch_only_the_split_designs():
    """SVO serving (smooth_posterior) and one train step: every K12 and K13
    launch is the split design."""
    from psvo_tpu_torch import infer
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    fns = (svo.svo_sweep_forward, svo.svo_sweep_backward)
    before = [dict(f.launches_by_design) for f in fns]
    paths = infer.smooth_posterior(ssm, ys, cfg, torch.Generator(device=dev).manual_seed(3),
                                   method="svo")
    assert bool(torch.isfinite(paths).all())
    make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev).manual_seed(4), ys)
    got = [{d: f.launches_by_design[d] - n[d] for d in n} for f, n in zip(fns, before)]
    assert got == [{"split": 2, "chain": 0}, {"split": 1, "chain": 0}]


def test_lorenz96_paths_launch_only_the_async_design():
    """Lorenz-96 serving (filter_posterior) and one train step: every K9
    launch is the async design (T − 1 per call), every K10 launch the
    tensor-core one."""
    from psvo_tpu_torch import infer
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = dataclasses.replace(_l96_cfg(), train=dataclasses.replace(
        PRESETS["lorenz96_fivo_k8192_sharded"].train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 40), generator=torch.Generator().manual_seed(2)).to(dev) * 3.0
    k9, k10 = dict(trunk.trunk_forward.launches_by_design), dict(trunk.trunk_backward.launches_by_design)
    means = infer.filter_posterior(ssm, ys, cfg)
    assert bool(torch.isfinite(means).all())
    make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev).manual_seed(4), ys)
    assert {d: trunk.trunk_forward.launches_by_design[d] - n for d, n in k9.items()} == {
        "async": 10, "tile": 0}
    assert {d: trunk.trunk_backward.launches_by_design[d] - n for d, n in k10.items()} == {
        "tf32x3": 5, "simt": 0}


@pytest.mark.parametrize("k", [128, 1024, 8192, 19200])
def test_resample_designs_agree(k):
    """K7's cluster design gives the row design's and the plain version's
    indices on the adversarial rows (systematic and sorted multinomial
    positions), at the C that k7_cluster picks and at every C the class
    admits; K11's tiled design is within 1e-6 of the row design and of the
    float64 plain version, childless sources exactly 0, the same bits on a
    second launch, on one-ancestor rows too."""
    from psvo_tpu_torch.ops import _build
    from psvo_tpu_torch.ops import resample_gather as rg

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    logw = _weight_rows(k, dev)
    b = logw.shape[0]
    systematic = fused_step.systematic_positions(torch.rand((b,), generator=gen, device=dev), k)
    multinomial = torch.sort(torch.rand((b, k), generator=gen, device=dev), -1).values
    for pos in (systematic.contiguous(), multinomial.contiguous()):
        want = rg.ancestor_indices_large_reference(logw, pos)
        row = rg.ancestor_indices_large(logw, pos, design="row")
        got = rg.ancestor_indices_large(logw, pos)
        assert torch.equal(got, want) and torch.equal(row, want)
        assert torch.equal(rg.ancestor_indices_large(logw, pos), got)
    lib = _build.load_library()
    for c in rg.CLUSTER_SIZES:
        if c > 1 and k % (c * 256):
            continue
        idx = torch.empty((b, k), dtype=torch.int32, device=dev)
        err = lib.psvo_ancestor_indices_large(logw.data_ptr(), systematic.data_ptr(),
                                              idx.data_ptr(), b, k, 0, c, 0,
                                              torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "ancestor_indices_large")
        assert torch.equal(idx, rg.ancestor_indices_large_reference(logw, systematic)), c
    one = torch.full((b, k), -50.0, device=dev)
    one[torch.arange(b, device=dev), torch.randint(0, k, (b,), generator=gen, device=dev)] = 0.0
    for idx in (rg.ancestor_indices_large(logw, systematic.contiguous()),
                rg.ancestor_indices_large(one, systematic.contiguous())):
        g = torch.randn((b, 40, k), generator=gen, device=dev)
        before = dict(rg.segment_sum_scatter.launches_by_design)
        got = rg.segment_sum_scatter(g, idx)
        again = rg.segment_sum_scatter(g, idx)
        row = rg.segment_sum_scatter(g, idx, design="row")
        assert {d: rg.segment_sum_scatter.launches_by_design[d] - n for d, n in before.items()} == {
            "tiled": 2, "row": 1}
        want = rg.segment_sum_scatter_reference(g.double(), idx)
        assert torch.equal(got, again)
        assert _rel(got.double(), want) <= 1e-6 and _rel(got, row) <= 1e-6
        assert bool((got[want == 0] == 0).all())


def test_lorenz96_paths_launch_only_the_new_resample_designs():
    """Lorenz-96 serving (filter_posterior) and one train step: every K7
    launch is the cluster design (T − 1 per filter), every K11 launch the
    tiled design (T − 1 per train step), no plain version."""
    from psvo_tpu_torch import infer
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = dataclasses.replace(_l96_cfg(), train=dataclasses.replace(
        PRESETS["lorenz96_fivo_k8192_sharded"].train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 40), generator=torch.Generator().manual_seed(2)).to(dev) * 3.0
    k7, k11 = (dict(rg.ancestor_indices_large.launches_by_design),
               dict(rg.segment_sum_scatter.launches_by_design))
    plain = (rg.ancestor_indices_large_reference.calls, rg.segment_sum_scatter_reference.calls)
    means = infer.filter_posterior(ssm, ys, cfg)
    assert bool(torch.isfinite(means).all())
    make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev).manual_seed(4), ys)
    assert {d: rg.ancestor_indices_large.launches_by_design[d] - n for d, n in k7.items()} == {
        "cluster": 10, "row": 0}
    assert {d: rg.segment_sum_scatter.launches_by_design[d] - n for d, n in k11.items()} == {
        "tiled": 5, "row": 0}
    assert (rg.ancestor_indices_large_reference.calls,
            rg.segment_sum_scatter_reference.calls) == plain


# -- exogenous controls (data.di > 0) -------------------------------------------------


def _controlled_operands(dev, dx, hidden=16, b=4, k=128, t1=5, di=2, seed=0):
    """K1's operands with controls on the card: the model of a controlled
    preset shape (Dx = Dy = dx, di controls), coefficient rows that end in
    the controls' first-layer terms of random controls."""
    cfg = PRESETS["fhn_fivo_controls" if dx == 2 else "lorenz63_psvo_k1024"]
    net = NetConfig(hidden=(hidden, hidden))
    cfg = dataclasses.replace(cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                            g=dataclasses.replace(net, sigma_init=0.5)),
                              data=dataclasses.replace(cfg.data, di=di))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        u = torch.randn((t1, b, di), generator=g, device=dev)
        coef = torch.cat([torch.rand((t1, b, 4 * dx + 1), generator=g, device=dev) + 0.1,
                          fused_step.control_term(consts, u)], dim=-1).contiguous()
    x0 = torch.randn((b, dx, k), generator=g, device=dev) * 3.0
    a0 = torch.randn((b, k), generator=g, device=dev)
    eps = torch.randn((t1, b, dx, k), generator=g, device=dev)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
    return ssm, consts, x0, a0, coef, eps, pos, g


@pytest.mark.parametrize("dx, k, cluster", [(2, 128, 1), (2, 1024, 2), (3, 128, 1)])
def test_controlled_scan_kernels_match_plain(dx, k, cluster):
    """K1 and K4 with controls (the coef rows' 2H extra columns) on clusters
    of `cluster` CTAs per row: K1 against its plain version to 2e-4 (K = 128)
    or bit-equal to one CTA per row (K = 1024, where a free run may flip an
    ancestor against the plain one), K4 against its plain version on one K1
    run's residuals, every cotangent live, to 1e-4 relative per leaf
    (d_coef's control columns included); bit-equal on a relaunch."""
    dev = _cuda()
    _, consts, x0, a0, coef, eps, pos, g = _controlled_operands(dev, dx, k=k)
    with torch.no_grad():
        got = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                      save_res=True, cluster=cluster)
        if cluster == 1:
            want = fused_step.scan_forward_reference(x0, a0, coef, consts, eps, pos, cache=True)
            for a, w in zip(got[:5], want[:5]):
                torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
        else:
            one = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos,
                                          cache=True, save_res=True, cluster=1)
            assert all(torch.equal(a, w) for a, w in zip(got, one))
    x_last, alpha_last, stats, x_all, alpha_all, idx = got
    d_stats = torch.randn(stats.shape, generator=g, device=dev)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in (x_last, alpha_last)]
    cots += [torch.randn(t.shape, generator=g, device=dev) * 0.1 for t in (x_all, alpha_all)]
    bwd = (x0, x_all, idx, stats, coef, consts, d_stats, *cots)
    k4 = fused_step.scan_backward(*bwd, eps=eps, cluster=cluster)
    again = fused_step.scan_backward(*bwd, eps=eps, cluster=cluster)
    plain = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, d_stats, *cots)
    assert all(torch.equal(a, b) for a, b in zip(k4, again))
    for a, w in zip(k4, plain):
        assert _rel(a, w) <= 1e-4
    assert _rel(k4[1][..., -2 * consts["hidden"]:], plain[1][..., -2 * consts["hidden"]:]) <= 1e-4


@pytest.mark.parametrize("slices", [1, 4])
def test_controlled_step_kernels_match_plain(slices):
    """K14 chained over T−1 steps with controls gives K1's bits on the same
    streams and each step agrees with step_forward_reference; K15 on each
    step's residuals matches step_backward_reference to 1e-4 relative per
    leaf (the control columns of d_coef included), on `slices` CTAs a row."""
    dev = _cuda()
    _, consts, x0, a0, coef, eps, pos, g = _controlled_operands(dev, 2, k=1024)
    with torch.no_grad():
        k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                     save_res=True)
        x, lw, steps = x0, a0, []
        for t in range(coef.shape[0]):
            out = fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t], slices=slices)
            ref = fused_step.step_forward_reference(x, lw, coef[t], consts, eps[t], pos[t])
            assert torch.equal(out[3], ref[3])
            for a, w in zip(out[:3], ref[:3]):
                torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
            steps.append(out)
            x, lw = out[:2]
    for i, want in ((0, k1[3]), (1, k1[4]), (2, k1[2]), (3, k1[5])):
        assert torch.equal(torch.stack([s[i] for s in steps]), want)
    for t, (x_new, alpha, stats, idx) in enumerate(steps):
        x_in = x0 if t == 0 else steps[t - 1][0]
        cots = [torch.randn(v.shape, generator=g, device=dev) for v in (stats, x_new, alpha)]
        got = fused_step.step_backward(x_in, x_new, idx, stats, coef[t], consts, eps[t], *cots,
                                       slices=slices)
        want = fused_step.step_backward_reference(x_in, coef[t], consts, eps[t], idx, *cots)
        for a, w in zip(got, want):
            assert _rel(a, w) <= 1e-4


def test_uncontrolled_launch_equals_controlled_launch_with_zero_controls():
    """The control mode adds c to the first-layer bias and nothing else: with
    zero controls K1's outputs and K4's d_x0 and weight gradients are the
    uncontrolled launch's bits on the same weights."""
    dev = _cuda()
    _, consts, x0, a0, coef, eps, pos, g = _controlled_operands(dev, 2, k=1024)
    t1, b = coef.shape[:2]
    zero = torch.cat([coef[..., :9], torch.zeros((t1, b, 2 * consts["hidden"]), device=dev)], -1)
    plain_consts = dict(consts, di=0, ctrl_w=None)
    with torch.no_grad():
        ctrl = fused_step.scan_forward(x0, a0, zero.contiguous(), consts, eps=eps, positions=pos,
                                       save_res=True)
        none = fused_step.scan_forward(x0, a0, coef[..., :9].contiguous(), plain_consts, eps=eps,
                                       positions=pos, save_res=True)
    assert all(torch.equal(a, w) for a, w in zip(ctrl, none) if a is not None)
    d_stats = torch.randn(ctrl[2].shape, generator=g, device=dev)
    d_x = torch.randn(x0.shape, generator=g, device=dev)
    k4c = fused_step.scan_backward(x0, ctrl[3], ctrl[5], ctrl[2], zero.contiguous(), consts,
                                   d_stats, d_x, eps=eps)
    k4n = fused_step.scan_backward(x0, none[3], none[5], none[2], coef[..., :9].contiguous(),
                                   plain_consts, d_stats, d_x, eps=eps)
    assert torch.equal(k4c[0], k4n[0]) and torch.equal(k4c[2], k4n[2])
    assert torch.equal(k4c[1][..., :9], k4n[1])


@pytest.mark.parametrize("scan_fused", [True, False])
def test_controlled_train_step_runs_the_kernels(monkeypatch, scan_fused):
    """One make_train_step step of the controlled preset's shape (hidden 16)
    on the card: K1 and K4 once (or K14 and K15 T−1 times with SCAN_FUSED
    off), no plain version; its raw gradients, W_u's rows included, match the
    plain versions on CPU tensors replaying the step's streams to 1e-4
    relative per leaf."""
    from psvo_tpu_torch import bridge
    from psvo_tpu_torch.smc import _draw_noise, _forward_filter_fused
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    monkeypatch.setattr(fused_step, "SCAN_FUSED", scan_fused)
    dev = _cuda()
    cfg = _small_cfg("fhn_fivo_controls")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2))
    u = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(5))
    kernels = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
               fused_step.step_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.step_forward_reference, fused_step.step_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys.to(dev), controls=u.to(dev))
    assert [f.launches - n for f, n in zip(kernels, launches)] == (
        [1, 1, 0, 0] if scan_fused else [0, 0, 5, 5])
    assert [f.calls for f in plain] == calls
    gen.set_state(state)
    streams = tuple(t.cpu() for t in _draw_noise(gen, cfg.smc, 6, 4, 2))
    fwd = _forward_filter_fused(ref, None, ys, cfg.smc, cache=False, streams=streams, controls=u)
    (-torch.mean(fwd.log_z)).backward()
    got, want = bridge.grads_to_numpy(ssm), bridge.grads_to_numpy(ref)
    for name in want:
        for a, w in zip(_leaves(got[name]), _leaves(want[name])):
            assert _rel(torch.from_numpy(a), torch.from_numpy(w)) <= 1e-4, name


def test_cuda_controls_outside_the_kernel_classes_take_the_trunk_and_eager_routes():
    """A controlled model on CUDA tensors outside the whole-scan class runs
    the trunk class's kernels in their control mode (Lorenz-96 with
    controls, and FHN at Dx + Di > 7): K9 once a step, no plain version;
    PSVO at Dx + Di > 7 runs on that forward (K9, then K5), and SVO there,
    where the reference's SVO gate (max(Dx + Di, Dy) <= 7) sends it to its
    scan body, runs the eager q_b sweep (K9, no K12)."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import ffbsi, svo, trunk
    from psvo_tpu_torch.smc import forward_filter

    dev = _cuda()
    for preset, di, shape in (("lorenz96_fivo_k8192_sharded", 2, (2, 5, 40)),
                              ("fhn_fivo_controls", 6, (2, 5, 2))):
        cfg = PRESETS[preset]
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=di))
        ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
        launches, calls = trunk.trunk_forward.launches, trunk.trunk_forward_reference.calls
        with torch.no_grad():
            out = forward_filter(ssm, torch.Generator(device=dev), torch.zeros(shape, device=dev),
                                 cfg.smc, controls=torch.ones((*shape[:2], di), device=dev))
        assert trunk.trunk_forward.launches == launches + 4
        assert trunk.trunk_forward_reference.calls == calls
        assert bool(torch.isfinite(out.log_z).all())
    for preset in ("lorenz63_psvo_k1024", "lorenz63_svo_k256"):
        cfg = PRESETS[preset]
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=5))
        objective = make_objective(init_ssm(cfg, torch.Generator().manual_seed(0), device=dev),
                                   cfg)
        args = (torch.Generator(device=dev), torch.zeros((2, 5, 3), device=dev))
        kw = {"controls": torch.zeros((2, 5, 5), device=dev)}
        if preset.startswith("lorenz63_psvo"):
            launches = (trunk.trunk_forward.launches, ffbsi.ffbsi_forward.launches)
            with torch.no_grad():
                out = objective(*args, **kw)
            assert (trunk.trunk_forward.launches, ffbsi.ffbsi_forward.launches) == (
                launches[0] + 4, launches[1] + 1)
            assert bool(torch.isfinite(out.loss))
            continue
        launches = (trunk.trunk_forward.launches, svo.svo_sweep_forward.launches)
        with torch.no_grad():
            out = objective(*args, **kw)
        assert (trunk.trunk_forward.launches, svo.svo_sweep_forward.launches) == (
            launches[0] + 4, launches[1])
        assert bool(torch.isfinite(out.loss))


def test_cuda_bootstrap_model_takes_the_general_path():
    """A bootstrap model lies outside every filter kernel class (its proposal
    is f), as the reference's gates say; on CUDA tensors its filter runs the
    general path, the counterpart of the reference's plain scan: K7 and K8
    once a step, no other kernel and no plain version, at the FHN and
    Lorenz-96 shapes. Segmented PSVO in bootstrap mode runs the plain step
    body per segment (K7/K8, no K1), as the reference does, and K5 once a
    segment's sweep and once for t = 0."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.smc import forward_filter

    dev = _cuda()
    for preset, shape in (("fhn_fivo_k1024_bench", (2, 5, 2)),
                          ("lorenz96_fivo_k8192_sharded", (2, 5, 40))):
        cfg = PRESETS[preset]
        cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, use_bootstrap=True))
        ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
        before = [rg.ancestor_indices_large.launches, rg.gather_particles.launches,
                  fused_step.scan_forward.launches]
        with torch.no_grad():
            out = forward_filter(ssm, torch.Generator(device=dev), torch.zeros(shape, device=dev),
                                 cfg.smc)
        assert bool(torch.isfinite(out.log_z).all())
        assert [rg.ancestor_indices_large.launches, rg.gather_particles.launches,
                fused_step.scan_forward.launches] == [before[0] + 4, before[1] + 4, before[2]]
    cfg = _small_cfg("lorenz63_psvo_k1024", use_bootstrap=True, ffbsi_segments=5)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    before = [rg.ancestor_indices_large.launches, fused_step.scan_forward.launches,
              ffbsi.ffbsi_forward.launches]
    with torch.no_grad():
        out = make_objective(ssm, cfg)(torch.Generator(device=dev),
                                       torch.zeros((2, 6, 3), device=dev))
    # 5 forward steps, and 4 replayed for the sweep (the last segment holds only the anchors)
    assert [rg.ancestor_indices_large.launches, fused_step.scan_forward.launches,
            ffbsi.ffbsi_forward.launches] == [before[0] + 9, before[1], before[2] + 5]
    assert bool(torch.isfinite(out.loss)) and out.smoothed.shape == (6, 2, 16, 3)


# The general path (the reference's plain scan) on the card: one dispatch test a mode
_MODES = {
    "known dynamics": dict(smc={"transition": "known"}),
    "known dynamics, controls": dict(smc={"transition": "known"}, di=2),
    "f tril": dict(nets={"f": "tril"}),
    "f tril_head": dict(nets={"f": "tril_head"}),
    "f head": dict(nets={"f": "head"}),
    "g tril": dict(nets={"g": "tril"}),
    "g tril_head": dict(nets={"g": "tril_head"}),
    "dirac": dict(emission="dirac"),
    "poisson": dict(emission="poisson"),
    "bootstrap": dict(smc={"use_bootstrap": True}),
    "bootstrap, f tril": dict(smc={"use_bootstrap": True}, nets={"f": "tril"}),
    "bootstrap, f tril_head": dict(smc={"use_bootstrap": True}, nets={"f": "tril_head"}),
    "iwae": dict(smc={"objective": "iwae", "resampling": "none"}, k=16),  # fhn_iwae_k16's K
}


def _mode_cfg(mode, t=6):
    """The small FHN model (hidden (16, 16), K = 128, T = 6) in one mode."""
    spec = _MODES[mode]
    k = spec.get("k", 128)
    cfg = _small_cfg("fhn_fivo_k128", **spec.get("smc", {}))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, t_steps=t, di=spec.get("di", 0),
        emission=spec.get("emission", cfg.data.emission)),
        smc=dataclasses.replace(cfg.smc, n_particles=k, kernel_rng=False))
    return cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), cov_type=c)
                            for n, c in spec.get("nets", {}).items()})


def _general_counters():
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import svo, trunk

    mine = (rg.ancestor_indices_large, rg.gather_particles, rg.segment_sum_scatter)
    others = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
              fused_step.step_backward, trunk.trunk_forward, trunk.trunk_backward,
              ffbsi.ffbsi_forward, ffbsi.ffbsi_backward, svo.svo_sweep_forward,
              svo.svo_sweep_backward)
    plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             rg.segment_sum_scatter_reference, fused_step.scan_forward_reference,
             fused_step.scan_backward_reference, fused_step.step_forward_reference,
             fused_step.step_backward_reference, trunk.trunk_forward_reference,
             trunk.trunk_backward_reference)
    return mine, others, plain


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cuda_mode_runs_the_general_path(mode):
    """Each mode outside the reference's kernel gates: no kernel gate admits
    it, and on CUDA tensors the filter (no grad) launches K7 and K8 once a
    step and a FIVO train step's backward K11 once a step (none of them
    without resampling), no other kernel and no plain version; the loss and
    the gradients are finite."""
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _mode_cfg(mode)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert not fused_step.usable(ssm, cfg.smc) and not trunk.usable(ssm, cfg.smc)
    assert smc.reference_path(ssm, cfg.smc) == "scan"
    mine, others, plain = _general_counters()
    b, t = 4, cfg.data.t_steps
    ys = torch.randn((b, t, 2), generator=torch.Generator().manual_seed(1)).abs().round().to(dev)
    ctrl = {} if not cfg.data.di else {"controls": torch.zeros((b, t, cfg.data.di), device=dev)}
    resamples = cfg.smc.objective != "iwae"

    def counts():
        return [f.launches for f in mine], [f.launches for f in others], [f.calls for f in plain]

    start = counts()
    with torch.no_grad():
        out = smc.forward_filter(ssm, torch.Generator(device=dev).manual_seed(2), ys, cfg.smc,
                                 **ctrl)
    after = counts()
    per = (t - 1) if resamples else 0
    assert [a - s for a, s in zip(after[0], start[0])] == [per, per, 0]
    assert after[1:] == start[1:]
    assert bool(torch.isfinite(out.log_z).all())
    step = make_train_step(ssm, cfg, make_optimizer(cfg))
    metrics = step(torch.Generator(device=dev).manual_seed(3), ys, **ctrl)
    final = counts()
    assert [f - a for f, a in zip(final[0], after[0])] == [per, per, per]
    assert final[1:] == start[1:]
    assert all(bool(torch.isfinite(metrics[n])) for n in ("loss", "grad_norm"))


@pytest.mark.parametrize("mode", ["f tril", "known dynamics", "iwae"])
def test_cuda_general_path_matches_the_cpu(mode):
    """The general path on the card against itself on the CPU, on the same
    draws (made on the CPU) and weights, the CPU resampling through K7's and
    K8's plain versions (the count form), so the ancestors agree: log Ẑ and
    the increments within 2e-4, every gradient leaf within rtol 5e-3, atol
    5e-4."""
    import copy
    import functools

    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import resampling

    dev = _cuda()
    cfg = _mode_cfg(mode, t=12)
    cpu_ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_ssm = copy.deepcopy(cpu_ssm).to(dev)
    b, t, k = 4, cfg.data.t_steps, cfg.smc.n_particles
    g = torch.Generator().manual_seed(5)
    ys = torch.randn((b, t, 2), generator=g)
    method = cfg.smc.resampling
    noise = (torch.randn((b, 2, k), generator=g), torch.randn((t - 1, b, 2, k), generator=g),
             resampling.bulk_positions(g, t - 1, b, k, method) if method != "none"
             else torch.zeros((t - 1, b, 1)))
    card = make_objective(card_ssm, cfg)(None, ys.to(dev), noise=tuple(n.to(dev) for n in noise))
    card.loss.backward()
    plain_resample = resampling.maybe_resample
    resampling.maybe_resample = functools.partial(plain_resample, use_kernel=True)
    try:
        cpu = make_objective(cpu_ssm, cfg)(None, ys, noise=noise)
        cpu.loss.backward()
    finally:
        resampling.maybe_resample = plain_resample
    torch.testing.assert_close(card.elbo.detach().cpu(), cpu.elbo.detach(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(card.filter_result.increments.detach().cpu(),
                               cpu.filter_result.increments.detach(), rtol=2e-4, atol=2e-4)
    for (name, p_card), p_cpu in zip(card_ssm.named_parameters(), cpu_ssm.parameters()):
        if p_cpu.grad is None:
            assert p_card.grad is None, name
            continue
        torch.testing.assert_close(p_card.grad.cpu(), p_cpu.grad, rtol=5e-3, atol=5e-4,
                                   msg=name)


def test_cuda_reference_kernel_class_outside_the_ports_raises():
    """A configuration the reference runs through one of its kernels runs a
    port kernel on CUDA tensors, never the plain loop: multinomial resampling
    at the FHN width (the reference's whole-step kernel) launches K1 once;
    IWAE at K = 128 and ESS-adaptive resampling (its trunk kernel) launch K9
    once a step (K7/K8 only with resampling), no plain version; so does the
    trunk class at Dx = Dy = 10, from a shape library of its own. One
    outside every port kernel class, the trunk class at a width of 72, still
    raises rather than run the plain loop where the reference runs a
    kernel."""
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    cfg = _small_cfg("fhn_fivo_k128")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.zeros((8, 6, 2), device=dev)
    kernels = (fused_step.scan_forward, rg.ancestor_indices_large, trunk.trunk_forward)
    plain = (fused_step.scan_forward_reference, rg.ancestor_indices_large_reference,
             trunk.trunk_forward_reference)
    for kw, route, want in (({"resampling": "multinomial"}, "fused", [1, 0, 0]),
                            ({"resampling": "none"}, "trunk", [0, 0, 5]),
                            ({"ess_threshold": 0.5}, "trunk", [0, 5, 5])):
        smc_cfg = dataclasses.replace(cfg.smc, **kw)
        assert smc.reference_path(ssm, smc_cfg) == route
        launches = [f.launches for f in kernels]
        calls = [f.calls for f in plain]
        with torch.no_grad():
            out = smc.forward_filter(ssm, torch.Generator(device=dev), ys, smc_cfg)
        assert [f.launches - n for f, n in zip(kernels, launches)] == want, kw
        assert [f.calls for f in plain] == calls
        assert bool(torch.isfinite(out.log_z).all())
    ten = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=10, dy=10))
    ten_ssm = init_ssm(ten, torch.Generator().manual_seed(0), device=dev)
    smc_cfg = dataclasses.replace(ten.smc, ess_threshold=0.5)
    assert smc.reference_path(ten_ssm, smc_cfg) == "trunk"
    launches, calls = trunk.trunk_forward.launches, trunk.trunk_forward_reference.calls
    with torch.no_grad():
        out = smc.forward_filter(ten_ssm, torch.Generator(device=dev),
                                 torch.zeros((8, 6, 10), device=dev), smc_cfg)
    assert trunk.trunk_forward.launches - launches == 5
    assert trunk.trunk_forward_reference.calls == calls
    assert bool(torch.isfinite(out.log_z).all())
    net = NetConfig(hidden=(72, 72))
    wide = cfg.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net)
    wide_ssm = init_ssm(wide, torch.Generator().manual_seed(0), device=dev)
    assert smc.reference_path(wide_ssm, smc_cfg) == "trunk"
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        smc.forward_filter(wide_ssm, torch.Generator(device=dev),
                           torch.zeros((8, 6, 2), device=dev), smc_cfg)


def _trunk_small_operands(preset, dx, di, hidden, dev, b=3, k=256):
    """(x_res, coef, consts, ε) of K9 at preset's width with random weights;
    with di > 0 the coefficient row carries random controls' terms."""
    from psvo_tpu_torch.config import NetConfig as _Net

    cfg = PRESETS[preset]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=di))
    net = _Net(hidden=(hidden, hidden))
    cfg = cfg.with_nets(q0=net, q1=net, q2=net, f=net, g=net, qb=net)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        x_res = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
        coef = torch.rand((b, 4 * dx + 1), generator=g, device=dev) + 0.1
        if di:
            u = 0.5 * torch.randn((1, b, di), generator=g, device=dev)
            coef = torch.cat([coef, fused_step.control_term(consts, u)[0]], -1).contiguous()
        eps = torch.randn((b, dx, k), generator=g, device=dev)
    return x_res, coef, consts, eps


_TRUNK_WIDTHS = [("fhn_fivo_k1024_bench", 2, 0), ("lorenz63_psvo_k1024", 3, 0),
                 ("fhn_fivo_k1024_bench", 2, 2), ("lorenz96_fivo_k8192_sharded", 40, 2)]


@pytest.mark.parametrize("preset, dx, di", _TRUNK_WIDTHS)
@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("rng", [False, True])
def test_trunk_kernels_match_plain_at_small_widths_and_with_controls(preset, dx, di, hidden, rng):
    """K9 and K10 at the FHN and Lorenz-63 widths and in their control mode
    (FHN and Lorenz-96) against their plain versions: K9 allclose 2e-4, K10
    per leaf to 1e-4 relative (the controls' d_coef columns included),
    bit-equal on a relaunch; with zero controls both bit-equal to the
    uncontrolled launch."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    x_res, coef, consts, eps = _trunk_small_operands(preset, dx, di, hidden, dev)
    noise = {"seed": (5, 6), "t": 4} if rng else {"eps": eps}
    if rng:
        eps = fused_step.stream_noise((5, 6), 5, x_res.shape[0], dx, x_res.shape[-1], dev)[0][4]
    with torch.no_grad():
        got = trunk.trunk_forward(x_res, coef, consts, **noise)
        want = trunk.trunk_forward_reference(x_res, coef, consts, eps)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
    g = torch.Generator(device=dev).manual_seed(2)
    d_x_new = torch.randn(got[0].shape, generator=g, device=dev)
    d_alpha = torch.randn(got[1].shape, generator=g, device=dev)
    args = (x_res, got[0], coef, consts, d_x_new, d_alpha)
    back = trunk.trunk_backward(*args, **noise)
    again = trunk.trunk_backward(*args, **noise)
    ref = trunk.trunk_backward_reference(*args[:4], eps, *args[4:])
    for a, a2, w in zip(back, again, ref):
        assert torch.equal(a, a2)
        assert _rel(a, w) <= 1e-4
    if di:
        n0 = 4 * dx + 1
        zero = torch.cat([coef[:, :n0], torch.zeros_like(coef[:, n0:])], -1).contiguous()
        unc = dict(consts, di=0, ctrl_w=None)
        with torch.no_grad():
            z9 = trunk.trunk_forward(x_res, zero, consts, **noise)
            u9 = trunk.trunk_forward(x_res, coef[:, :n0].contiguous(), unc, **noise)
        assert all(torch.equal(a, b) for a, b in zip(z9, u9))
        zb = trunk.trunk_backward(x_res, got[0], zero, consts, d_x_new, d_alpha, **noise)
        ub = trunk.trunk_backward(x_res, got[0], coef[:, :n0].contiguous(), unc, d_x_new,
                                  d_alpha, **noise)
        assert torch.equal(zb[1][:, :n0], ub[1])
        assert all(torch.equal(a, b) for a, b in zip(zb[::2] + zb[3:], ub[::2] + ub[3:]))


@pytest.mark.parametrize("objective", ["psvo", "svo"])
def test_cuda_smoothing_with_a_general_path_model_runs(objective):
    """PSVO and SVO whose forward takes no kernel path (here known dynamics)
    run on the card: the general path's forward (K7/K8 once a step), then
    PSVO's sweep through K5 (its class) and SVO's eagerly (the reference's
    SVO gate excludes known dynamics: no K12); in a train step K11 once a
    step and K6 once for PSVO; no plain version, no K1."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    preset = "lorenz63_psvo_k1024" if objective == "psvo" else "lorenz63_svo_k256"
    cfg = _small_cfg(preset, transition="known")
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (rg.ancestor_indices_large, rg.gather_particles, rg.segment_sum_scatter,
               ffbsi.ffbsi_forward, ffbsi.ffbsi_backward, svo.svo_sweep_forward,
               fused_step.scan_forward)
    plain = (rg.ancestor_indices_large_reference, rg.gather_particles_reference,
             rg.segment_sum_scatter_reference, ffbsi.ffbsi_forward_reference,
             svo.svo_sweep_forward_reference)
    psvo = int(objective == "psvo")
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    with torch.no_grad():
        out = make_objective(ssm, cfg)(torch.Generator(device=dev).manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [5, 5, 0, psvo, 0, 0, 0]
    assert bool(torch.isfinite(out.loss)) and out.smoothed.shape == (6, 4, 16, 3)
    launches = [f.launches for f in kernels]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(
        torch.Generator(device=dev).manual_seed(4), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [5, 5, 5, psvo, psvo, 0, 0]
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def test_cuda_qb_rnn_svo_trains_on_the_eager_sweep():
    """SVO with the qb GRU on the card: the forward through K1 (K4 in the
    backward), the GRU and the q_b sweep eager (no K12/K13, no plain
    version); a finite loss and a nonzero gradient on the GRU."""
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256", qb_rnn=True)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
               svo.svo_sweep_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    before = ssm.gru.z_w.detach().clone()
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(
        torch.Generator(device=dev).manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 0, 0]
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["elbo_svo"])
    assert not torch.equal(ssm.gru.z_w.detach(), before)


def test_cuda_bootstrap_svo_runs_k12_as_its_eager_sweep_would():
    """Bootstrap SVO is in K12/K13's class (the reference's SVO gate has no
    bootstrap test; the sweep reads q_b, f and g only): the forward through
    the general path, the sweep through K12 (K13 in the backward); the loss
    on the same draws equal, within 1e-5, to the eager sweep's on the card."""
    from psvo_tpu_torch import objectives
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256", use_bootstrap=True)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert svo.usable(ssm, cfg.smc.n_smoothing_particles)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    losses = []
    for route in ("kernel", "eager"):
        real = objectives._svo_route
        if route == "eager":
            objectives._svo_route = lambda *a: "eager"
        try:
            launches = (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches)
            out = make_objective(ssm, cfg)(torch.Generator(device=dev).manual_seed(3), ys)
            out.loss.backward()
        finally:
            objectives._svo_route = real
        n = int(route == "kernel")
        assert (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches) == (
            launches[0] + n, launches[1] + n)
        losses.append(float(out.loss))
    assert abs(losses[0] - losses[1]) <= 1e-5 * max(1.0, abs(losses[1])), losses


def test_cuda_sweep_the_port_has_no_class_for_raises_up_front():
    """Where the reference runs its sweep kernel and the port's class does not
    reach (SVO at width 72, M = 32: K12/K13 stop at 64; PSVO at Dx = 912, K =
    128, M = 8: K6 wide's sums stop at Dx = 908), the objective raises
    NotImplementedError naming the class before the forward filter launches
    anything."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    net = NetConfig(hidden=(72, 72))
    svo_cfg = PRESETS["lorenz63_svo_k256"].with_nets(qb=net, f=net, g=net)
    svo_cfg = dataclasses.replace(svo_cfg,
                                  smc=dataclasses.replace(svo_cfg.smc, n_smoothing_particles=32))
    wide = PRESETS["lorenz63_psvo_k1024"]
    wide = dataclasses.replace(wide, data=dataclasses.replace(wide.data, dx=912), smc=dataclasses.replace(
        wide.smc, n_particles=128, n_smoothing_particles=8))
    kernels = (fused_step.scan_forward, trunk.trunk_forward, rg.ancestor_indices_large)
    for cfg, dy, match in ((svo_cfg, 3, "ops.svo.usable"), (wide, 3, "ops.ffbsi.usable")):
        ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
        launches = [f.launches for f in kernels]
        with pytest.raises(NotImplementedError, match=match):
            make_objective(ssm, cfg)(torch.Generator(device=dev),
                                     torch.zeros((2, 6, dy), device=dev))
        assert [f.launches for f in kernels] == launches


@pytest.mark.parametrize("scan_fused", [True, False])
def test_cuda_segmented_psvo_outside_the_whole_scan_class_runs_plain_segments(scan_fused,
                                                                              monkeypatch):
    """Segmented PSVO with ESS-adaptive resampling (outside K1's class), and
    the preset with fused_step.SCAN_FUSED off: the plain step body per
    segment on the card (no K1 or K14): a train step of 5 segments of one
    step (4 with support) under smc.remat launches K7 18 times (the forward,
    the sweep's replays, and both again in the checkpoints' backward), K5 9
    (each segment's sweep twice, t = 0 once) and K6 5; finite."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    if scan_fused:
        cfg = _small_cfg("lorenz63_psvo_k1024", ffbsi_segments=5, ess_threshold=0.5)
    else:
        monkeypatch.setattr(fused_step, "SCAN_FUSED", False)
        cfg = _small_cfg("lorenz63_psvo_k1024", ffbsi_segments=5)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((2, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev) * 5.0
    kernels = (fused_step.scan_forward, fused_step.step_forward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, rg.ancestor_indices_large)
    launches = [f.launches for f in kernels]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(
        torch.Generator(device=dev).manual_seed(3), ys)
    got = [f.launches - n for f, n in zip(kernels, launches)]
    assert got == [0, 0, 9, 5, 18], got
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def _seg_noise(dev, t, b, k, m, dx=3):
    g = torch.Generator(device=dev).manual_seed(11)
    from psvo_tpu_torch.objectives import _gumbel

    u0 = torch.rand((t - 1, b), generator=g, device=dev)
    gum = _gumbel(g, (t, b, m, k))
    return (torch.randn((b, dx, k), generator=g, device=dev),
            torch.randn((t - 1, b, dx, k), generator=g, device=dev),
            fused_step.systematic_positions(u0, k), gum[0], gum[1:])


@pytest.mark.parametrize("bound", ["forward", "direct"])
def test_cuda_segmented_psvo_matches_unsegmented(bound):
    """Segmented PSVO (S = 4) against S = 1 on the card, on the same streams
    and Gumbels (T = 17, B = 4, K = 128, M = 8): the forward's log Ẑ,
    increments and last particles, each replayed segment and the smoothed
    paths bit-equal; the loss within 1e-6 and every gradient leaf within
    1e-4 relative L2 (the sums are only reassociated); K1, K4, K5 and K6
    each launched, no plain version called."""
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.objectives import make_objective

    dev = _cuda()
    t, b, m = 17, 4, 8
    cfg = _small_cfg("lorenz63_psvo_k1024", psvo_bound=bound, n_smoothing_particles=m)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t))
    noise = _seg_noise(dev, t, b, 128, m)
    ys = torch.randn((b, t, 3), generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev) * 5.0
    seg_cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, ffbsi_segments=4))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    with torch.no_grad():
        whole = smc.forward_filter(ssm, None, ys, cfg.smc, cache=True, noise=noise[:3])
        fwd, cache = smc.forward_filter_segmented(ssm, None, ys, seg_cfg.smc, 4, noise=noise[:3])
        for name in ("log_z", "increments", "x_last", "logw_last"):
            assert torch.equal(getattr(fwd, name), getattr(whole, name)), name
        for s in range(4):
            xs, logws = smc.recompute_segment(cache, s)
            assert torch.equal(xs, whole.xs[1 + 4 * s:5 + 4 * s])
            assert torch.equal(logws, whole.logws[1 + 4 * s:5 + 4 * s])
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward)
    calls = [f.calls for f in plain]
    outs, grads = [], []
    for c in (cfg, seg_cfg):
        launches = [f.launches for f in kernels]
        out = make_objective(ssm, c)(None, ys, noise=noise)
        for p in ssm.parameters():
            p.grad = None
        out.loss.backward()
        assert all(f.launches > n for f, n in zip(kernels, launches))
        outs.append(out)
        grads.append([p.grad.clone() for p in ssm.parameters() if p.grad is not None])
    assert [f.calls for f in plain] == calls
    assert torch.equal(outs[1].smoothed, outs[0].smoothed)
    loss = [float(o.loss.detach()) for o in outs]
    assert abs(loss[1] - loss[0]) <= 1e-6 * abs(loss[0])
    assert len(grads[0]) == len(grads[1])
    for a, w in zip(grads[1], grads[0]):
        assert _rel(a, w) <= 1e-4


# -- controlled smoothing (K12/K13's control mode) and multinomial resampling ---------------


def _controlled_svo_operands(dev, hidden, preset="lorenz63_svo_k256", b=4, m=8, t1=9, seed=0):
    """An SVO sweep's operands with Di = 2 controls: `_svo_operands` on the
    preset with data.di = 2, and f's control bias from controls at scale 0.5."""
    from psvo_tpu_torch.ops import svo

    _, consts, ops = _svo_operands(dev, hidden, preset, b=b, m=m, t1=t1, seed=seed, di=2)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    u = 0.5 * torch.randn((t1, b, 2), generator=g, device=dev)
    with torch.no_grad():
        cbias = svo.control_term(consts, u)
    return consts, ops, cbias


@pytest.mark.parametrize("preset,hidden,b,m,t1", [
    ("lorenz63_svo_k256", (16,), 4, 8, 9), ("lorenz63_svo_k256", (16, 16), 4, 3, 40),
    ("fhn_fivo_k1024_bench", (32, 32), 8, 16, 20), ("lorenz63_svo_k256", (64, 64), 32, 16, 99)])
def test_controlled_svo_kernels_match_plain(preset, hidden, b, m, t1):
    """K12 and K13 in their control mode (f's first layer from b1 + cbias)
    against their plain versions: K12's four outputs to 1e-5 (lp/lq to 1e-5
    relative, atol 1e-3), K13 on K12's x~ with every cotangent (zeroed on the
    paths with a relu tie) within 1e-4 relative L2 per leaf, d_cbias
    included, and bit-equal on a second launch. M = 3 puts a CTA group's
    paths across rows, so a row's d_cbias adds partial rows of two groups.
    The chain designs take no controls."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    consts, ops, cbias = _controlled_svo_operands(dev, hidden, preset, b, m, t1)
    launches = (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches)
    with torch.no_grad():
        got = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
        want = svo.svo_sweep_forward_reference(*ops, consts, cbias)
    for i in (0, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5)
    for i in (1, 2):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-3)
    keep = (~_svo_relu_ties(consts, ops, got[3], cbias=cbias)).float()
    g = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in got]
    cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep, cots[3] * keep[..., None]]
    k13 = svo.svo_sweep_backward(*ops, consts, got[3], *cots, cbias=cbias)
    ref = svo.svo_sweep_backward_reference(*ops, consts, got[3], *cots, cbias=cbias)
    again = svo.svo_sweep_backward(*ops, consts, got[3], *cots, cbias=cbias)
    assert len(k13) == len(ref) == 4
    for a, w in zip(k13, ref):
        assert _rel(a, w) <= 1e-4
    assert all(torch.equal(a, c) for a, c in zip(k13, again))
    assert (svo.svo_sweep_forward.launches, svo.svo_sweep_backward.launches) == (
        launches[0] + 1, launches[1] + 2)
    with pytest.raises(ValueError, match="no controls"):
        svo.svo_sweep_forward(*ops, consts, design="chain", cbias=cbias)
    with pytest.raises(ValueError, match="no controls"):
        svo.svo_sweep_backward(*ops, consts, got[3], design="chain", cbias=cbias)


def test_controlled_svo_kernels_with_zero_controls_keep_the_uncontrolled_bits():
    """The control mode with a zero bias gives the uncontrolled launch's K12
    outputs and K13 leaves bit for bit (adding +0 to b1 changes no finite
    value), and d_cbias equals the sum over each row's paths of what the
    plain version gives."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    consts, ops, cbias = _controlled_svo_operands(dev, (16, 16), b=4, m=8, t1=12)
    zero = torch.zeros_like(cbias)
    with torch.no_grad():
        ctl = svo.svo_sweep_forward(*ops, consts, cbias=zero)
        unc = svo.svo_sweep_forward(*ops, consts)
    assert all(torch.equal(a, b) for a, b in zip(ctl, unc))
    g = torch.Generator(device=dev).manual_seed(9)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in ctl]
    k13c = svo.svo_sweep_backward(*ops, consts, ctl[3], *cots, cbias=zero)
    k13u = svo.svo_sweep_backward(*ops, consts, ctl[3], *cots)
    assert all(torch.equal(a, b) for a, b in zip(k13c[:3], k13u))
    ref = svo.svo_sweep_backward_reference(*ops, consts, ctl[3], *cots, cbias=zero)
    assert _rel(k13c[3], ref[3]) <= 1e-4


@pytest.mark.parametrize("objective,bound", [("psvo", "forward"), ("psvo", "direct"),
                                             ("svo", "forward")])
def test_controlled_smoothing_train_step_runs_the_kernels(objective, bound):
    """One controlled PSVO (both bounds) or SVO train step (Di = 2, hidden
    16) on the card: K1, K4 and K5/K6 (PSVO) or K12/K13 (SVO) once each, no
    plain version; its loss and raw gradients, W_u's rows included, match
    the plain versions on CPU tensors on the same draws (the whole-scan
    class's plain versions, as on the card) to 1e-4 and 1e-3 relative per
    leaf."""
    from psvo_tpu_torch import bridge, objectives
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.smc import _forward_filter_fused

    dev = _cuda()
    preset = "lorenz63_psvo_k1024" if objective == "psvo" else "lorenz63_svo_k256"
    cfg = _small_cfg(preset)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, di=2),
                              smc=dataclasses.replace(cfg.smc, psvo_bound=bound,
                                                      n_smoothing_particles=8))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, t, k, m = 4, 6, cfg.smc.n_particles, 8
    g = torch.Generator().manual_seed(2)
    ys, u = torch.randn((b, t, 3), generator=g) * 3.0, torch.randn((b, t, 2), generator=g) * 0.5
    noise = [torch.randn((b, 3, k), generator=g), torch.randn((t - 1, b, 3, k), generator=g),
             fused_step.systematic_positions(torch.rand((t - 1, b), generator=g), k),
             objectives._gumbel(g, (b, m, k))]
    noise.append(objectives._gumbel(g, (t - 1, b, m, k)) if objective == "psvo"
                 else torch.randn((t - 1, b, m, 3), generator=g))
    second = (ffbsi.ffbsi_forward, ffbsi.ffbsi_backward) if objective == "psvo" else (
        svo.svo_sweep_forward, svo.svo_sweep_backward)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, *second)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    out = objectives.make_objective(ssm, cfg)(None, ys.to(dev), noise=[n.to(dev) for n in noise],
                                              controls=u.to(dev))
    out.loss.backward()
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 1, 1]
    assert [f.calls for f in plain] == calls

    def fused_filter(ssm_, generator, ys_, cfg_, *, cache, encoder_inputs, noise, controls):
        return _forward_filter_fused(ssm_, generator, ys_, cfg_, cache=cache,
                                     encoder_inputs=encoder_inputs, streams=noise,
                                     controls=controls)

    real = objectives.forward_filter
    objectives.forward_filter = fused_filter
    try:
        want = objectives.make_objective(ref, cfg)(None, ys, noise=noise, controls=u)
    finally:
        objectives.forward_filter = real
    want.loss.backward()
    got_loss, want_loss = float(out.loss.detach()), float(want.loss.detach())
    assert abs(got_loss - want_loss) <= 1e-4 * (1 + abs(want_loss))
    got_g, want_g = bridge.grads_to_numpy(ssm), bridge.grads_to_numpy(ref)
    for name in want_g:
        for a, w in zip(_leaves(got_g[name]), _leaves(want_g[name])):
            assert _rel(torch.from_numpy(a), torch.from_numpy(w)) <= 1e-3, name


@pytest.mark.parametrize("dx, k, cluster", [(2, 128, 1), (2, 1024, 1), (2, 1024, 2),
                                            (3, 1024, 4), (3, 2048, 8)])
def test_multinomial_scan_and_step_kernels_match_plain(dx, k, cluster):
    """K1 on sorted multinomial positions (iid uniforms, sorted per row; they
    bunch where the weight is, so a CTA of a cluster searches CDF parts that
    other CTAs own): every step's ancestors equal the plain version's count
    form on K1's own incoming weights, teacher-forced, at each cluster size;
    outputs bit-equal to one CTA per row; a chain of K14 launches on the same
    positions gives K1's bits; K4 and K15 read only the saved ancestors."""
    dev = _cuda()
    net = NetConfig(hidden=(16, 16))
    preset = "fhn_fivo_k1024_bench" if dx == 2 else "lorenz63_psvo_k1024"
    cfg = PRESETS[preset].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                    g=dataclasses.replace(net, sigma_init=0.5))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    b, t1 = 4, 6
    x0 = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
    a0 = torch.randn((b, k), generator=g, device=dev) * 2.0
    coef = torch.rand((t1, b, 4 * dx + 1), generator=g, device=dev) + 0.1
    eps = torch.randn((t1, b, dx, k), generator=g, device=dev)
    pos = torch.sort(torch.rand((t1, b, k), generator=g, device=dev), dim=-1).values
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        got = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                      save_res=True, cluster=cluster)
        one = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                      save_res=True, cluster=1)
        assert all(torch.equal(a, w) for a, w in zip(got, one))
        lw = torch.cat([a0[None], got[4][:-1]])
        for t in range(t1):
            want = fused_step.count_form_indices(lw[t], pos[t])
            assert torch.equal(got[5][t], want), t
        x, lwc = x0, a0
        for t in range(t1):
            x, lwc, st, idx = fused_step.step_forward(x, lwc, coef[t], consts, eps[t], pos[t])
            assert torch.equal(idx, got[5][t]) and torch.equal(x, got[3][t])
        if k == 128:
            want = fused_step.scan_forward_reference(x0, a0, coef, consts, eps, pos, cache=True)
            for a, w in zip(got[:5], want[:5]):
                torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("scan_fused", [True, False])
def test_multinomial_train_step_runs_the_kernels(monkeypatch, scan_fused):
    """One FIVO train step with multinomial resampling on the card: K1 and
    K4 once (K14/K15 T − 1 times with SCAN_FUSED off), on streamed noise
    even under kernel_rng (K1's in-kernel draw makes systematic positions
    only), no K2 or plain version; the Lorenz-96 trunk path with
    multinomial positions launches K7, K8 and K9 once a step."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    monkeypatch.setattr(fused_step, "SCAN_FUSED", scan_fused)
    dev = _cuda()
    cfg = _small_cfg("fhn_fivo_k1024_bench")
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, resampling="multinomial",
                                                           kernel_rng=True),
                              train=dataclasses.replace(cfg.train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
               fused_step.step_backward, fused_step.stream_noise)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             fused_step.step_forward_reference, fused_step.step_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(
        torch.Generator(device=dev).manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == (
        [1, 1, 0, 0, 0] if scan_fused else [0, 0, 5, 5, 0])
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    l96 = PRESETS["lorenz96_fivo_k8192_sharded"]
    net = NetConfig(hidden=(16, 16))
    l96 = dataclasses.replace(l96.with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net),
                              smc=dataclasses.replace(l96.smc, n_particles=256,
                                                      resampling="multinomial"))
    lssm = init_ssm(l96, torch.Generator().manual_seed(0), device=dev)
    assert trunk.usable(lssm, l96.smc)
    from psvo_tpu_torch.smc import forward_filter

    tk = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward)
    before = [f.launches for f in tk]
    with torch.no_grad():
        fwd = forward_filter(lssm, torch.Generator(device=dev).manual_seed(4),
                             torch.randn((2, 5, 40), device=dev), l96.smc)
    assert [f.launches - n for f, n in zip(tk, before)] == [4, 4, 4]
    assert bool(torch.isfinite(fwd.log_z).all())


# ---------------------------------------------------------------------------
# The whole-step class beyond the presets' shapes (shape libraries, plans)
# ---------------------------------------------------------------------------


def _class_cfg(hidden, preset="fhn_fivo_k1024_bench", k=256, t=6, **data):
    """preset with q1/f/g at the widths `hidden`, the data changes, K
    particles, T steps and one train step a call."""
    cfg = PRESETS[preset]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t, **data),
                              smc=dataclasses.replace(cfg.smc, n_particles=k),
                              train=dataclasses.replace(cfg.train, steps_per_call=1))
    return cfg.with_nets(**{n: dataclasses.replace(cfg.net(n), hidden=hidden)
                            for n in ("q1", "f", "g")})


def _class_operands(dev, cfg, b=2, t1=4, seed=0):
    """K1's operands on the card at cfg's shape (random weights; with
    controls the coef rows end in random first-layer terms)."""
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
    dx, k = cfg.data.dx, cfg.smc.n_particles
    x0 = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
    a0 = torch.randn((b, k), generator=g, device=dev)
    coef = torch.rand((t1, b, fused_step.coef_width(consts)), generator=g, device=dev) + 0.1
    eps = torch.randn((t1, b, dx, k), generator=g, device=dev)
    pos = fused_step.systematic_positions(torch.rand((t1, b), generator=g, device=dev), k)
    return consts, x0, a0, coef.contiguous(), eps, pos, g


def _run_class_kernels(consts, x0, a0, coef, eps, pos, g):
    """K1 (cache and residuals), K4 on its residuals with random
    cotangents, the chain of K14 launches and the K15 launch of every step,
    on one set of operands. Returns their outputs."""
    with torch.no_grad():
        k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos, cache=True,
                                     save_res=True)
        x_last, a_last, stats, x_all, a_all, idx = k1
        d_stats = torch.randn(stats.shape, generator=g, device=x0.device)
        cots = [torch.randn(t_.shape, generator=g, device=x0.device) * 0.1
                for t_ in (x_last, a_last, x_all, a_all)]
        k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, *cots, eps=eps)
        x, lw, k14, k15 = x0, a0, [], []
        for t in range(coef.shape[0]):
            k14.append(fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t]))
            x, lw = k14[-1][:2]
        for t in range(coef.shape[0]):
            x_in = x0 if t == 0 else k14[t - 1][0]
            k15.append(fused_step.step_backward(x_in, *k14[t][:1], k14[t][3], k14[t][2], coef[t],
                                                consts, eps[t], d_stats[t], cots[2][t],
                                                cots[3][t]))
    return dict(k1=k1, k4=k4, k14=k14, k15=k15, d_stats=d_stats, cots=cots)


@pytest.mark.parametrize("dx, dy, di, hidden, k", [
    (2, 2, 0, (64,), 256), (2, 2, 0, (64, 64, 64), 256), (3, 1, 0, (48, 48), 384),
    (5, 5, 2, (8, 8), 2048), (1, 1, 0, (24,), 384), (3, 3, 0, (64, 64, 64), 512),
    (2, 2, 0, (64,) * 4, 256), (7, 7, 0, (64, 64, 64), 2048), (2, 2, 0, (48,) * 5, 256),
])
def test_class_kernels_match_plain_at_new_shapes(dx, dy, di, hidden, k):
    """K1, K4, K14 and K15 at shapes of the whole-step class outside the
    presets' (each of the plans of fused_step.k1_plan / k4_plan, Dy != Dx,
    widths 8-64, one to five layers, controls, K not a multiple of 256),
    from shape libraries or the kernels' own: K1 teacher-forced against
    scan_forward_reference (the same ancestors, values within 2e-4), K4 on its
    residuals against scan_backward_reference (1e-4 per leaf, relative L2),
    the chain of K14 launches bit-equal to K1 and each K15 within 1e-4 of
    step_backward_reference."""
    _check_class_shape(dx, dy, di, hidden, k)


def _check_class_shape(dx, dy, di, hidden, k):
    """test_class_kernels_match_plain_at_new_shapes' checks at one shape."""
    dev = _cuda()
    cfg = _class_cfg(hidden, k=k, dx=dx, dy=dy, di=di, control_scale=0.5)
    consts, x0, a0, coef, eps, pos, g = _class_operands(dev, cfg)
    assert fused_step.shape_fits(consts, k)
    out = _run_class_kernels(consts, x0, a0, coef, eps, pos, g)
    x_last, a_last, stats, x_all, a_all, idx = out["k1"]
    t1, b = coef.shape[:2]
    x_prev = torch.cat([x0[None], x_all[:-1]]).reshape(t1 * b, dx, k)
    a_prev = torch.cat([a0[None], a_all[:-1]]).reshape(t1 * b, k)
    ref = fused_step.scan_forward_reference(
        x_prev.contiguous(), a_prev.contiguous(), coef.reshape(1, t1 * b, -1), consts,
        eps.reshape(1, t1 * b, dx, k), pos.reshape(1, t1 * b, k), cache=True, save_res=True)
    assert torch.equal(ref[5].reshape(t1, b, k), idx)
    torch.testing.assert_close(ref[3].reshape(t1, b, dx, k), x_all, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(ref[4].reshape(t1, b, k), a_all, rtol=2e-4, atol=2e-4)
    want = fused_step.scan_backward_reference(x0, coef, consts, eps, idx, out["d_stats"],
                                              *out["cots"])
    for a, w in zip(out["k4"], want):
        assert _rel(a, w) <= 1e-4
    for i, w in ((0, x_all), (1, a_all), (2, stats), (3, idx)):
        assert torch.equal(torch.stack([s[i] for s in out["k14"]]), w)
    for t, got in enumerate(out["k15"]):
        x_in = x0 if t == 0 else x_all[t - 1]
        want = fused_step.step_backward_reference(x_in, coef[t], consts, eps[t], idx[t],
                                                  out["d_stats"][t], out["cots"][2][t],
                                                  out["cots"][3][t])
        for a, w in zip(got, want):
            assert _rel(a, w) <= 1e-4


def test_plans_give_the_same_bits(monkeypatch):
    """At a preset's shape (Dx = 2, hidden (16, 16)), K1/K14 with the weights
    in device memory and K4/K15 under each plan of fused_step.K4_PLANS
    (forced, each from its own shape library) give the bits of the library's
    all-in-shared-memory kernels."""
    from psvo_tpu_torch.ops import _build

    dev = _cuda()
    cfg = _class_cfg((16, 16), k=512)
    consts, x0, a0, coef, eps, pos, g = _class_operands(dev, cfg)
    state = g.get_state()
    assert fused_step._lib_key(consts, False) is None and fused_step._lib_key(consts, True) is None
    want = _run_class_kernels(consts, x0, a0, coef, eps, pos, g)
    keys = [(2, 2, 16, 1, 1, fused_step.K4_PLANS.index(p)) for p in fused_step.K4_PLANS]
    for th in _build.prebuild_shapes(keys):
        th.join()
    # the gates' answers are cached by shape: forced plans must not outlive the test
    caches = (fused_step._lib_key_of, fused_step._k1_fits, fused_step._k4_fits,
              fused_step._k15_fits, fused_step._resident_at, fused_step._k4_tile)
    try:
        for plan in fused_step.K4_PLANS:
            monkeypatch.setattr(fused_step, "_k1_plan", lambda shape: "stream")
            monkeypatch.setattr(fused_step, "_k4_plan", lambda shape, k=None, p=plan: p)
            for f in caches:
                f.cache_clear()
            assert fused_step._lib_key(consts, True) == keys[fused_step.K4_PLANS.index(plan)]
            g.set_state(state)
            got = _run_class_kernels(consts, x0, a0, coef, eps, pos, g)
            for name in ("k1", "k4"):
                assert all(torch.equal(a, w) for a, w in zip(got[name], want[name])), (plan, name)
            for name in ("k14", "k15"):
                for s_got, s_want in zip(got[name], want[name]):
                    assert all(torch.equal(a, w) for a, w in zip(s_got, s_want)), (plan, name)
    finally:
        for f in caches:
            f.cache_clear()


def test_depth_one_fhn_train_step_runs_k1_and_k4():
    """The FHN preset with one hidden layer of 64 in q1, f and g (the
    reference's whole-step class; ROADMAP queue 2 B.1): one make_train_step
    step on the card launches K1 and K4 once each and no plain version, and
    leaves the raw gradient of the plain versions on CPU tensors replaying
    its draws (the CUDA generator's eps0 and seed, K2's streams) within
    chip_smoke.py's CPU_TOL (norm 1%, cosine 0.99): the two free runs may
    part at an ancestor whose CDF boundary a last-bit difference crosses,
    which moves single leaves by percents (q1's by 1.6% in one run)."""
    from psvo_tpu_torch.smc import _forward_filter_fused
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _class_cfg((64,), k=256)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    launches = (fused_step.scan_forward.launches, fused_step.scan_backward.launches)
    calls = (fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls)
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys.to(dev))
    assert (fused_step.scan_forward.launches, fused_step.scan_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert (fused_step.scan_forward_reference.calls,
            fused_step.scan_backward_reference.calls) == calls
    assert torch.isfinite(metrics["loss"])
    gen.set_state(state)
    eps0 = torch.randn((4, 2, 256), generator=gen, device=dev)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    eps, u0 = fused_step.stream_noise_reference(seed, 5, 4, 2, 256)
    fwd = _forward_filter_fused(ref, None, ys, cfg.smc, cache=False,
                                streams=(eps0.cpu(), eps, fused_step.systematic_positions(u0, 256)))
    (-torch.mean(fwd.log_z)).backward()
    got, want = (torch.cat([torch.zeros(p.numel()) if p.grad is None
                            else p.grad.reshape(-1).cpu() for p in m.parameters()]).double()
                 for m in (ssm, ref))
    assert abs(float(got.norm() / want.norm()) - 1.0) <= 1e-2
    assert float(got @ want / (got.norm() * want.norm())) >= 0.99


def test_dy1_psvo_train_step_runs_k1_k4_k5_k6():
    """PSVO on Lorenz-63 seen through one channel (Dy = 1, the reference's
    drawn projection) with q1, f and g of (48, 48): one make_train_step step
    on the card launches K1, K4, K5 and K6 once each, no plain version, with
    a finite loss; smooth_posterior launches K1 and K5 once."""
    from psvo_tpu_torch.infer import smooth_posterior
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _class_cfg((48, 48), preset="lorenz63_psvo_k1024", k=256, t=8, dy=1)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert fused_step.usable(ssm, cfg.smc) and ffbsi.usable(3, 16, cfg.smc.n_particles, False)
    ys = torch.randn((4, 8, 1), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward, rg.ancestor_indices_large)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 1, 1, 0]
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"])
    launches = [f.launches for f in kernels]
    paths = smooth_posterior(ssm, ys, cfg, torch.Generator(device=dev))
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 0, 1, 0, 0]
    assert tuple(paths.shape) == (4, 16, 8, 3) and bool(torch.isfinite(paths).all())


@pytest.mark.parametrize("hidden", [(2048, 2048), (64,) * 14])
def test_outside_the_class_raises_before_any_launch(hidden):
    """Two layers of 2048, or 14 hidden layers of 64, more than any plan's
    shared memory holds (at Dy = 1, where the trunk class does not take them
    either): the reference runs its whole-step
    kernel (reference_path "fused"), the port's class stops
    (fused_step.usable), and the filter, a train step and the segmented
    forward raise NotImplementedError naming ROADMAP queue 2 B before
    launching anything."""
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _class_cfg(hidden, k=256, t=5, dy=1)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert smc.reference_path(ssm, cfg.smc) == "fused" and not fused_step.usable(ssm, cfg.smc)
    assert not trunk.usable(ssm, cfg.smc)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, fused_step.step_forward,
               fused_step.stream_noise, trunk.trunk_forward, rg.ancestor_indices_large,
               rg.gather_particles)
    launches = [f.launches for f in kernels]
    ys = torch.zeros((2, 5, 1), device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 B"):
        smc.forward_filter(ssm, torch.Generator(device=dev), ys, cfg.smc)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 B"):
        make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev), ys)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2 B"):
        smc.forward_filter_segmented(ssm, torch.Generator(device=dev), ys, cfg.smc, 2)
    assert [f.launches for f in kernels] == launches


# ---- resampling at every K, and the trunk class beyond the library's shapes ----

_ANY_K = [1, 255, 300, 384, 1000, 4096, 19456, 24576, 32768]


@pytest.mark.parametrize("k", _ANY_K)
def test_k7_takes_every_k_up_to_its_cap(k):
    """K7's cluster design at K that are not whole chunks of 256 and above
    the row design's cap gives the plain version's indices on the
    adversarial rows, systematic and sorted multinomial positions, at the C
    that k7_cluster picks and through the C entry point at every C that
    holds K, with the whole CDF in each CTA and spread over the cluster
    wherever each fits; the row design too where its row fits a CTA."""
    from psvo_tpu_torch.ops import _build
    from psvo_tpu_torch.ops import resample_gather as rg

    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(7)
    logw = _weight_rows(k, dev)
    b = logw.shape[0]
    systematic = fused_step.systematic_positions(torch.rand((b,), generator=gen, device=dev),
                                                 k).contiguous()
    multinomial = torch.sort(torch.rand((b, k), generator=gen, device=dev), -1).values.contiguous()
    for pos in (systematic, multinomial):
        want = rg.ancestor_indices_large_reference(logw, pos)
        assert torch.equal(rg.ancestor_indices_large(logw, pos), want)
        if rg.k7_row_ok(k):
            assert torch.equal(rg.ancestor_indices_large(logw, pos, design="row"), want)
    want = rg.ancestor_indices_large_reference(logw, systematic)
    lib = _build.load_library()
    for c in rg.CLUSTER_SIZES:
        if c > 1 and k < c * 256:
            continue
        for spread in (False, True):
            if rg.k7_cluster_smem_bytes(k, c, spread) > fused_step.SMEM_LIMIT:
                continue
            idx = torch.empty((b, k), dtype=torch.int32, device=dev)
            err = lib.psvo_ancestor_indices_large(logw.data_ptr(), systematic.data_ptr(),
                                                  idx.data_ptr(), b, k, 0, c, int(spread),
                                                  torch.cuda.current_stream().cuda_stream)
            _build.check(lib, err, "ancestor_indices_large")
            assert torch.equal(idx, want), (c, spread)


def test_k11_at_its_cap_and_the_eager_indices_above_it():
    """K11 at K = 32768 (8 tiles of 4096) within 1e-6 of float64, childless
    sources 0, the same bits on a relaunch. Above K7's cap resample_and_gather
    takes the count form as tensor ops on the card and gathers through K8
    (no K7 launch, no plain version); a train step there raises before any
    launch (K11's cap)."""
    from psvo_tpu_torch import smc
    from psvo_tpu_torch.ops import resample_gather as rg

    dev = _cuda()
    k = rg.MAX_K
    gen = torch.Generator(device=dev).manual_seed(8)
    logw = _weight_rows(k, dev)
    b = logw.shape[0]
    pos = fused_step.systematic_positions(torch.rand((b,), generator=gen, device=dev),
                                          k).contiguous()
    idx = rg.ancestor_indices_large(logw, pos)
    g = torch.randn((b, 40, k), generator=gen, device=dev)
    assert rg.k11_plan(k) == (16, 8)
    got = rg.segment_sum_scatter(g, idx)
    assert torch.equal(got, rg.segment_sum_scatter(g, idx))
    want = rg.segment_sum_scatter_reference(g.double(), idx)
    assert _rel(got.double(), want) <= 1e-6
    assert bool((got[want == 0] == 0).all())

    big = k + 4096
    logw = _weight_rows(big, dev)
    pos = fused_step.systematic_positions(torch.rand((b,), generator=gen, device=dev),
                                          big).contiguous()
    x = torch.randn((b, 3, big), generator=gen, device=dev)
    counts = (rg.resample_and_gather.eager_calls, rg.ancestor_indices_large.launches,
              rg.gather_particles.launches, rg.ancestor_indices_large_reference.calls)
    idx, x_res = rg.resample_and_gather(pos, logw, x)
    assert (rg.resample_and_gather.eager_calls - counts[0], rg.ancestor_indices_large.launches
            - counts[1], rg.gather_particles.launches - counts[2],
            rg.ancestor_indices_large_reference.calls - counts[3]) == (1, 0, 1, 0)
    assert torch.equal(idx, fused_step.count_form_indices(logw, pos))
    assert torch.equal(x_res, torch.gather(x, -1, idx.long()[:, None, :].expand(-1, 3, -1)))

    cfg = _small_cfg("fhn_fivo_k128")
    cfg = dataclasses.replace(cfg, smc=dataclasses.replace(cfg.smc, n_particles=big))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert smc.backward_hole(ssm, cfg.smc)
    launches = (rg.ancestor_indices_large.launches, rg.gather_particles.launches)
    with pytest.raises(NotImplementedError, match="K11"):
        smc.forward_filter(ssm, torch.Generator(device=dev), torch.zeros((2, 6, 2), device=dev),
                           cfg.smc)
    assert (rg.ancestor_indices_large.launches, rg.gather_particles.launches) == launches


# (preset, dx, dy, di, hidden, depth): shapes beyond the kernels' library, each plan
_REACH = [("lorenz96_fivo_k8192_sharded", 20, 20, 0, 64, 2),  # Lorenz-96 at D = 20
          ("fhn_fivo_k1024_bench", 2, 1, 0, 48, 2),  # FHN seen through one channel
          ("lorenz96_fivo_k8192_sharded", 5, 5, 2, 8, 3),  # controls, width 8
          ("lorenz96_fivo_k8192_sharded", 55, 55, 0, 64, 2),  # K10's weights in device memory
          ("lorenz96_fivo_k8192_sharded", 40, 40, 0, 64, 3)]  # K9's and K10's too


@pytest.mark.parametrize("preset, dx, dy, di, hidden, depth", _REACH)
@pytest.mark.parametrize("rng", [False, True])
def test_trunk_kernels_beyond_the_library(preset, dx, dy, di, hidden, depth, rng):
    """K9 and K10 from a trunk shape library at (Dx, Dy, Di, width, depth)
    outside the kernels' library, with their weights in shared or device
    memory as the plans say, against their plain versions: K9 allclose
    2e-4, K10 per leaf to 1e-4 relative, bit-equal on a relaunch, the simt
    design."""
    from psvo_tpu_torch.ops import trunk

    dev = _cuda()
    cfg = PRESETS[preset]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, di=di))
    net = NetConfig(hidden=(hidden,) * depth)
    cfg = cfg.with_nets(q0=net, q1=net, q2=net, f=net, g=net, qb=net)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert trunk.usable(ssm, cfg.smc)
    n_mid = depth - 1
    key = trunk.lib_key(dx, dy, hidden, n_mid, True)
    assert key is not None and key == trunk.lib_key(dx, dy, hidden, n_mid, False)
    b, k = 3, 256
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        consts = fused_step.prepare(ssm)
        x_res = torch.randn((b, dx, k), generator=g, device=dev) * 2.0
        coef = torch.rand((b, 3 * dx + dy + 1), generator=g, device=dev) + 0.1
        if di:
            u = 0.5 * torch.randn((1, b, di), generator=g, device=dev)
            coef = torch.cat([coef, fused_step.control_term(consts, u)[0]], -1).contiguous()
        eps = torch.randn((b, dx, k), generator=g, device=dev)
    noise = {"seed": (5, 6), "t": 4} if rng else {"eps": eps}
    if rng:
        eps = fused_step.stream_noise((5, 6), 5, b, dx, k, dev)[0][4]
    k10 = dict(trunk.trunk_backward.launches_by_design)
    with torch.no_grad():
        got = trunk.trunk_forward(x_res, coef, consts, **noise)
        want = trunk.trunk_forward_reference(x_res, coef, consts, eps)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
    d_x_new = torch.randn(got[0].shape, generator=g, device=dev)
    d_alpha = torch.randn(got[1].shape, generator=g, device=dev)
    args = (x_res, got[0], coef, consts, d_x_new, d_alpha)
    back = trunk.trunk_backward(*args, **noise)
    again = trunk.trunk_backward(*args, **noise)
    ref = trunk.trunk_backward_reference(*args[:4], eps, *args[4:])
    for a, a2, w in zip(back, again, ref):
        assert torch.equal(a, a2)
        assert _rel(a, w) <= 1e-4
    assert {d: trunk.trunk_backward.launches_by_design[d] - n for d, n in k10.items()} == {
        "tf32x3": 0, "simt": 2}


# ---------------------------------------------------------------------------
# the smoothing sweeps at the reference's reach: K5/K6's wide kernels (any Dx,
# M past 256), K12/K13 over the reference's SVO class (shape libraries)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dx,b,m,k,t1", [(40, 4, 16, 1024, 9), (3, 2, 512, 1024, 5),
                                         (4, 8, 4096, 2048, 3)])
def test_wide_ffbsi_kernels_match_plain(dx, b, m, k, t1):
    """K5 (the wide kernel at Dx = 40 and at M = 4096, K = 2048; the staged
    one at Dx = 3, M = 512)
    picks the plain version's particle on every (t, row, path), its x~,
    x_first and logp within 1e-6 relative L2; K6's wide kernel per leaf
    within 1e-3 relative L2 of the plain version in every cotangent mode;
    both bit-equal on a relaunch."""
    dev = _cuda()
    ops = _sweep(dev, dx, b=b, m=m, k=k, t1=t1, seed=dx)
    got = ffbsi.ffbsi_forward(*ops)
    want = ffbsi.ffbsi_forward_reference(*ops)
    again = ffbsi.ffbsi_forward(*ops)
    assert torch.equal(got[4], want[4])
    for i in (0, 1, 3):
        assert _rel(got[i], want[i]) <= 1e-6
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert ffbsi.staged_kernel(dx, m, backward=True) == "wide"
    g = torch.Generator(device=dev).manual_seed(9)
    cots = [torch.randn(t.shape, generator=g, device=dev) for t in got[:4]]
    names = ("d_x_first", "d_logp", "d_logq", "d_xtilde")
    args = (*ops[:7], got[4], got[3])
    for live in ((0, 1, 2, 3), (2, 3), (0, 3)):
        kw = {n: cots[i] if i in live else None for i, n in enumerate(names)}
        needs = (True,) * 5 if 1 in live or 2 in live else (False,) * 5
        k6 = ffbsi.ffbsi_backward(*args, needs=needs, **kw)
        ref = ffbsi.ffbsi_backward_reference(*args, needs=needs, **kw)
        for a, w in zip(k6, ref):
            assert (a is None) == (w is None)
            if a is not None:
                assert _rel(a, w) <= 1e-3
        assert all(a is None or torch.equal(a, c)
                   for a, c in zip(k6, ffbsi.ffbsi_backward(*args, needs=needs, **kw)))


def _class_svo_operands(dev, dx, dy, di, h, b=4, m=32, t1=9, seed=0):
    """An SVO sweep's operands on the card at (Dx, Dy, Di, width h): the
    Lorenz-63 SVO preset reshaped, nudged random weights, anchors, ε,
    observations and (with di) f's control bias."""
    from psvo_tpu_torch.ops import svo

    net = NetConfig(hidden=(h, h))
    cfg = PRESETS["lorenz63_svo_k256"].with_nets(qb=net, f=net, g=net)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dx=dx, dy=dy, di=di))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for p in ssm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
        consts = svo.prepare(ssm)
        cbias = None
        if di:
            u = torch.randn((t1, b, di), generator=g, device=dev)
            cbias = svo.control_term(consts, u).contiguous()
    x_anchor = torch.randn((b, m, dx), generator=g, device=dev) * 3.0
    eps = torch.randn((t1, b, m, dx), generator=g, device=dev)
    y = torch.randn((t1, b, dy), generator=g, device=dev) * 3.0
    return ssm, consts, (x_anchor, eps, y), cbias


@pytest.mark.parametrize("dx,dy,di,h", [(3, 1, 0, 48), (6, 1, 1, 8)])
def test_svo_kernels_beyond_the_library_match_plain(dx, dy, di, h):
    """K12 and K13 from a shape library (the split designs at a shape the
    kernels' library does not hold): K12 within 2e-4 of its plain version,
    K13 per leaf within 1e-4 relative L2 with the relu-tie paths' cotangents
    zeroed (d_cbias too with Di = 1), each bit-equal on a relaunch."""
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    _, consts, ops, cbias = _class_svo_operands(dev, dx, dy, di, h)
    assert svo.usable(_class_svo_operands(dev, dx, dy, di, h)[0], 32)
    assert svo.lib_key(dx, dy, h) == ("svo", dx, dy, h)
    with torch.no_grad():
        got = svo.svo_sweep_forward(*ops, consts, cbias=cbias)
        want = svo.svo_sweep_forward_reference(*ops, consts, cbias)
        assert all(torch.equal(a, c) for a, c in
                   zip(got, svo.svo_sweep_forward(*ops, consts, cbias=cbias)))
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=2e-4, atol=2e-4)
        keep = (~_svo_relu_ties(consts, ops, got[3], cbias=cbias)).float()
        g = torch.Generator(device=dev).manual_seed(11)
        cots = [torch.randn(t.shape, generator=g, device=dev) for t in got]
        cots = [cots[0] * keep[..., None], cots[1] * keep, cots[2] * keep,
                cots[3] * keep[..., None]]
        k13 = svo.svo_sweep_backward(*ops, consts, got[3], *cots, cbias=cbias)
        ref = svo.svo_sweep_backward_reference(*ops, consts, got[3], *cots, cbias=cbias)
        again = svo.svo_sweep_backward(*ops, consts, got[3], *cots, cbias=cbias)
    for a, w, c in zip(k13, ref, again):
        assert _rel(a, w) <= 1e-4 and torch.equal(a, c)


def test_cuda_lorenz96_psvo_train_step_runs_the_wide_sweep():
    """One PSVO train step on Lorenz-96 (Dx = Dy = 40) at K = 1024, M = 16,
    T = 6: the trunk filter (K7, K8, K9 each step; K10, K11 in the backward)
    and the FFBSi sweep through K5/K6's wide kernels, once each, no plain
    version; finite loss and gradient norm."""
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import trunk
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = PRESETS["lorenz96_fivo_k8192_sharded"]
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, t_steps=6),
        smc=dataclasses.replace(cfg.smc, objective="psvo", n_particles=1024,
                                n_smoothing_particles=16),
        train=dataclasses.replace(cfg.train, steps_per_call=1),
        mesh=dataclasses.replace(cfg.mesh, data=1, particle=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((2, 6, 40), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (rg.ancestor_indices_large, rg.gather_particles, trunk.trunk_forward,
               trunk.trunk_backward, rg.segment_sum_scatter, ffbsi.ffbsi_forward,
               ffbsi.ffbsi_backward)
    plain = (trunk.trunk_forward_reference, trunk.trunk_backward_reference,
             ffbsi.ffbsi_forward_reference, ffbsi.ffbsi_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    torch.cuda.synchronize()
    got = [f.launches - n for f, n in zip(kernels, launches)]
    assert got[5:] == [1, 1] and all(n > 0 for n in got[:5]), got
    assert [f.calls for f in plain] == calls
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def test_cuda_svo_dy1_width48_train_step_launches_the_four_kernels():
    """One SVO train step on Lorenz-63 seen through one channel ((Dx, Dy) =
    (3, 1), qb/f/g (48, 48), K = 256, M = 32, T = 6): K1, K4 (shape
    libraries of the whole-step class), K12 and K13 (a shape library of the
    split designs) once each, no plain version; finite loss and ELBO."""
    from psvo_tpu_torch.ops import svo
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    net = NetConfig(hidden=(48, 48))
    cfg = PRESETS["lorenz63_svo_k256"].with_nets(q1=net, f=net, g=net, qb=net)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dy=1, t_steps=6),
        smc=dataclasses.replace(cfg.smc, n_smoothing_particles=32),
        train=dataclasses.replace(cfg.train, steps_per_call=1))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.randn((4, 6, 1), generator=torch.Generator().manual_seed(2)).to(dev)
    kernels = (fused_step.scan_forward, fused_step.scan_backward, svo.svo_sweep_forward,
               svo.svo_sweep_backward)
    plain = (fused_step.scan_forward_reference, fused_step.scan_backward_reference,
             svo.svo_sweep_forward_reference, svo.svo_sweep_backward_reference)
    launches, calls = [f.launches for f in kernels], [f.calls for f in plain]
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(torch.Generator(device=dev)
                                                               .manual_seed(3), ys)
    assert [f.launches - n for f, n in zip(kernels, launches)] == [1, 1, 1, 1]
    assert [f.calls for f in plain] == calls
    for name in ("loss", "grad_norm", "elbo_svo"):
        assert torch.isfinite(metrics[name]), name


# ---- the whole-step kernels above width 64 ----

# (dx, dy, di, hidden, k): K1/K14 under the tiled plan, K4/K15 under "global" (72) and "stream"
# (at K = 1920 K4's tiles take 32 particles; the widest nets, with K1's tiles of 8 or 16 and
# K4's of 16, are _WIDEST's)
_WIDE = [(2, 2, 0, (72, 72), 256), (2, 2, 0, (128, 128), 512), (2, 2, 0, (256, 256), 256),
         (3, 1, 0, (128, 128), 384), (5, 5, 2, (96, 96), 256), (7, 7, 0, (256, 256), 2048),
         (2, 2, 0, (384, 384), 1920), (6, 1, 1, (256, 256), 1920)]
# (dx, dy, width, K): two layers of the widest the plans admit at Dx = Dy = 2 and K = 2048
# (K1's tiles of 8 particles, K4's of 16), and of 464 at Dx = Dy = 7, K = 1920 (16 and 16)
_WIDEST = [(2, 2, 1344, 2048), (7, 7, 464, 1920)]


@pytest.fixture(scope="module")
def _wide_libraries():
    """The shape libraries of _WIDE, built in parallel before the first test."""
    from psvo_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = set()
    for dx, dy, di, hidden, k in _WIDE + [(dx, dy, 0, (h, h), k) for dx, dy, h, k in _WIDEST]:
        c = fused_step.shape_consts(dx, dy, di, hidden[0], len(hidden) - 1)
        keys |= {fused_step._lib_key(c, False, k), fused_step._lib_key(c, True, k)} - {None}
    for th in _build.prebuild_shapes(sorted(keys), niceness=0):
        th.join()


@pytest.mark.parametrize("dx, dy, di, hidden, k", _WIDE)
def test_wide_kernels_match_plain(_wide_libraries, dx, dy, di, hidden, k):
    """K1, K4, K14 and K15 above width 64 (K1 and K14 under the tiled plan,
    its tiles of 64 to 8 particles; K4 and K15 under "global", "split" or
    "stream", their tiles of 64 to 16), at widths 72-1344, Dy != Dx,
    controls, K up to 2048, each from its shape library: the checks of
    test_class_kernels_match_plain_at_new_shapes."""
    c = fused_step.shape_consts(dx, dy, di, hidden[0], len(hidden) - 1)
    assert fused_step.k1_plan(c) == "tile" and fused_step.k4_plan(c, k) != "smem"
    _check_class_shape(dx, dy, di, hidden, k)


def _relu_ties(consts, x_res, x_new, tol=1e-5):
    """[B, K] bool: the particles where a relu pre-activation of q1 or f (on
    x_res) or of g (on x_new) lies within tol of the magnitude of its sum, in
    float64: there the float32 order of the sum decides the relu's mask, and
    with it whether the unit's cotangent passes (chip_smoke.py::relu_ties)."""
    flag = torch.zeros((x_res.shape[0], x_res.shape[-1]), dtype=torch.bool, device=x_res.device)
    for (layers, _), h in zip(fused_step._unpack_nets(consts), (x_res, x_res, x_new)):
        h = h.double()
        for w, b in layers:
            w, b = w.double(), b.double()[:, None]
            pre = torch.einsum("de,bdk->bek", w, h) + b
            size = torch.einsum("de,bdk->bek", w.abs(), h.abs()) + b.abs()
            flag |= (pre.abs() < tol * size).any(dim=1)
            h = torch.relu(pre)
    return flag


@pytest.mark.parametrize("dx, dy, h, k", _WIDEST)
def test_the_widest_kernels_match_plain(_wide_libraries, dx, dy, h, k):
    """Two layers of the widest nets (K1's and K14's tiles of 8 or 16
    particles, K4's and K15's of 16): K1 teacher-forced against its plain
    version (the same ancestors, values within 2e-4), the chain of K14
    launches bit-equal to K1; each K15 launch within 1e-4 of
    step_backward_reference with the cotangents of the particles at a relu
    tie zeroed (at these widths a pre-activation sums hundreds of products,
    and the two float32 orders put some particles on either side of a zero),
    and K4 within 1e-4 of the chain of K15 launches, its own arithmetic."""
    from psvo_tpu_torch.ops.resampling import gather_particles

    dev = _cuda()
    cfg = _class_cfg((h, h), k=k, dx=dx, dy=dy)
    consts, x0, a0, coef, eps, pos, g = _class_operands(dev, cfg)
    assert fused_step.shape_fits(consts, k) and fused_step.k4_tile(consts, k) == 16
    out = _run_class_kernels(consts, x0, a0, coef, eps, pos, g)
    x_last, a_last, stats, x_all, a_all, idx = out["k1"]
    t1, b = coef.shape[:2]
    with torch.no_grad():
        ref = fused_step.scan_forward_reference(
            torch.cat([x0[None], x_all[:-1]]).reshape(t1 * b, dx, k),
            torch.cat([a0[None], a_all[:-1]]).reshape(t1 * b, k), coef.reshape(1, t1 * b, -1),
            consts, eps.reshape(1, t1 * b, dx, k), pos.reshape(1, t1 * b, k), cache=True,
            save_res=True)
    assert torch.equal(ref[5].reshape(t1, b, k), idx)
    torch.testing.assert_close(ref[3].reshape(t1, b, dx, k), x_all, rtol=2e-4, atol=2e-4)
    for i, w in ((0, x_all), (1, a_all), (2, stats), (3, idx)):
        assert torch.equal(torch.stack([s_[i] for s_ in out["k14"]]), w)
    d_stats, (d_x_last, d_a_last, d_x_all, d_a_all) = out["d_stats"], out["cots"]
    d_x, d_packed, d_sconst, d_coef = d_x_last, 0.0, 0.0, [None] * t1
    with torch.no_grad():
        for t in reversed(range(t1)):
            x_in = x0 if t == 0 else x_all[t - 1]
            d_al = d_a_all[t] + d_a_last if t == t1 - 1 else d_a_all[t]
            args = (x_in, x_all[t], idx[t], stats[t], coef[t], consts, eps[t], d_stats[t])
            d_xn = d_x + d_x_all[t]
            keep = ~_relu_ties(consts, gather_particles(x_in, idx[t]), x_all[t])
            got = fused_step.step_backward(*args, d_xn * keep[:, None], d_al * keep)
            want = fused_step.step_backward_reference(x_in, coef[t], consts, eps[t], idx[t],
                                                      d_stats[t], d_xn * keep[:, None],
                                                      d_al * keep)
            for a, w in zip(got, want):
                assert _rel(a, w) <= 1e-4, t
            d_x, d_coef[t], dp, ds = fused_step.step_backward(*args, d_xn, d_al)
            d_packed, d_sconst = d_packed + dp, d_sconst + ds
        k4 = fused_step.scan_backward(x0, x_all, idx, stats, coef, consts, d_stats, d_x_last,
                                      d_a_last, d_x_all, d_a_all, eps=eps)
    for a, w in zip(k4, (d_x, torch.stack(d_coef), d_packed, d_sconst)):
        assert _rel(a, w) <= 1e-4


@pytest.mark.parametrize("dx", [2, 3])
def test_tiled_plan_gives_the_register_plans_bits(monkeypatch, dx):
    """At the presets' width 64 (FHN and Lorenz-63 shapes, two hidden
    layers), K1 under the tiled plan (forced, from its own shape library)
    gives the register plan's bits in both noise modes, and so does the
    chain of K14 launches."""
    from psvo_tpu_torch.ops import _build

    dev = _cuda()
    cfg = _class_cfg((64, 64), preset="fhn_fivo_k1024_bench" if dx == 2 else
                     "lorenz63_psvo_k1024", k=1024, t=8)
    consts, x0, a0, coef, eps, pos, _ = _class_operands(dev, cfg, b=4, t1=7)
    assert fused_step.k1_plan(consts) == "smem" and fused_step._lib_key(consts, False) is None

    def run():
        with torch.no_grad():
            k1 = fused_step.scan_forward(x0, a0, coef, consts, eps=eps, positions=pos,
                                         cache=True, save_res=True)
            k1r = fused_step.scan_forward(x0, a0, coef, consts, seed=(3, 9), cache=True)
            x, lw, chain = x0, a0, []
            for t in range(coef.shape[0]):
                chain.append(fused_step.step_forward(x, lw, coef[t], consts, eps[t], pos[t]))
                x, lw = chain[-1][:2]
        return [*k1, *k1r, *(v for s_ in chain for v in s_)]

    want = run()
    caches = (fused_step._lib_key_of, fused_step._k1_fits, fused_step._k4_fits,
              fused_step._k15_fits, fused_step._resident_at)
    try:
        monkeypatch.setattr(fused_step, "_k1_plan", lambda shape: "tile")
        for f in caches:
            f.cache_clear()
        key = fused_step._lib_key(consts, False, 1024)
        assert key == (dx, dx, 64, 1, fused_step.K1_PLANS.index("tile"), 0, 64)
        _build.load_shape_library(key)
        got = run()
    finally:
        monkeypatch.undo()
        for f in caches:
            f.cache_clear()
    assert all(torch.equal(a, w) for a, w in zip(got, want) if a is not None)


def test_wide_fhn_train_step_runs_k1_and_k4():
    """The FHN preset with q1, f and g of (128, 128): one make_train_step
    step on the card launches K1 and K4 once each and no plain version, and
    its raw gradient agrees with the plain versions' on CPU tensors replaying
    its draws (K2's streams) within chip_smoke.py's CPU_TOL (norm 1%, cosine
    0.99), as test_depth_one_fhn_train_step_runs_k1_and_k4."""
    from psvo_tpu_torch.smc import _forward_filter_fused
    from psvo_tpu_torch.train import make_optimizer, make_train_step

    dev = _cuda()
    cfg = _class_cfg((128, 128), k=256)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ref = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ys = torch.randn((4, 6, 2), generator=torch.Generator().manual_seed(2))
    gen = torch.Generator(device=dev).manual_seed(3)
    state = gen.get_state()
    launches = (fused_step.scan_forward.launches, fused_step.scan_backward.launches)
    calls = (fused_step.scan_forward_reference.calls, fused_step.scan_backward_reference.calls)
    metrics = make_train_step(ssm, cfg, make_optimizer(cfg))(gen, ys.to(dev))
    assert (fused_step.scan_forward.launches, fused_step.scan_backward.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert (fused_step.scan_forward_reference.calls,
            fused_step.scan_backward_reference.calls) == calls
    assert torch.isfinite(metrics["loss"])
    gen.set_state(state)
    eps0 = torch.randn((4, 2, 256), generator=gen, device=dev)
    seed = tuple(int(v) for v in torch.randint(0, 2**32, (2,), generator=gen, device=dev))
    eps, u0 = fused_step.stream_noise_reference(seed, 5, 4, 2, 256)
    fwd = _forward_filter_fused(ref, None, ys, cfg.smc, cache=False,
                                streams=(eps0.cpu(), eps, fused_step.systematic_positions(u0, 256)))
    (-torch.mean(fwd.log_z)).backward()
    got, want = (torch.cat([torch.zeros(p.numel()) if p.grad is None
                            else p.grad.reshape(-1).cpu() for p in m.parameters()]).double()
                 for m in (ssm, ref))
    assert abs(float(got.norm() / want.norm()) - 1.0) <= 1e-2
    assert float(got @ want / (got.norm() * want.norm())) >= 0.99


def test_train_step_above_k11s_cap_with_k_not_a_multiple_of_128_matches_the_cpu():
    """At K = 32832 (K % 128 = 64) the reference's resample backward is a
    plain scatter-add, and so is the port's on the card
    (`GatherParticles.eager_calls`, no K11 launch): the objective's loss and
    every gradient leaf on the card against the CPU on the same draws, the
    CPU taking the card's ancestors step by step (over 32832 particles a
    last-bit difference in a log-weight moves some ancestor across a CDF
    boundary, which moves single leaves by far more than the arithmetic
    does), within 2e-4 and rtol 5e-3 / atol 5e-4."""
    import copy
    import functools

    from psvo_tpu_torch import smc
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import resample_gather as rg
    from psvo_tpu_torch.ops import resampling

    dev = _cuda()
    k, b, t = rg.MAX_K + 64, 2, 4
    cfg = _small_cfg("fhn_fivo_k128")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, t_steps=t),
                              smc=dataclasses.replace(cfg.smc, n_particles=k))
    cpu_ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_ssm = copy.deepcopy(cpu_ssm).to(dev)
    with torch.enable_grad():
        assert not smc.backward_hole(card_ssm, cfg.smc) and rg.eager_scatter(k)
    g = torch.Generator().manual_seed(5)
    ys = torch.randn((b, t, 2), generator=g)
    noise = (torch.randn((b, 2, k), generator=g), torch.randn((t - 1, b, 2, k), generator=g),
             resampling.bulk_positions(g, t - 1, b, k, cfg.smc.resampling))
    counts = (rg.GatherParticles.eager_calls, rg.segment_sum_scatter.launches,
              rg.segment_sum_scatter_reference.calls)
    resample, card_idx = rg.resample_and_gather, []

    def record(u, logw, x):
        idx, x_res = resample(u, logw, x)
        card_idx.append(idx.cpu())
        return idx, x_res

    def replay(u, logw, x):
        idx = card_idx.pop(0)
        return idx, rg.gather_particles(x.contiguous(), idx)

    record.eager_calls = 0  # resample_and_gather counts its count form under its module name
    rg.resample_and_gather = record
    try:
        card = make_objective(card_ssm, cfg)(None, ys.to(dev),
                                             noise=tuple(n.to(dev) for n in noise))
        card.loss.backward()
    finally:
        rg.resample_and_gather = resample
    assert (rg.GatherParticles.eager_calls - counts[0], rg.segment_sum_scatter.launches
            - counts[1], rg.segment_sum_scatter_reference.calls - counts[2]) == (t - 1, 0, 0)
    assert len(card_idx) == t - 1
    plain_resample = resampling.maybe_resample
    resampling.maybe_resample = functools.partial(plain_resample, use_kernel=True)
    rg.resample_and_gather = replay
    try:
        cpu = make_objective(cpu_ssm, cfg)(None, ys, noise=noise)
        cpu.loss.backward()
    finally:
        resampling.maybe_resample = plain_resample
        rg.resample_and_gather = resample
    assert not card_idx
    torch.testing.assert_close(card.loss.detach().cpu(), cpu.loss.detach(), rtol=2e-4, atol=2e-4)
    for (name, p_card), p_cpu in zip(card_ssm.named_parameters(), cpu_ssm.parameters()):
        if p_cpu.grad is None:
            assert p_card.grad is None, name
            continue
        torch.testing.assert_close(p_card.grad.cpu(), p_cpu.grad, rtol=5e-3, atol=5e-4,
                                   msg=name)
