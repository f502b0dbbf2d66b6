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
    dev = _cuda()
    cfg = PRESETS["fhn_fivo_k1024_bench"]
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    ys = torch.zeros((2, 5, 2), device=dev)
    from psvo_tpu_torch.smc import forward_filter

    multinomial = dataclasses.replace(cfg.smc, resampling="multinomial")
    with pytest.raises(NotImplementedError):
        forward_filter(ssm, torch.Generator(device=dev), ys, multinomial)


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
    means near the support, normalized weights, Gumbels and anchors."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((t1, b, dx, k), generator=g, device=dev) * 8.0
    mean = xs + torch.randn(xs.shape, generator=g, device=dev)
    scale = 0.5 + 1.5 * torch.rand(xs.shape, generator=g, device=dev)
    r = 1.0 / (scale * scale)
    c = -0.5 * (mean * mean * r).sum(2) - torch.log(scale).sum(2) - dx * 0.9189385332
    lwn = torch.log_softmax(torch.randn((t1, b, k), generator=g, device=dev) * 2.0, dim=-1)
    lg = torch.randn((t1, b, k), generator=g, device=dev)
    u = torch.rand((t1, b, m, k), generator=g, device=dev).clamp_min(1e-30)
    x_anchor = xs[-1, :, :, :m].transpose(1, 2).contiguous()
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
    wide = (torch.zeros((4, 8, 4), device=dev), torch.zeros((9, 4, 4, 128), device=dev))
    for design in ffbsi.K6_DESIGNS:  # Dx = 4: not instantiated
        with pytest.raises(ValueError, match=f"ffbsi_backward \\({design}\\): no kernel"):
            ffbsi.ffbsi_backward(*wide, *ops[2:7], fwd[4], fwd[3], design=design)
    with pytest.raises(ValueError, match="sel"):
        ffbsi.ffbsi_backward(*ops[:7], fwd[4].long(), fwd[3])


def test_cuda_tensor_outside_the_ffbsi_class_raises():
    dev = _cuda()
    ops = _sweep(dev, 3)
    wide = (torch.zeros((4, 8, 4), device=dev), torch.zeros((9, 4, 4, 128), device=dev))
    for design in ffbsi.DESIGNS:  # Dx = 4: not instantiated
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
    dominant particle included); K8 is bit-equal to the plain gather."""
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
    with pytest.raises(ValueError, match="no kernel"):
        rg.ancestor_indices_large(torch.zeros((2, 19456), device=dev),
                                  torch.zeros((2, 19456), device=dev))


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
    with pytest.raises(ValueError, match="no kernel"):
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


def _svo_operands(dev, hidden, preset="lorenz63_svo_k256", b=4, m=8, t1=9, seed=0):
    """An SVO sweep's operands on the card: a model with nudged random
    weights, anchors, ε and observations at Lorenz-63 scales."""
    from psvo_tpu_torch.ops import svo

    net = NetConfig(hidden=hidden)
    cfg = PRESETS[preset].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                    g=dataclasses.replace(net, sigma_init=0.5))
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


def _svo_relu_ties(consts, ops, xtilde, tol=1e-5):
    """[B, M] bool: paths where a relu pre-activation of qb, f or g lies
    within tol of the magnitude of its sum (float64)."""
    from psvo_tpu_torch.ops import svo

    x_anchor, _, y = ops
    x_next = torch.cat([xtilde[1:], x_anchor[None]])
    y_b = y[:, :, None, :].expand(-1, -1, x_next.shape[2], -1)
    flag = torch.zeros(x_anchor.shape[:2], dtype=torch.bool, device=x_anchor.device)
    for (layers, _), inp in zip(svo._nets(consts), (torch.cat([x_next, y_b], -1), xtilde, xtilde)):
        h = inp.double()
        for w, bias in layers:
            pre = h @ w.double() + bias.double()
            flag |= (pre.abs() < tol * (h.abs() @ w.double().abs() + bias.double().abs())).any(-1).any(0)
            h = torch.relu(pre)
    return flag


def test_cuda_tensor_outside_the_svo_class_raises():
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.ops import svo

    dev = _cuda()
    cfg = _small_cfg("lorenz63_svo_k256")
    cfg = cfg.with_nets(qb=NetConfig(hidden=(16, 32)))  # not one uniform width
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=dev)
    assert not svo.usable(ssm, cfg.smc.n_smoothing_particles)
    ys = torch.randn((4, 6, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    with pytest.raises(NotImplementedError, match="ops.svo.usable"):
        make_objective(ssm, cfg)(torch.Generator(device=dev).manual_seed(3), ys)
    _, consts, ops = _svo_operands(dev, (16, 16))
    with pytest.raises(ValueError, match="x_anchor"):  # eps holds 4 paths per row, not 8
        svo.svo_sweep_forward(ops[0], ops[1][:, :, :4].contiguous(), ops[2], consts)
    xtilde = svo.svo_sweep_forward(*ops, consts)[3]
    for design in svo.DESIGNS:  # a width that is not instantiated
        with pytest.raises(ValueError, match=f"no {design} kernel"):
            svo.svo_sweep_backward(*ops, dict(consts, hidden=48), xtilde, design=design)


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
    class (K = 4352 > MAX_K, or two middle layers) step_backward and
    StepForward raise."""
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
    with pytest.raises(ValueError, match="no kernel"):
        fused_step.step_backward(big, big, torch.zeros((1, 4352), dtype=torch.int32, device=dev),
                                 stats[:1], coef[0, :1], consts, big, d_stats[:1])
    deep = dict(consts, n_mid=2)
    with pytest.raises(ValueError, match="backward kernel"):
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
        int(prefetch), torch.cuda.current_stream(x_res.device).cuda_stream)
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
                                              idx.data_ptr(), b, k, 0, c,
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
