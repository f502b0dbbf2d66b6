"""The algebra of K13's split design, and the host side of the K5 and K13
redesigns.

K13 (`ops/svo.py::svo_sweep_backward`, `csrc/svo_sweep.cu`) runs the VJP of
the SVO sweep as passes over all (t, path) rows around one serial piece, a
Dx-wide linear recurrence. With J_t = d m_b / d x~_{t+1} (qb's mean against
the first Dx entries of its input, at fixed relu masks), u_t = d_xtilde_t +
dfx_t + dgx_t (f's and g's input cotangents) and dxz_t the z_f part of
x~_{t+1}'s cotangent:

    carry_0 = d_x_first,   dmb_t = u_t + carry_t,
    carry_{t+1} = dxz_t + J_t^T dmb_t,   d_x_anchor = carry_{T-1},

and qb's VJP from dmb_t gives its weight sums and d s_b. `split_vjp` below
runs that split in torch (pass A: f, g, the density terms and J_t over every
row; pass B: the recurrence; pass C: qb's VJP) and is held to the plain
version, an autograd replay of the sweep, in float32 and float64; two
mutations of it (the carry not seeded with d_x_first, J_t in place of
J_t^T) must miss. The kernel itself is held to its plain version and to the
previous design on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`
phase w); here, without a card, the shared-memory layouts, the gates and the
ctypes signatures.

K12's split design (`ops/svo.py::svo_sweep_forward`) keeps only qb and the
draw on the serial chain and computes f, g and the density terms per (t,
path) row afterwards, each path's terms then added t descending: the plain
step teacher-forced from the plain x̃ on every row gives the plain sweep's
x̃, lp and lq exactly. Its shared memory, its plan and its unchanged class
are checked here; its bits against the chain design on the card (phase v).
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

from psvo_tpu_torch.config import PRESETS, NetConfig
from psvo_tpu_torch.distributions import _MIN_LOGP
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.ops import _build, ffbsi, svo
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT

torch.set_num_threads(1)


def _operands(hidden, dtype, b=3, m=4, t1=9, seed=0):
    """An SVO sweep's operands from numpy draws: a Lorenz-63 model of the
    given widths with nudged weights, anchors, ε and y; its x̃ from the plain
    forward in `dtype`."""
    net = NetConfig(hidden=hidden)
    cfg = PRESETS["lorenz63_svo_k256"].with_nets(q0=net, q1=net, q2=net, f=net, qb=net,
                                                 g=dataclasses.replace(net, sigma_init=0.5))
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for p in ssm.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(tuple(p.shape))).float())
        consts = svo.prepare(ssm)
    consts = dict(consts, packed=consts["packed"].detach().to(dtype),
                  sc=consts["sc"].detach().to(dtype))
    ops = (torch.from_numpy(3.0 * rng.standard_normal((b, m, 3))).to(dtype),
           torch.from_numpy(rng.standard_normal((t1, b, m, 3))).to(dtype),
           torch.from_numpy(3.0 * rng.standard_normal((t1, b, 3))).to(dtype))
    xtilde = svo.svo_sweep_forward_reference(*ops, consts)[3]
    cots = [torch.from_numpy(rng.standard_normal(s)).to(dtype)
            for s in ((b, m, 3), (b, m), (b, m), (t1, b, m, 3))]
    return consts, ops, xtilde, cots


def split_vjp(x_anchor, eps, y, consts, xtilde, d_x_first=None, d_lp=None, d_lq=None,
              d_xtilde=None, *, seed_carry=True, transpose_j=True):
    """K13's split in torch. Returns (d_x_anchor, d_packed, d_sc) as
    `svo.svo_sweep_backward_reference`. seed_carry=False and
    transpose_j=False are the mutations the tests must catch."""
    dx, dy = consts["dx"], consts["dy"]
    t1, b, m, _ = eps.shape
    packed = consts["packed"].detach().requires_grad_()
    sc = consts["sc"].detach().requires_grad_()
    qb, f, g = svo._nets(consts, packed)
    zero = torch.zeros((b, m), dtype=eps.dtype)
    d_lp = zero if d_lp is None else d_lp
    d_lq = zero if d_lq is None else d_lq
    sfi, sgi, s_b = sc[:dx], sc[dx:dx + dy], sc[dx + dy:2 * dx + dy]
    c_f, c_g, c_b = sc[2 * dx + dy], sc[2 * dx + dy + 1], sc[2 * dx + dy + 2]
    x_next = torch.cat([xtilde[1:], x_anchor[None]]).detach().requires_grad_()
    x_t = xtilde.detach().requires_grad_()
    y_rows = y[:, :, None, :].expand(-1, -1, m, -1)
    with torch.enable_grad():
        # pass A, every row: f, g and the density terms (floored as the sweep does)
        z_f = (x_next - svo._mlp(f, x_t)) * sfi
        z_g = (y_rows - svo._mlp(g, x_t)) * sgi
        t_f = torch.clamp(-0.5 * torch.sum(z_f * z_f, -1) + c_f, min=_MIN_LOGP)
        t_g = torch.clamp(-0.5 * torch.sum(z_g * z_g, -1) + c_g, min=_MIN_LOGP)
        t_b = torch.clamp(-0.5 * torch.sum(eps * eps, -1) + c_b, min=_MIN_LOGP)
        loss_a = torch.sum(d_lp * (t_f + t_g)) + torch.sum(d_lq * t_b)
        ga_w, ga_sc, dfgx, dxz = torch.autograd.grad(loss_a, [packed, sc, x_t, x_next])
        u = dfgx if d_xtilde is None else d_xtilde + dfgx
        # J_t[o][i] = d m_b[o] / d x~_{t+1}[i], by Dx cotangent passes through qb
        m_b = svo._mlp(qb, torch.cat([x_next, y_rows], -1))
        jac = torch.stack([torch.autograd.grad(m_b[..., o].sum(), x_next, retain_graph=True)[0]
                           for o in range(dx)], dim=-2)
    # pass B: the recurrence, t ascending
    carry = d_x_first if seed_carry and d_x_first is not None else torch.zeros_like(x_anchor)
    dmb = []
    for t in range(t1):
        mb = u[t] + carry
        dmb.append(mb)
        carry = dxz[t] + torch.einsum("bmoi,bmo->bmi" if transpose_j else "bmio,bmo->bmi",
                                      jac[t], mb)
    # pass C, every row: qb's VJP from dmb_t (the draw x~_t = m_b + s_b ε)
    with torch.enable_grad():
        draw = svo._mlp(qb, torch.cat([x_next.detach(), y_rows], -1)) + s_b * eps
        gc_w, gc_sc = torch.autograd.grad(torch.sum(torch.stack(dmb).detach() * draw),
                                          [packed, sc])
    return carry, ga_w + gc_w, ga_sc + gc_sc


def _rel(got, want):
    if float(want.norm()) == 0.0:
        return float(got.norm())
    return float((got - want).norm() / want.norm())


LIVE = {"all": (0, 1, 2, 3), "no d_x_first": (1, 2, 3), "no d_lp": (0, 2, 3),
        "no d_lq": (0, 1, 3), "no d_xtilde": (0, 1, 2)}


@pytest.mark.parametrize("live", list(LIVE))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
@pytest.mark.parametrize("hidden", [(16, 16), (16, 16, 16), (64, 64), (64, 64, 64)])
def test_split_matches_the_plain_vjp(hidden, dtype, tol, live):
    """The split (passes A and C over every row, the recurrence between)
    gives the plain replay's d_x_anchor, weight and sc cotangents per leaf:
    float32 to 1e-5 relative L2, float64 to 1e-10; B=3, M=4, T-1=9, hidden 16
    and 64 with one and two middle layers, cotangents on all four outputs
    and with each one missing."""
    consts, ops, xtilde, cots = _operands(hidden, dtype)
    cots = [c if i in LIVE[live] else None for i, c in enumerate(cots)]
    got = split_vjp(*ops, consts, xtilde, *cots)
    want = svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots)
    for name, a, w in zip(("d_x_anchor", "d_packed", "d_sc"), got, want):
        assert _rel(a, w) <= tol, name


@pytest.mark.parametrize("mutation", ["carry not seeded with d_x_first", "J_t instead of J_t^T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_mutations_miss(mutation, dtype):
    """Each mutation of the split misses the plain replay by far more than
    the float32 gate, so the test above would catch it in the kernel's
    algebra."""
    consts, ops, xtilde, cots = _operands((16, 16), dtype)
    kw = ({"seed_carry": False} if mutation.startswith("carry") else {"transpose_j": False})
    got = split_vjp(*ops, consts, xtilde, *cots, **kw)
    want = svo.svo_sweep_backward_reference(*ops, consts, xtilde, *cots)
    assert max(_rel(a, w) for a, w in zip(got, want)) > 1e-3


def _padded(din, dout, h, n_mid):
    n = din * (h + 4) + h + n_mid * (h * (h + 4) + h) + h * dout + dout
    return n + (-n) % 4


@pytest.mark.parametrize("dims,h,n_mid,rows", [((3, 3), 64, 1, 64), ((2, 2), 64, 1, 64),
                                               ((3, 3), 32, 1, 128), ((3, 3), 16, 1, 256),
                                               ((3, 3), 32, 4, 64), ((2, 2), 16, 13, 32)])
def test_k13_shared_memory_per_design(dims, h, n_mid, rows):
    """The split design's bytes: the three nets with rows padded to h + 4,
    the gradient sums, 2 (n_mid + 1) + 1 hidden layers of `rows` rows at a
    stride of h + 4 and 56 floats a row, at the largest tile (4096 / h rows,
    halved) that fits one CTA. The chain design's bytes as before the
    split, which fit wherever the class admits a shape."""
    dx, dy = dims
    n_w = svo._n_weights(dx, dy, h, n_mid)
    nets = _padded(dx + dy, dx, h, n_mid) + _padded(dx, dx, h, n_mid) + _padded(dx, dy, h, n_mid)
    sums = n_w + 2 * dx + dy + 3
    want = 4 * (nets + sums + (-sums) % 4 + (2 * n_mid + 3) * rows * (h + 4) + 56 * rows)
    assert svo.k13_tile_rows(dx, dy, h, n_mid, n_w) == rows
    assert svo.k13_smem_bytes(dx, dy, h, n_mid, n_w) == want <= SMEM_LIMIT
    assert svo.k13_smem_bytes(dx, dy, h, n_mid, n_w, "split", rows * 2) > SMEM_LIMIT or rows * h == 4096
    nt = (dx + dy) * h + 2 * dx * h + 3 * n_mid * h * h
    chain = 4 * (n_w + nt + (-nt) % 4 + sums + (-sums) % 4 + 256 // h * (80 + 6 * (n_mid + 1) * h))
    assert svo.k13_smem_bytes(dx, dy, h, n_mid, n_w, "chain") == chain <= SMEM_LIMIT
    if (dims, h, n_mid) == ((3, 3), 64, 1):  # the preset
        assert (want, chain) == (216912, 178064)
    with pytest.raises(ValueError, match="no design"):
        svo.k13_smem_bytes(dx, dy, h, n_mid, n_w, "tiles")


@pytest.mark.parametrize("n_paths,n_sms,rows,want", [(512, 132, 64, 4), (32, 132, 64, 1),
                                                    (16384, 132, 64, 64), (1, 132, 256, 1),
                                                    (512, 2, 128, 128)])
def test_k13_paths_a_group(n_paths, n_sms, rows, want):
    """Paths a CTA's group: enough groups to fill the SMs in one wave, at most
    a tile's rows (4 at the preset: 128 groups of 16 steps a tile)."""
    assert svo.k13_paths(n_paths, n_sms, rows) == want


# (entry point, its C source, the parameters before the stream, the designs)
_ENTRIES = [("psvo_svo_backward", "svo_sweep.cu", ["max_ctas", "design", "tile_rows", "paths"],
             svo.DESIGNS),
            ("psvo_svo_forward", "svo_sweep.cu", ["off_g", "design", "paths", "tile_rows", "steps"],
             svo.K12_DESIGNS),
            ("psvo_ffbsi_forward", "ffbsi.cu", ["dx", "design", "paths", "chunk"], ffbsi.DESIGNS)]


@pytest.mark.parametrize("name,source,tail,designs", _ENTRIES)
def test_ctypes_signature_carries_the_design(name, source, tail, designs):
    """The entry point's argtypes match its C parameters (pointers and the
    stream c_void_p, ints c_int), with the design and its plan last before
    the stream; design 0 is the new kernel (DESIGNS[0]), 1 the previous."""
    src = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    params = [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else ctypes.c_int for t, _ in params]
    assert _build.SIGNATURES[name] == want
    assert [n for _, n in params][-len(tail) - 1:] == tail + ["stream"]
    assert "design == 0" in src and len(designs) == 2


def _ssm(dims, h, n_mid):
    preset = "lorenz63_svo_k256" if dims == (3, 3) else "fhn_fivo_k1024_bench"
    net = NetConfig(hidden=(h,) * (n_mid + 1))
    return SSM(PRESETS[preset].with_nets(q0=net, q1=net, q2=net, f=net, qb=net, g=net))


# the deepest n_mid svo.usable admits, per width: the split designs' tiles (K13's at 16-256
# rows, its gradient sums in device memory where they do not fit beside them; K12's chunk) in
# a CTA's shared memory; the chain designs, yardsticks now, no longer gate the class (before:
# 13, 4 and 1)
_SVO_CLASS = {16: 33, 32: 11, 64: 3}
_SVO_CASES = [(dims, h, n_mid, n_mid <= top) for dims in ((2, 2), (3, 3))
              for h, top in _SVO_CLASS.items() for n_mid in range(top + 2)]


@pytest.mark.parametrize("dims,h,n_mid,admitted", _SVO_CASES)
def test_svo_usable_class_is_unchanged(dims, h, n_mid, admitted):
    """svo.usable admits exactly the shapes the split designs hold at the
    kernels' library's shapes (every n_mid up to 33, 11 and 3 at widths 16,
    32 and 64, at both state widths; the chain designs' reach, 13, 4 and 1,
    no longer bounds it) and the split design takes each of them."""
    ssm = _ssm(dims, h, n_mid)
    assert svo.usable(ssm, 16) == admitted
    assert svo.usable(ssm, 1) == admitted and not svo.usable(ssm, svo.MAX_M + 1)
    if admitted:
        n_w = svo._n_weights(*dims, h, n_mid)
        assert svo.k13_ok(*dims, h, n_mid, n_w, "split")
        assert svo.k13_smem_bytes(*dims, h, n_mid, n_w, "split") <= SMEM_LIMIT
        assert svo.k12_ok(*dims, h, n_mid)  # K12's split design takes it too
        for n_paths, t1 in ((1, 1), (512, 99), (32 * 1024, 1000)):
            paths, rows, steps = svo.k12_plan(*dims, h, n_mid, n_paths, 132, t1)
            assert svo.k12_smem_bytes(*dims, h, n_mid, paths, rows, steps) <= SMEM_LIMIT


_FFBSI_CASES = [(dx, m, (dx in (2, 3) and 1 <= m <= 256) or (m >= 8 and m % 8 == 0))
                for dx in (1, 2, 3, 4) for m in (0, 1, 16, 256, 257)]


@pytest.mark.parametrize("dx,m,admitted", _FFBSI_CASES)
def test_ffbsi_usable_class_is_unchanged(dx, m, admitted):
    """ffbsi.usable admits Dx in {2, 3} and 1 <= M <= 256 at any K, as before
    the staged design, and now also the wide kernels' class, the reference's
    (any Dx, M a multiple of 8); for each admitted M the staged design picks
    a valid count of paths a CTA."""
    assert all(ffbsi.usable(dx, m, k) == admitted for k in (128, 1024, 2048))
    if admitted:
        for batch in (1, 32, 1024):
            assert ffbsi.k5_paths(batch, m, 132) in ffbsi.PATHS_PER_CTA


@pytest.mark.parametrize("k", [1, 3, 130, 256, 1000, 1024, 4096, 65536])
def test_k5_chunk_fits_any_k(k):
    """For any K, every state width and every count of paths a CTA, the
    staged design copies the whole row (two slots of it fit) or chunks of a
    multiple of 256 particles into a ring of 3 slots (where they fit) or 2;
    the ring fits one
    CTA's shared memory beside its static arrays (at most 24 KB, the lse
    window). At the
    preset (Dx = 3, K = 1024, P = 4) three slots of the whole row: 196,608
    bytes."""
    for dx in ffbsi.KERNEL_DX:
        for p in ffbsi.PATHS_PER_CTA:
            chunk = ffbsi.k5_chunk(dx, k, p)
            assert chunk == k or (chunk % 256 == 0 and 256 <= chunk < k)
            slots = ffbsi.k5_slots(dx, k, p)
            assert slots in (2, 3)
            slot = 4 * (3 * dx + 3 + p) * ((min(chunk, k) + 3) // 4 * 4)
            assert ffbsi.k5_smem_bytes(dx, k, p) == slots * slot <= SMEM_LIMIT - 24576
    assert ffbsi.k5_chunk(3, 1024, 4) == 1024 and ffbsi.k5_slots(3, 1024, 4) == 3
    assert ffbsi.k5_smem_bytes(3, 1024, 4) == 196608


@pytest.mark.parametrize("batch,m,want", [(32, 16, 4), (4, 8, 1), (32, 256, 8), (8, 16, 1),
                                          (16, 16, 2), (1, 1, 1)])
def test_k5_paths_a_cta(batch, m, want):
    """The fewest paths a CTA whose B * ceil(M / P) CTAs fit 132 SMs in one
    wave, else 8: 4 at the preset (B = 32, M = 16: 128 CTAs)."""
    assert ffbsi.k5_paths(batch, m, 132) == want


def test_unknown_designs_raise():
    x = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="no design"):
        ffbsi.ffbsi_forward(x, x, x, x, x, x, x, x, design="warp")
    with pytest.raises(ValueError, match="no design"):
        svo.svo_sweep_backward(x, x, x, {}, x, design="tiles")


def test_unknown_k12_design_raises():
    x = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="no design"):
        svo.svo_sweep_forward(x, x, x, {}, design="tiles")


@pytest.mark.parametrize("dims,h,n_mid,paths,rows,steps", [
    ((3, 3), 64, 1, 4, 64, 99), ((2, 2), 64, 1, 4, 64, 99), ((3, 3), 32, 1, 4, 128, 99),
    ((3, 3), 16, 1, 4, 256, 99), ((3, 3), 16, 13, 16, 16, 1), ((2, 2), 32, 4, 8, 16, 1),
    ((2, 2), 64, 1, 4, 16, 1)])
def test_k12_shared_memory(dims, h, n_mid, paths, rows, steps):
    """K12's split design's bytes: qb packed, f and g with h-wide rows padded
    to h + 4 floats, two hidden vectors and x̃ (4 floats) per chain slot
    (paths of h threads rounded up to whole warps), f's and g's two hidden
    layers and means for a tile, 18 floats a chain row. At the preset (B=32,
    M=16, T−1=99, hidden 64) one chunk of the whole sweep: 4 paths a CTA,
    tiles of 64 rows, 160,560 bytes; the largest CTAs of the widest classes
    fit."""
    dx, dy = dims
    qb = (dx + dy) * h + h + n_mid * (h * h + h) + h * dx + dx
    slots = -(-paths * h // 32) * 32 // h
    want = 4 * (qb + (-qb) % 4 + _padded(dx, dx, h, n_mid) + _padded(dx, dy, h, n_mid)
                + slots * (2 * h + 4) + 4 * rows * (h + 4) + 8 * rows
                + 18 * (-(-steps * paths // 4) * 4))
    assert svo.k12_smem_bytes(dx, dy, h, n_mid, paths, rows, steps) == want <= SMEM_LIMIT
    if (dims, h, n_mid) == ((3, 3), 64, 1):
        assert want == 160560 and svo.k12_plan(dx, dy, h, n_mid, 512, 132, 99) == (4, 64, 99)
    assert svo.k12_ok(dx, dy, h, n_mid)


@pytest.mark.parametrize("n_paths,t1,want", [(512, 99, (4, 64, 99)), (32, 99, (1, 64, 99)),
                                             (512, 5000, (4, 64, 348)),
                                             (1 << 16, 99, (4, 64, 99))])
def test_k12_plan(n_paths, t1, want):
    """Paths a CTA enough to fill 132 SMs in one wave (at most 4 at hidden
    64: two warps a path), 64-row tiles, and as many steps a chunk as fit
    (all of T − 1 at the preset)."""
    assert svo.k12_plan(3, 3, 64, 1, n_paths, 132, t1) == want


def _lp_lq_by_rows(nets, sc, dx, dy, x_anchor, eps, y, xtilde):
    """The split decomposition: each step's terms from the plain step on its
    row, teacher-forced from the plain x̃ (x̃_{t+1} for x_next), then added t
    descending."""
    lp = torch.zeros(x_anchor.shape[:2], dtype=x_anchor.dtype)
    lq = torch.zeros_like(lp)
    xs = []
    for t in reversed(range(eps.shape[0])):
        x_next = x_anchor if t == eps.shape[0] - 1 else xtilde[t + 1]
        x_t, lp_t, lq_t = svo._step(nets, sc, dx, dy, x_next, y[t], eps[t])
        xs.append(x_t)
        lp, lq = lp + lp_t, lq + lq_t
    return lp, lq, torch.stack(xs[::-1])


@pytest.mark.parametrize("hidden", [(16,), (16, 16), (32, 32), (64, 64), (16, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_decomposition_of_the_sweep(hidden, dtype):
    """K12's split design computes x̃ on the chain and f, g and the terms
    per row afterwards: svo._step teacher-forced from the plain x̃ on every
    row, the rows' terms then added t descending, gives the plain sweep's
    x̃, lp and lq exactly (in the loop's own batch shapes); all the rows at
    once in one batch agree to rounding."""
    consts, ops, _, _ = _operands(hidden, dtype)
    nets, sc, dx, dy = svo._nets(consts), consts["sc"], consts["dx"], consts["dy"]
    x_first, lp, lq, xs = svo._sweep(nets, sc, dx, dy, *ops)
    lp_r, lq_r, xs_r = _lp_lq_by_rows(nets, sc, dx, dy, *ops, xs)
    assert torch.equal(xs_r, xs) and torch.equal(lp_r, lp) and torch.equal(lq_r, lq)
    x_anchor, eps, y = ops
    t1, b, m, _ = eps.shape
    x_next = torch.cat([xs[1:], x_anchor[None]]).reshape(t1 * b, m, dx)
    x_all, lp_t, lq_t = svo._step(nets, sc, dx, dy, x_next, y.reshape(t1 * b, dy),
                                  eps.reshape(t1 * b, m, dx))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(x_all.reshape(xs.shape), xs, rtol=tol, atol=tol)
    lp_sum = lp_t.reshape(t1, b, m).flip(0).cumsum(0)[-1]
    torch.testing.assert_close(lp_sum, lp, rtol=tol, atol=tol * 100)
    torch.testing.assert_close(lq_t.reshape(t1, b, m).sum(0), lq, rtol=tol, atol=tol * 100)
