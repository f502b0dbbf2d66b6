"""The host side of K7's cluster design and K11's tiled design, and torch
emulations of the two algorithms.

K7 (`ops/resample_gather.py::ancestor_indices_large`, design "cluster")
runs a row on a cluster of C CTAs: each scans a slice of K/C weights in
fp64, the slices are offset by the lower ranks' totals in rank order and
gathered into every CTA, and each CTA searches its slice's positions
against the whole CDF (a binary search for a thread's first position, a
galloping one from the previous count for the rest). K11
(`segment_sum_scatter`, design "tiled") sums each run of children in tiles
of 256·P particles: a fixed tree within the tile, the aggregates of the
earlier tiles added in tile order to the run that crosses into a tile, and
each tile's CTA writing the sources [q0, q0 + 256·P) it owns, staged by
the threads where their runs end. None of this
needs the card: the plans, the shared memory and the ctypes signatures are
host code, and the emulations below take the kernels' steps in the kernels'
order (fp64 for K7, float32 for K11) on CPU tensors. They are held to the
plain versions (`fused_step.count_form_indices`, a float64
`scatter_add_`) on rows like `chip_smoke.weight_rows`, K11's also to
`jax.vjp` of the reference's `pallas_resample.resample_and_gather`, and
three mutations must each be caught. The kernels themselves are held to
their plain versions and their row designs on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phases o and r).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu.ops import pallas_resample
from psvo_tpu.ops import resampling as jresampling
from psvo_tpu_torch.ops import _build, fused_step
from psvo_tpu_torch.ops import resample_gather as rg
from psvo_tpu_torch.ops.fused_step import SMEM_LIMIT

torch.set_num_threads(1)

_THREADS = 256


def _weight_rows(k: int, seed: int = 0) -> torch.Tensor:
    """Eight log-weight rows as `chip_smoke.weight_rows` makes them: generic,
    uniform, ties, zero weights, all floored, a floored mix, one dominant
    particle and a wide spread."""
    rng = np.random.default_rng(seed)
    i = np.arange(k)
    rows = np.stack([
        rng.standard_normal(k) * 3,
        np.zeros(k),
        -rng.integers(0, 3, k).astype(np.float64),
        np.where(i % 3 == 0, 0.0, -np.inf),
        np.full(k, -3e30),
        np.where(i % 5 == 0, -1.0, -1e30),
        np.where(i == (517 * k) // 1024, 0.0, -50.0),
        np.linspace(-100.0, 0.0, k),
    ])
    return torch.from_numpy(rows.astype(np.float32))


def _systematic(k: int, seed: int) -> torch.Tensor:
    u0 = torch.from_numpy(np.random.default_rng(seed).uniform(size=8).astype(np.float32))
    return fused_step.systematic_positions(u0, k).contiguous()


def _multinomial(k: int, seed: int) -> torch.Tensor:
    u = np.sort(np.random.default_rng(seed).uniform(size=(8, k)).astype(np.float32), axis=-1)
    return torch.from_numpy(u)


# ---- K7: host side ----


@pytest.mark.parametrize("batch,k,want", [(1, 8192, 8), (8, 8192, 8), (32, 8192, 4),
                                          (1, 128, 1), (8, 256, 1), (8, 512, 2), (32, 1024, 4),
                                          (8, 19200, 1), (32, 19200, 1), (8, 6144, 8)])
def test_k7_cluster_is_the_largest_one_wave_cluster(batch, k, want):
    """C: slices of whole 256-particle chunks, B·C CTAs on the 132 SMs in one
    wave; 8 at the preset (B = 8, K = 8192: 64 CTAs), 1 at K <= 256."""
    assert rg.k7_cluster(batch, k, 132) == want


def test_k7_cluster_shared_memory_fits_every_k_of_the_class():
    """Every K of K7's class fits a CTA at the C that k7_cluster picks at any
    B, spread where the row's CDF does not fit; the class before K = 19456
    (K <= 256 or whole chunks of 256, up to 19200) keeps whole slices of
    256-particle chunks and the whole CDF in each CTA; 68.2 KB at the
    preset."""
    assert rg.k7_cluster_smem_bytes(8192, 8) == 8 * (8192 + 10) + 4 * (1024 + 9) == 69748
    assert rg.k7_cluster_smem_bytes(19200, 1) == 230516 <= SMEM_LIMIT
    for k, c in ((8192, 8), (4096, 4), (1024, 1)):  # the log-weights start on 16 bytes
        assert (rg.k7_cluster_smem_bytes(k, c) - 4 * (k // c + 9)) % 16 == 0
    for k in [*range(1, 257), *range(512, 19201, 256)]:
        assert rg.k_ok(k)
        for batch in (1, 8, 32):
            c = rg.k7_cluster(batch, k, 132)
            assert k % c == 0 and (c == 1 or (k // c) % _THREADS == 0)
            assert not rg.k7_spread(k, c) and rg.k7_cluster_smem_bytes(k, c) <= SMEM_LIMIT


def test_k7_class_is_unchanged():
    """The cluster design takes every K up to MAX_K = 32768, the reference's
    pallas_resample.MAX_K_IDX (K = 300 too); the row design K up to
    ROW_MAX_K = 19362, its 12·(K + 8) bytes in one CTA; above them the
    wrapper raises (and resample_and_gather takes the count form as tensor
    ops)."""
    assert rg.MAX_K == pallas_resample.MAX_K_IDX == 32768
    assert rg.k7_smem_bytes(rg.ROW_MAX_K) <= SMEM_LIMIT < rg.k7_smem_bytes(rg.ROW_MAX_K + 1)
    assert rg.k_ok(rg.MAX_K) and not rg.k_ok(rg.MAX_K + 1)
    assert rg.k_ok(300) and rg.k_ok(255) and not rg.k_ok(0)
    assert rg.k7_row_ok(rg.ROW_MAX_K) and not rg.k7_row_ok(rg.ROW_MAX_K + 1)


@pytest.mark.parametrize("design", rg.K7_DESIGNS)
def test_k7_wrapper_on_cpu_runs_the_plain_version_for_either_design(design):
    """CPU tensors take the plain version whatever the design, and launch
    nothing; an unknown design raises."""
    lw, pos = _weight_rows(256), _systematic(256, 1)
    launches = dict(rg.ancestor_indices_large.launches_by_design)
    calls = rg.ancestor_indices_large_reference.calls
    got = rg.ancestor_indices_large(lw, pos, design=design)
    assert torch.equal(got, fused_step.count_form_indices(lw, pos))
    assert rg.ancestor_indices_large_reference.calls == calls + 1
    assert rg.ancestor_indices_large.launches_by_design == launches
    with pytest.raises(ValueError, match="no design"):
        rg.ancestor_indices_large(lw, pos, design="tile")


# ---- K11: host side ----


@pytest.mark.parametrize("k,want", [(1, (4, 1)), (128, (4, 1)), (1024, (4, 1)), (1025, (4, 2)),
                                    (4096, (4, 4)), (4097, (8, 3)), (8192, (8, 4)),
                                    (8193, (16, 3)), (16384, (16, 4)), (16385, (16, 5)),
                                    (19200, (16, 5))])
def test_k11_plan(k, want):
    """P, the particles a thread, is the fewest that cover K in at most 4
    tiles (else 8); C = ceil(K / (256·P)) tiles a row, one cluster (4 tiles
    of 2048 at the preset: 8 × 4 × 10 = 320 CTAs at B = 8, D = 40)."""
    assert rg.k11_plan(k) == want


def test_k11_plan_covers_every_k_and_fits():
    """Every K in [1, MAX_K] gets a plan the C side admits: P in (4, 8, 16),
    (C − 1)·tile < K <= C·tile, C <= 8; a CTA's shared memory 33 KB, the
    32 KB stage of its sources."""
    for k in range(1, rg.MAX_K + 1):
        per, c = rg.k11_plan(k)
        tile = _THREADS * per
        assert per in rg.K11_PER and 1 <= c <= 8 and (c - 1) * tile < k <= c * tile
    assert [rg.k11_smem_bytes(p) for p in rg.K11_PER] == [33380, 33092, 32948]
    assert 3 * max(rg.k11_smem_bytes(p) for p in rg.K11_PER) <= SMEM_LIMIT  # three CTAs an SM


@pytest.mark.parametrize("design", rg.K11_DESIGNS)
def test_k11_wrapper_on_cpu_runs_the_plain_version_for_either_design(design):
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 64)).astype(np.float32))
    idx = torch.sort(torch.from_numpy(np.random.default_rng(4).integers(0, 64, (2, 64))
                                      .astype(np.int32)), -1).values
    launches = dict(rg.segment_sum_scatter.launches_by_design)
    got = rg.segment_sum_scatter(g, idx, design=design)
    want = torch.zeros_like(g).scatter_add_(-1, idx.long()[:, None, :].expand(-1, 3, -1), g)
    assert torch.equal(got, want)
    assert rg.segment_sum_scatter.launches_by_design == launches
    with pytest.raises(ValueError, match="no design"):
        rg.segment_sum_scatter(g, idx, design="cluster")


# (entry point, the parameters before the stream, the designs)
_ENTRIES = [("psvo_ancestor_indices_large", ["design", "cluster", "spread"], rg.K7_DESIGNS),
            ("psvo_segment_sum_scatter", ["design", "per", "cluster"], rg.K11_DESIGNS)]


@pytest.mark.parametrize("name,tail,designs", _ENTRIES)
def test_ctypes_signature_carries_the_design(name, tail, designs):
    """The entry point's argtypes match its C parameters (pointers and the
    stream c_void_p, ints c_int), with the design and its plan last before
    the stream; design 0 is the new kernel (DESIGNS[0]), 1 the row design."""
    src = (_build.CSRC / "resample_gather.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    params = [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else ctypes.c_int for t, _ in params]
    assert _build.SIGNATURES[name] == want
    assert [n for _, n in params][-len(tail) - 1:] == tail + ["stream"]
    assert "design == 0" in src and designs[1] == "row"


# ---- K7: the cluster design, emulated ----


def _first_above(cdf, lo, hi, t):
    """Per element: the first index in [lo, hi) whose cdf exceeds t, or hi
    (a binary search, as the kernel's first_above)."""
    k = cdf.shape[-1]
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        going = lo < hi
        mid = (lo + hi) // 2
        le = torch.gather(cdf, -1, mid.clamp(max=k - 1)) <= t
        lo = torch.where(going & le, mid + 1, lo)
        hi = torch.where(going & ~le, mid, hi)
    return lo


def _gallop(cdf, count, t):
    """From count (every index below it at most t): double the step until an
    index above t or K, then the binary search in the last step's range."""
    k = cdf.shape[-1]
    lo, hi, step = count.clone(), count.clone(), torch.ones_like(count)
    while True:
        going = (hi < k) & (torch.gather(cdf, -1, hi.clamp(max=k - 1)) <= t)
        if not bool(going.any()):
            return _first_above(cdf, lo, hi, t)
        lo = torch.where(going, hi + 1, lo)
        hi = torch.where(going, torch.clamp(hi + step, max=k), hi)
        step = torch.where(going, step * 2, step)


def _shift_lanes(x, o, fill):
    """x [..., 32] shifted up by o lanes (lane l reads lane l − o), fill below."""
    pad = torch.full_like(x[..., :o], fill)
    return torch.cat([pad, x[..., :-o]], dim=-1)


def _k7_emulate(logw, pos, cluster, mutate=None):
    """K7's cluster design step by step: the row max; each slice's fp64 scan
    (a thread's weights in order, the warp's shuffles, the warps in order);
    the offsets in rank order (mutate="offset": each slice takes the rank
    below's offset); the all-gather; each thread's positions searched, the
    first by bisection, the rest by galloping from the previous count."""
    b, k = logw.shape
    s = k // cluster
    per = s // _THREADS if s >= _THREADS else 1
    threads = s // per
    lanes = -(-threads // 32) * 32
    m = logw.amax(-1, keepdim=True)
    w = torch.exp(logw - m).double().view(b, cluster, threads, per)
    run = torch.cumsum(w, -1)  # a thread's weights in order
    incl = torch.zeros((b, cluster, lanes), dtype=torch.float64)
    incl[..., :threads] = run[..., -1]
    incl = incl.view(b, cluster, lanes // 32, 32)
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        incl = torch.where(lane >= o, incl + _shift_lanes(incl, o, 0.0), incl)
    excl = _shift_lanes(incl, 1, 0.0)
    dred = incl[..., 31]
    for wp in range(lanes // 32 - 1):  # the warps' totals in order
        excl[..., wp + 1:, :] += dred[..., wp, None, None]
    cdf_local = run + excl.view(b, cluster, lanes)[..., :threads, None]
    total = cdf_local[..., -1, -1]  # the slice's last value, as its owner holds it
    offs, acc = [], torch.zeros(b, dtype=torch.float64)
    for q in range(cluster):
        offs.append(acc)
        acc = acc + total[:, q]
    row_total = acc
    offs = torch.stack(offs, 1)
    if mutate == "offset":
        offs = torch.cat([offs[:, :1], offs[:, :-1]], 1)
    cdf = (cdf_local + offs[:, :, None, None]).reshape(b, k)  # the all-gather
    t = pos.double().view(b, cluster * threads, per) * row_total[:, None, None]
    count = _first_above(cdf, torch.zeros((b, cluster * threads), dtype=torch.long),
                         torch.full((b, cluster * threads), k), t[..., 0])
    out = [count]
    for j in range(1, per):
        back = t[..., j] < t[..., j - 1]
        count = torch.where(back, _first_above(cdf, torch.zeros_like(count),
                                               torch.full_like(count, k), t[..., j]),
                            _gallop(cdf, count, t[..., j]))
        out.append(count)
    return torch.clamp(torch.stack(out, -1).reshape(b, k), max=k - 1).to(torch.int32)


_K7_CASES = [(128, 1), (130, 1), (1024, 1), (1024, 2), (1024, 4), (2048, 8),
             (4096, 2), (4096, 8), (3840, 1), (8192, 8)]


@pytest.mark.parametrize("positions", ["systematic", "multinomial"])
@pytest.mark.parametrize("k,cluster", _K7_CASES)
def test_k7_cluster_emulation_gives_the_count_form(k, cluster, positions):
    """Slice scans, rank-order offsets, the all-gather and the searches give
    count_form_indices' ancestors on every row, the dominant particle's row
    one ancestor; C = 1 at K = 3840 has 15 weights a thread."""
    assert rg.k_ok(k)
    lw = _weight_rows(k, seed=k + cluster)
    pos = (_systematic if positions == "systematic" else _multinomial)(k, seed=cluster)
    got = _k7_emulate(lw, pos, cluster)
    assert torch.equal(got, fused_step.count_form_indices(lw, pos))
    assert got[6].unique().numel() == 1


@pytest.mark.parametrize("k,cluster", [(1024, 2), (4096, 8)])
def test_k7_emulation_catches_an_offset_from_the_wrong_rank(k, cluster):
    lw = _weight_rows(k, seed=5)
    pos = _systematic(k, seed=6)
    bad = _k7_emulate(lw, pos, cluster, mutate="offset")
    assert int((bad != fused_step.count_form_indices(lw, pos)).sum()) > 0


# ---- K11: the tiled design, emulated ----


def _k11_emulate(g, idx, per, mutate=None):
    """K11's tiled design step by step, in float32: tiles of 256·P particles,
    a thread's P particles in order, the warp's shuffles, the warps in order;
    the tiles' aggregates added in tile order to the run that crosses into a
    tile (mutate="carry": left out); each run's total staged by its source's
    owner, the tile of sources [q0, q0 + tile) (mutate="owner": the tile of
    s + 1, so a tile's last source lands one slot below the next tile's
    stage, and is lost), each stage written out."""
    b, d, k = g.shape
    tile = _THREADS * per
    c = -(-k // tile)
    kp = c * tile
    a = torch.full((b, kp), -1, dtype=torch.long)
    a[:, :k] = idx.long()
    v = torch.zeros((b, d, kp), dtype=torch.float32)
    v[..., :k] = g
    q = torch.arange(kp)
    live = q < k
    prev = torch.cat([torch.full((b, 1), -1), a[:, :-1]], 1)
    nxt = torch.cat([a[:, 1:], torch.full((b, 1), -1)], 1)
    head = ~live | (q == 0) | (a != prev)
    last = live & ((q == k - 1) | (nxt != a))
    warps = _THREADS // 32
    head = head.view(b, 1, c, warps, 32, per)
    v = v.view(b, d, c, warps, 32, per)
    s = v[..., 0]
    for j in range(1, per):
        s = torch.where(head[..., j], v[..., j], s + v[..., j])
    f = head.any(-1)
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        so, fo = _shift_lanes(s, o, 0.0), _shift_lanes(f, o, False)
        up = lane >= o
        s = torch.where(up & ~f, so + s, s)
        f = torch.where(up, f | fo, f)
    sx, fx = _shift_lanes(s, 1, 0.0), _shift_lanes(f, 1, False)
    wtot, wflag = s[..., 31], f[..., 31]
    pv_w = [torch.zeros_like(wtot[..., 0])]
    pf_w = [torch.zeros_like(wflag[..., 0])]
    for wp in range(warps):  # the warps before each one, in order
        pv_w.append(torch.where(wflag[..., wp], wtot[..., wp], pv_w[-1] + wtot[..., wp]))
        pf_w.append(pf_w[-1] | wflag[..., wp])
    agg, aggf = pv_w[-1], pf_w[-1]  # [b, d, c], [b, 1, c]
    pv = torch.stack(pv_w[:-1], -1)[..., None]
    pf = torch.stack(pf_w[:-1], -1)[..., None]
    pv = torch.where(lane > 0, torch.where(fx, sx, pv + sx), pv)
    pf = pf | (fx & (lane > 0))
    incl, opened = [], []
    for j in range(per):
        pv = torch.where(head[..., j], v[..., j], pv + v[..., j])
        pf = pf | head[..., j]
        incl.append(pv)
        opened.append(~pf)
    incl = torch.stack(incl, -1).reshape(b, d, c, tile)
    opened = torch.stack(opened, -1).reshape(b, 1, c, tile)
    carry = [torch.zeros_like(agg[..., 0])]
    for u in range(c - 1):  # the earlier tiles' aggregates, in tile order
        carry.append(torch.where(aggf[..., u], agg[..., u], carry[-1] + agg[..., u]))
    carry = torch.stack(carry, -1)[..., None]
    if mutate != "carry":
        incl = torch.where(opened, carry + incl, incl)
    total = incl.reshape(b, d, kp)
    owner = a // tile if mutate != "owner" else torch.clamp((a + 1) // tile, max=c - 1)
    slot = a - owner * tile
    keep = last & (a >= 0) & (a < k) & (slot >= 0) & (slot < tile)
    stage = torch.zeros((b, d, c * tile), dtype=torch.float32)
    bi, qi = keep.nonzero(as_tuple=True)
    stage[bi, :, (owner * tile + slot)[bi, qi]] = total[bi, :, qi]
    return stage[..., :k]


def _k11_rows(k: int, seed: int):
    """K7's count form on the eight adversarial rows, on healthy rows and on
    rows with one ancestor each."""
    rng = np.random.default_rng(seed)
    pos = _systematic(k, seed)
    healthy = torch.from_numpy((rng.standard_normal((8, k)) * 3).astype(np.float32))
    one = np.full((8, k), -50.0, np.float32)
    one[np.arange(8), rng.integers(0, k, 8)] = 0.0
    return {"adversarial": fused_step.count_form_indices(_weight_rows(k, seed), pos),
            "healthy": fused_step.count_form_indices(healthy, pos),
            "one ancestor": fused_step.count_form_indices(torch.from_numpy(one), pos)}


def _scatter64(g, idx):
    index = idx.long()[:, None, :].expand(-1, g.shape[1], -1)
    return torch.zeros(g.shape, dtype=torch.float64).scatter_add_(-1, index, g.double())


@pytest.mark.parametrize("rows", ["adversarial", "healthy", "one ancestor"])
@pytest.mark.parametrize("k,per", [(128, 4), (1000, 4), (1023, 4), (2048, 4), (3072, 4),
                                   (4096, 4), (4096, 8), (2500, 8), (4096, 16), (1234, 16)])
def test_k11_tiled_emulation_matches_float64(k, per, rows):
    """Tiles (1–4 a row here, 8 at the preset), the earlier tiles' aggregates
    in tile order and the sources' owners give a float64 scatter_add_ to
    1e-6 relative L2, childless sources exactly 0; in the first tile (no
    carry) the row design's bits, which walks the row in chunks of 1024
    with the same tree."""
    idx = _k11_rows(k, seed=k + per)[rows]
    g = torch.from_numpy(np.random.default_rng(k).standard_normal((8, 3, k)).astype(np.float32))
    got = _k11_emulate(g, idx, per)
    want = _scatter64(g, idx)
    assert float((got.double() - want).norm() / want.norm()) <= 1e-6
    assert bool((got[want == 0] == 0).all())
    if rows == "one ancestor":
        assert all(int((want[i, 0] != 0).sum()) == 1 for i in range(8))


@pytest.mark.parametrize("mutate", ["carry", "owner"])
def test_k11_emulation_catches_a_lost_carry_and_an_owner_off_by_one(mutate):
    """Left out, the carry drops the earlier tiles' part of every run that
    crosses a tile edge (the one-ancestor rows cross all of them); an owner
    off by one at a tile edge loses the last source of each tile."""
    k, per = 4096, 4
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((8, 3, k)).astype(np.float32))
    caught = []
    for idx in _k11_rows(k, seed=9).values():
        want = _scatter64(g, idx)
        bad = _k11_emulate(g, idx, per, mutate=mutate)
        caught.append(not float((bad.double() - want).norm() / want.norm()) <= 1e-2)
    assert any(caught)


@pytest.mark.parametrize("degenerate", [False, True], ids=["healthy", "degenerate"])
def test_k11_tiled_emulation_matches_reference_vjp(degenerate):
    """The tiled emulation on the reference's own ancestors against jax.vjp of
    `pallas_resample.resample_and_gather` (its fused `_scatter_kernel`, in
    interpret mode) at K = 1024, two tiles of 512 (P = 2 is no plan of the
    card's; the tree is the same): rtol 5e-3 / atol 5e-4, as
    tests/test_torch_lorenz96_train.py holds the plain version."""
    rng = np.random.default_rng(11 + degenerate)
    batch, d, k = 8, 8, 1024  # the reference's kernels take rows in blocks of 8
    logw = (rng.standard_normal((batch, k)) * 3).astype(np.float32)
    if degenerate:
        logw[:] = -60.0
        logw[np.arange(batch), rng.integers(0, k, batch)] = 0.0
    u = jresampling.quantile_positions_from_raw(jnp.asarray(rng.uniform(size=batch), jnp.float32),
                                                k, "systematic")
    x = rng.standard_normal((batch, d, k)).astype(np.float32)
    g = rng.standard_normal((batch, d, k)).astype(np.float32)
    interpret = pallas_resample._INTERPRET
    pallas_resample._INTERPRET = True
    try:
        _, vjp, idx = jax.vjp(lambda xx: pallas_resample.resample_and_gather(u, jnp.asarray(logw),
                                                                             xx)[::-1],
                              jnp.asarray(x), has_aux=True)
        (dx_want,) = vjp(jnp.asarray(g))
    finally:
        pallas_resample._INTERPRET = interpret
    idx = torch.from_numpy(np.array(idx))
    if degenerate:
        assert all(idx[i].unique().numel() == 1 for i in range(batch))
    got = _k11_emulate(torch.from_numpy(g), idx, per=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(dx_want), rtol=5e-3, atol=5e-4)
