"""K6's staged design and K2's pair design, emulated in torch on the CPU.

The CUDA kernels run only on the card; here their algorithms are replayed
step by step in torch and held to the plain versions, so that a fault in
the algorithm (not in the CUDA) shows on the CPU.

- K6 staged, all cotangents (`csrc/ffbsi.cu::ffbsi_bwd_staged_kernel`):
  threads own K6_PER consecutive particles of a chunk; paths go in groups
  of K6_GROUP; per path the exact max and then sum e, sum e*mr, sum e*r are
  reduced as the kernel does (a warp reduce-scatter, then the warps in
  order); the soft part of d_pair is added per particle in path order across
  groups, the picks' part after it; a floored pair is cut one by one only
  where its path's max is floored too (elsewhere its e is exactly 0); d_q
  comes from the sums; d_xs is zeroed, then patched by the first path that
  picked each particle. Rows longer than a chunk are staged twice, chunk by
  chunk (`threads` small forces it at small K).
- K6 staged, paths only (`ffbsi_bwd_paths_kernel`): zeros, then the patch;
  bit-equal to the row design's scatter order.
- Three mutations must be caught: the patch before the zeros, every
  selecting path writing the particle, the floor cut dropped.
- One case against the reference's own VJP kernel (`pallas_ffbsi._scan_bwd`
  in interpret mode, as tests/test_pallas_ffbsi.py runs it).
- K2 pair (`csrc/stream_noise.cu::stream_noise_pair_kernel`): its write map
  over the launch plan `fused_step.k2_plan` gives `stream_noise_reference`'s
  bits, and the plan covers every (t, row, pair, group) once.
- The host side: ctypes signatures against the C entry points, the designs,
  the staged kernel's shared memory.

Tolerance: per leaf, the relative L2 distance to the plain version run in
float64 is at most 1e-5 or twice the float32 plain version's own (the
emulation sums in another order; where d_lwn cancels, at K = 4, the float32
plain version itself lies 1e-4 to 0.7 from float64); exact where the
designs promise bits. Against the reference's kernel, 1e-5.
"""

import ctypes
import re

import jax
import numpy as np
import pytest
import torch

from psvo_tpu.ops import pallas_ffbsi
from psvo_tpu_torch.ops import _build, ffbsi, fused_step

torch.set_num_threads(1)

_TOL = 1e-5
_NEEDS = {  # name: (live cotangents among d_x_first, d_logp, d_logq, d_xtilde; needs)
    "all four": ((0, 1, 2, 3), (True,) * 5),
    "paths only": ((0, 3), (False,) * 5),
    "direct bound": ((2, 3), (True, True, True, True, False)),
    "logp alone, r and c": ((1,), (True, False, True, False, False)),
    "logq, mr and lg": ((2, 0), (False, True, False, False, True)),
    "paths, support wanted": ((3,), (True,) * 5),
}


def _sweep(dx, b, m, k, t1, seed, floor=None, one_pick=False):
    """Operands of one sweep (support terms of a transition with means near
    the support, normalized weights, emission terms, Gumbels, anchors), K5's
    selections from the plain sweep and the trajectories they give.
    floor: "part" floors a third of one row's particles, "row" all of
    another row's. one_pick: every path of every row picks particle k // 2."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((t1, b, dx, k)) * 8.0
    mean = xs + rng.standard_normal(xs.shape)
    scale = rng.uniform(0.5, 2.0, xs.shape)
    r = 1.0 / scale**2
    c = -0.5 * np.sum(mean * mean * r, axis=2) - np.sum(np.log(scale), axis=2) \
        - dx * 0.5 * np.log(2 * np.pi)
    if floor == "part":
        c[0, 0, : k // 3 + 1] = -3e30
    if floor == "row":
        c[t1 // 2, b - 1] = -3e30
    lw = rng.standard_normal((t1, b, k)) * 2.0
    lwn = lw - np.log(np.sum(np.exp(lw), axis=-1, keepdims=True))
    lg = rng.standard_normal((t1, b, k))
    gum = rng.gumbel(size=(t1, b, m, k))
    x_anchor = rng.standard_normal((b, m, dx)) * 8.0
    ops = [torch.from_numpy(np.asarray(a, np.float32)).contiguous()
           for a in (x_anchor, xs, r, mean * r, c, lwn, lg, gum)]
    if one_pick:
        sel = torch.full((t1, b, m), k // 2, dtype=torch.int32)
    else:
        sel = ffbsi.ffbsi_forward_reference(*ops)[4]
    idx = sel.long()[:, :, None, :].expand(-1, -1, dx, -1)
    xtilde = torch.gather(ops[1], 3, idx).transpose(2, 3).contiguous()
    return ops, sel.contiguous(), xtilde


def _cotangents(shapes, live, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g) if i in live else None for i, s in enumerate(shapes)]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _warp_scatter(v, maximum):
    """The kernel's warp_scatter on v [..., W, 32, G]: at each level (xor O,
    H paths kept) a lane keeps half its paths and combines its partner's
    partials of those, then plain butterflies; returns [..., W, G], path p
    read from lane p * 32 / G."""
    op = torch.maximum if maximum else torch.add
    lane = torch.arange(32)
    g = v.shape[-1]
    h, o = g // 2, 16
    while h >= 1:
        up = ((lane & o) != 0)[:, None]
        lo, hi = v[..., :h], v[..., h:2 * h]
        send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
        v = op(keep, send[..., lane ^ o, :])
        h, o = h // 2, o // 2
    r = v[..., 0]
    o = 16 // g
    while o >= 1:
        r = op(r, r[..., lane ^ o])
        o //= 2
    return r[..., :: 32 // g]


def _over_warps(x, maximum):
    """[..., W, G] merged over the warps in order."""
    if maximum:
        return x.amax(-2)
    s = x[..., 0, :]
    for w in range(1, x.shape[-2]):
        s = s + x[..., w, :]
    return s


def _seq_sum(x):
    """Sum over the last axis in order, from 0.0 (a thread's particles)."""
    s = torch.zeros(x.shape[:-1])
    for i in range(x.shape[-1]):
        s = s + x[..., i]
    return s


def _patch(out, cot, sel, mutation=None):
    """Zero d_xs of one point (out [DX, K]), then write each selected
    particle's sum over the paths that picked it (path order, from 0.0) by
    the first path that picked it."""
    if mutation != "patch first":
        out.zero_()
    sel = [int(j) for j in sel]
    for m, j in enumerate(sel):
        if mutation == "every path writes":
            s = torch.zeros(out.shape[0])
            for e in range(m, len(sel)):
                if sel[e] == j:
                    s = s + cot[e]
                    break  # a path that writes its own sum only: the last writer wins
            out[:, j] = s
            continue
        if j in sel[:m]:
            continue
        s = torch.zeros(out.shape[0])
        for e in range(m, len(sel)):
            if sel[e] == j:
                s = s + cot[e]
        out[:, j] = s
    if mutation == "patch first":
        out.zero_()


def _row_scatter(cot, sel, k):
    """The row design's scatter of one point: every particle j adds the
    cotangents of the paths that picked it, in path order, from 0.0."""
    j = torch.arange(k)
    s = torch.zeros(cot.shape[-1], k)
    for m in range(sel.shape[0]):
        s = s + torch.where(j == int(sel[m]), cot[m][:, None], torch.zeros(()))
    return s


def _point_cots(d_x_first, d_xtilde, dq, t1, b, m, dx):
    """The cotangent of each trajectory point, as the kernels form it:
    point t + 1 gets d_q of step t + d_xtilde[t + 1], point 0
    d_xtilde[0] + d_x_first."""
    dxt = d_xtilde if d_xtilde is not None else torch.zeros(t1, b, m, dx)
    dxf = d_x_first if d_x_first is not None else torch.zeros(b, m, dx)
    cots = [dxt[0] + dxf]
    for t in range(1, t1):
        cots.append(dq[t - 1] + dxt[t])
    return cots


def emulate_staged(x_anchor, xs, r, mr, c, lwn, lg, sel, xtilde, d_x_first=None, d_logp=None,
                   d_logq=None, d_xtilde=None, needs=(True,) * 5, threads=256, mutation=None):
    """K6's staged design in torch, float32: returns what ffbsi_backward
    returns. threads: the CTA's threads (256 in the kernel; fewer makes the
    chunk of threads * K6_PER particles short, so rows go in chunks)."""
    t1, b, dx, k = xs.shape
    m_all = x_anchor.shape[1]
    d_anchor, d_xs = torch.zeros(x_anchor.shape), torch.zeros(xs.shape)
    outs = [torch.zeros(xs.shape) if need else None for need in needs[:2]]
    outs += [torch.zeros(c.shape) if need else None for need in needs[2:]]
    if d_logp is None and d_logq is None:  # paths only: zeros, then the patch
        cots = _point_cots(d_x_first, d_xtilde, torch.zeros(t1, b, m_all, dx), t1, b, m_all, dx)
        for t in range(t1):
            for bb in range(b):
                _patch(d_xs[t, bb], cots[t][bb], sel[t, bb], mutation)
        return (d_anchor, d_xs, *outs)

    g_sz, per = ffbsi.K6_GROUP, ffbsi.K6_PER
    warps = threads // 32
    chunk = threads * per
    n_rows = t1 * b
    q = torch.cat([xtilde[1:], x_anchor[None]]).reshape(n_rows, m_all, dx)  # step t's queries
    zeros = torch.zeros(b, m_all)
    gp = (d_logp if d_logp is not None else zeros).repeat(t1, 1)
    gq = (d_logq if d_logq is not None else zeros).repeat(t1, 1)
    sel_r = sel.reshape(n_rows, m_all).long()
    rr, mm_, cc, ll = (v.reshape(n_rows, *v.shape[2:]) for v in (r, mr, c, lwn))
    n_ch = -(-k // chunk)
    groups = range(0, m_all, g_sz)

    def logits(j0, g0):
        """[R, G, threads, per] logits and floor cuts of paths g0 .. g0 + G - 1
        on each thread's particles of the chunk at j0; -inf past the end."""
        j = j0 + torch.arange(chunk).reshape(threads, per)
        valid = j < k
        jc = torch.where(valid, j, 0).reshape(-1)
        paths = torch.arange(g0, g0 + g_sz)
        live_p = paths < m_all
        qg = q[:, torch.where(live_p, paths, 0)]
        raw = ffbsi.pair_logp(qg, rr[:, :, jc], mm_[:, :, jc], cc[:, jc])
        raw = raw.reshape(n_rows, g_sz, threads, per)
        live = valid[None, None] & live_p[None, :, None, None]
        cut = live & (raw < -1e30)
        lg_ = torch.clamp(raw, min=-1e30) + ll[:, jc].reshape(n_rows, 1, threads, per)
        return torch.where(live, lg_, -torch.inf), cut, j, valid

    def stats(L, cut, j, valid, g0, careful_of):
        """The CTA's per-path max, then e, sum e, sum e*mr_d, sum e*r_d (the
        floored pairs left out one by one only where some max is floored)."""
        v = L.amax(-1).permute(0, 2, 1).reshape(n_rows, warps, 32, g_sz)
        mx = _over_warps(_warp_scatter(v, True), True)
        mx = torch.where(torch.arange(g0, g0 + g_sz) < m_all, mx, 0.0)
        e = torch.exp(L - mx[..., None, None])
        jc = torch.where(valid, j, 0).reshape(-1)
        on = valid[None, None] & (~cut if careful_of(mx, g0) else True)
        terms = [e]
        for src in (mm_, rr):
            for d in range(dx):
                x = src[:, d, jc].reshape(n_rows, 1, threads, per)
                terms.append(torch.where(on, e * x, 0.0))
        sums = []
        for term in terms:
            part = _seq_sum(term).permute(0, 2, 1).reshape(n_rows, warps, 32, g_sz)
            sums.append(_over_warps(_warp_scatter(part, False), False))
        return mx, e, torch.stack(sums, -1)  # [R, G], [R, G, T, P], [R, G, 1 + 2 DX]

    def accumulate(acc, e, cut, inv, g0, careful):
        """The soft part s = e * gq / sum of d_pair, per particle in path
        order; a floored pair is cut one by one only where the path's max is
        floored too (else its e is exactly 0)."""
        for g in range(g_sz):
            m = g0 + g
            if m >= m_all:
                break
            s = e[:, g] * (gq[:, m] * inv[:, g])[:, None, None]
            c = cut[:, g] if careful and mutation != "no floor cut" else torch.zeros_like(s, dtype=bool)
            acc["X"] = acc["X"] + torch.where(c, s, 0.0)
            s = torch.where(c, 0.0, s)
            acc["A"] = acc["A"] + s
            for d in range(dx):
                qd = q[:, m, d, None, None]
                acc[f"r{d}"] = acc[f"r{d}"] + (-0.5 * (qd * qd)) * s
                acc[f"mr{d}"] = acc[f"mr{d}"] + qd * s

    def finish(acc, j, valid, cut_sel):
        """The picks' part oh * (gp + gq) (none where the pick's pair is
        floored) in path order, less the soft sums; written at j."""
        out = {"c": torch.zeros(n_rows, threads, per), "lwn": torch.zeros(n_rows, threads, per),
               "lg": torch.zeros(n_rows, threads, per)}
        for d in range(dx):
            out[f"r{d}"] = torch.zeros(n_rows, threads, per)
            out[f"mr{d}"] = torch.zeros(n_rows, threads, per)
        for m in range(m_all):
            oh = j[None] == sel_r[:, m, None, None]
            gsum = (gp[:, m] + gq[:, m])[:, None, None]
            out["lwn"] = out["lwn"] + torch.where(oh, gq[:, m, None, None], 0.0)
            out["lg"] = out["lg"] + torch.where(oh, gp[:, m, None, None], 0.0)
            keep = oh & (~cut_sel[:, m, None, None] if mutation != "no floor cut" else True)
            out["c"] = out["c"] + torch.where(keep, gsum, 0.0)
            for d in range(dx):
                qd = q[:, m, d, None, None]
                out[f"r{d}"] = out[f"r{d}"] + torch.where(keep, -0.5 * (qd * qd) * gsum, 0.0)
                out[f"mr{d}"] = out[f"mr{d}"] + torch.where(keep, qd * gsum, 0.0)
        out["lwn"] = out["lwn"] - (acc["A"] + acc["X"])
        out["c"] = out["c"] - acc["A"]
        for d in range(dx):
            out[f"r{d}"] = out[f"r{d}"] - acc[f"r{d}"]
            out[f"mr{d}"] = out[f"mr{d}"] - acc[f"mr{d}"]
        jv = j[valid]
        for name, v in out.items():
            x = v.reshape(n_rows, -1)[:, valid.reshape(-1)]
            i = {"c": 2, "lwn": 3, "lg": 4}.get(name, 0 if name[0] == "r" else 1)
            if outs[i] is None:
                continue
            if i >= 2:
                outs[i].view(n_rows, k)[:, jv] = x
            else:
                outs[i].view(n_rows, dx, k)[:, int(name[-1]), jv] = x

    def fresh():
        names = ["A", "X"] + [f"{p}{d}" for p in ("r", "mr") for d in range(dx)]
        return {n: torch.zeros(n_rows, threads, per) for n in names}

    def careful_of(mx, g0):
        live = torch.arange(g0, g0 + g_sz) < m_all
        return bool(((mx < -1e29) & live).any())

    st = {}  # path m: (max, sums [1 + 2 DX])
    soft = []  # per chunk: the soft sums, the particles and their validity
    if n_ch == 1:  # one pass: the logits stay from the pair to d_pair
        acc = fresh()
        for g0 in groups:
            L, cut, j, valid = logits(0, g0)
            mx, e, sums = stats(L, cut, j, valid, g0, careful_of)
            for g in range(min(g_sz, m_all - g0)):
                st[g0 + g] = (mx[:, g], sums[:, g])
            accumulate(acc, e, cut, 1.0 / sums[..., 0], g0, careful_of(mx, g0))
        soft.append((acc, j, valid))
    else:  # pass 1: the sums over every chunk, merged in chunk order; pass 2: d_pair
        for ch in range(n_ch):
            for g0 in groups:
                L, cut, j, valid = logits(ch * chunk, g0)
                mx, _, sums = stats(L, cut, j, valid, g0, careful_of)
                for g in range(min(g_sz, m_all - g0)):
                    if g0 + g not in st:
                        st[g0 + g] = (torch.full((n_rows,), -torch.inf), torch.zeros(n_rows, 1 + 2 * dx))
                    om, os_ = st[g0 + g]
                    nm = torch.maximum(om, mx[:, g])
                    fa, fb = torch.exp(om - nm), torch.exp(mx[:, g] - nm)
                    st[g0 + g] = (nm, os_ * fa[:, None] + sums[:, g] * fb[:, None])
        for ch in range(n_ch):
            acc = fresh()
            for g0 in groups:
                L, cut, j, valid = logits(ch * chunk, g0)
                paths = [min(g0 + g, m_all - 1) for g in range(g_sz)]
                pm = torch.stack([st[p][0] if g0 + g < m_all else torch.zeros(n_rows)
                                  for g, p in enumerate(paths)], 1)
                inv = torch.stack([1.0 / st[p][1][:, 0] for p in paths], 1)
                accumulate(acc, torch.exp(L - pm[..., None, None]), cut, inv, g0, careful_of(pm, g0))
            soft.append((acc, j, valid))

    # d_q from the sums: [sel not cut] (gp + gq)(mr - q r)[sel] - gq / sum (sum e mr - q sum e r)
    dq = torch.zeros(n_rows, m_all, dx)
    cut_sel = torch.zeros(n_rows, m_all, dtype=torch.bool)
    for m in range(m_all):
        js = sel_r[:, m]
        rs = torch.gather(rr, 2, js[:, None, None].expand(-1, dx, 1))[..., 0]
        ms = torch.gather(mm_, 2, js[:, None, None].expand(-1, dx, 1))[..., 0]
        cs = torch.gather(cc, 1, js[:, None])
        cut_s = ffbsi.pair_logp(q[:, m:m + 1], rs[..., None], ms[..., None], cs)[:, 0, 0] < -1e30
        cut_sel[:, m] = cut_s
        if mutation == "no floor cut":
            cut_s = torch.zeros_like(cut_s)
        _, sums = st[m]
        gsum, w = gp[:, m] + gq[:, m], gq[:, m] * (1.0 / sums[:, 0])
        sa = torch.where(cut_s[:, None], 0.0, gsum[:, None] * ms) - w[:, None] * sums[:, 1:1 + dx]
        sb = torch.where(cut_s[:, None], 0.0, gsum[:, None] * rs) - w[:, None] * sums[:, 1 + dx:]
        dq[:, m] = sa - q[:, m] * sb
    for acc, j, valid in soft:
        finish(acc, j, valid, cut_sel)
    dq = dq.reshape(t1, b, m_all, dx)
    d_anchor.copy_(dq[t1 - 1])
    cots = _point_cots(d_x_first, d_xtilde, dq, t1, b, m_all, dx)
    for t in range(t1):
        for bb in range(b):
            _patch(d_xs[t, bb], cots[t][bb], sel[t, bb], mutation)
    return (d_anchor, d_xs, *outs)


def _rel(a, w):
    return float((a - w).norm() / w.norm()) if float(w.norm()) > 0 else float(a.abs().max())


def _run(dx, m, k, live, needs, seed=0, b=2, t1=3, floor=None, one_pick=False, **kw):
    ops, sel, xtilde = _sweep(dx, b, m, k, t1, seed, floor, one_pick)
    cots = _cotangents(((b, m, dx), (b, m), (b, m), (t1, b, m, dx)), live, seed + 1)
    args = (*ops[:7], sel, xtilde)
    got = emulate_staged(*args, *cots, needs=needs, **kw)
    want = ffbsi.ffbsi_backward_reference(*args, *cots, needs=needs)
    return got, want, args, cots


def _close(got, args, cots, needs, skip=None):
    """Each leaf within 1e-5 relative L2 of the float64 plain version, or no
    further from it than twice the float32 plain version; None where it is.
    skip: (leaf, t, b) left out of the comparison."""
    want = ffbsi.ffbsi_backward_reference(*args, *cots, needs=needs)
    wide = [a.double() if a.is_floating_point() else a for a in args]
    w64 = ffbsi.ffbsi_backward_reference(*wide, *[None if x is None else x.double() for x in cots],
                                         needs=needs)
    for i, (a, w, w6) in enumerate(zip(got, want, w64)):
        assert (a is None) == (w is None), i
        if a is None:
            continue
        a, w, w6 = a.double(), w.double(), w6.clone()
        if skip is not None and skip[0] == i:
            a[skip[1:]] = w[skip[1:]] = w6[skip[1:]] = 0.0
        assert _rel(a, w6) <= max(_TOL, 2 * _rel(w, w6)), (i, _rel(a, w6), _rel(w, w6))


# ---------------------------------------------------------------------------
# K6 staged against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dx", [2, 3])
@pytest.mark.parametrize("m", [1, 3, 8, 16, 40])
@pytest.mark.parametrize("k", [4, 100, 128, 1024])
def test_k6_staged_emulation_matches_plain(dx, m, k):
    """All cotangents and the paths alone, per leaf within 1e-5 relative L2
    of ffbsi_backward_reference; a partly floored row among the steps."""
    for name in ("all four", "paths only"):
        got, _, args, cots = _run(dx, m, k, *_NEEDS[name], seed=dx * 1000 + m * 10 + k,
                                  floor="part")
        _close(got, args, cots, _NEEDS[name][1])


@pytest.mark.parametrize("name", sorted(_NEEDS))
def test_k6_staged_emulation_honours_each_needs_pattern(name):
    """Each pattern of live cotangents and wanted support gradients (the
    leaves not wanted are None; with no pair cotangent the support's are
    zero)."""
    got, _, args, cots = _run(3, 8, 128, *_NEEDS[name], seed=7)
    _close(got, args, cots, _NEEDS[name][1])


def test_k6_staged_emulation_every_path_one_particle():
    """Every path of every row picks the same particle: one owner adds all
    M cotangents in path order, the other paths write nothing."""
    for name in ("all four", "paths only"):
        got, _, args, cots = _run(3, 16, 100, *_NEEDS[name], seed=3, one_pick=True)
        _close(got, args, cots, _NEEDS[name][1])


def test_k6_staged_emulation_wholly_floored_row():
    """A row whose every pair is floored: d_pair is cut everywhere, so the
    row's d_c, d_r, d_mr are zero and d_q gets nothing from it. Every leaf
    matches the plain version but d_lwn on that row: there the plain
    version's logsumexp absorbs lwn and log K into -1e30 and gives each
    particle a softmax of 1, where the kernels (and the reference's TPU
    kernel) take exp(0) / K."""
    got, _, args, cots = _run(3, 8, 128, *_NEEDS["all four"], seed=5, floor="row", t1=4)
    t, b = 2, 1  # the floored row
    _close(got, args, cots, _NEEDS["all four"][1], skip=(5, t, b))
    for i in (2, 3, 4):
        assert float(got[i][t, b].abs().max()) == 0.0


@pytest.mark.parametrize("k", [100, 1024])
def test_k6_staged_emulation_in_chunks(k):
    """A CTA of 32 threads stages 128 particles at a time: the rows go in
    chunks (two passes, the sums merged chunk by chunk) and still match the
    plain version and the whole-row emulation."""
    got, _, args, cots = _run(3, 16, k, *_NEEDS["all four"], seed=11, threads=32)
    _close(got, args, cots, _NEEDS["all four"][1])
    whole = emulate_staged(*args, *cots)
    for a, h in zip(got, whole):
        assert _rel(a, h) <= _TOL


@pytest.mark.parametrize("m,k", [(8, 4), (16, 100), (40, 1024)])
def test_k6_paths_only_is_bit_equal_to_the_row_design_scatter(m, k):
    """Zeros, then the first picking path's sum in path order: the row
    design's d_xs (every particle adding its pickers in path order) bit
    for bit, and d_x_anchor zero."""
    ops, sel, xtilde = _sweep(3, 2, m, k, 4, seed=m + k)
    d_x_first, _, _, d_xtilde = _cotangents(((2, m, 3), (2, m), (2, m), (4, 2, m, 3)), (0, 3), 9)
    got = emulate_staged(*ops[:7], sel, xtilde, d_x_first, None, None, d_xtilde,
                         needs=(False,) * 5)
    cots = _point_cots(d_x_first, d_xtilde, torch.zeros(4, 2, m, 3), 4, 2, m, 3)
    want = torch.stack([torch.stack([_row_scatter(cots[t][b], sel[t, b], k) for b in range(2)])
                        for t in range(4)])
    assert torch.equal(got[1], want)
    assert torch.equal(got[0], torch.zeros(2, m, 3))


@pytest.mark.parametrize("mutation,name,floor", [
    ("patch first", "paths only", None),
    ("every path writes", "all four", None),
    ("no floor cut", "all four", "row"),
])
def test_k6_staged_emulation_mutations_are_caught(mutation, name, floor):
    """Each fault, put into the emulation, moves a leaf past the tolerance
    against the plain version (d_xs for the first two, d_c for the floor
    cut on a wholly floored row)."""
    got, want, _, _ = _run(3, 8, 4 if floor is None else 128, *_NEEDS[name], seed=2, floor=floor,
                           t1=4, mutation=mutation)
    leaf = 4 if mutation == "no floor cut" else 1
    assert _rel(got[leaf], want[leaf]) > 1e-2


def test_k6_staged_emulation_matches_the_reference_vjp_kernel(monkeypatch):
    """B=2, M=8, K=128, T=6: the emulation against `pallas_ffbsi._scan_bwd`
    (through jax.vjp of run_ffbsi_scan, interpret mode) within 1e-5
    relative L2 per leaf. The reference's grid takes 8 rows a block, so the
    two rows are tiled to 8 there; its leaves are read on the first two."""
    monkeypatch.setattr(pallas_ffbsi, "_INTERPRET", True)
    dx, b, m, k, t1 = 3, 2, 8, 128, 5
    ops, sel, xtilde = _sweep(dx, b, m, k, t1, seed=21)
    cots = _cotangents(((b, m, dx), (b, m), (b, m), (t1, b, m, dx)), (0, 1, 2, 3), 22)
    tile = [np.concatenate([a.numpy()] * 4, axis=0 if i == 0 else 1) for i, a in enumerate(ops)]
    jcots = [np.concatenate([cots[0].numpy()] * 4, 0), np.concatenate([cots[1].numpy()] * 4, 0),
             np.concatenate([cots[2].numpy()] * 4, 0), np.concatenate([cots[3].numpy()] * 4, 1)]
    x_anchor, xs, r, mr, c, lwn, lg, gum = tile

    def ref(xa, xs_, r_, mr_, c_, lwn_, lg_):
        return pallas_ffbsi.run_ffbsi_scan(None, {"r": r_, "mr": mr_, "c": c_}, xs_, lwn_, lg_,
                                           gum, xa, dx)

    out, vjp = jax.vjp(ref, x_anchor, xs, r, mr, c, lwn, lg)
    assert np.array_equal(np.asarray(out[3])[:, :b], xtilde.numpy())  # the same selections
    want = vjp(tuple(jcots))
    got = emulate_staged(*ops[:7], sel, xtilde, *cots)
    for i, (a, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(w))
        w = w[:b] if i == 0 else w[:, :b]
        assert _rel(a, w) <= _TOL, (i, _rel(a, w))


# ---------------------------------------------------------------------------
# K2 pair: its write map over the launch plan
# ---------------------------------------------------------------------------


def emulate_pair(seed, t_len, batch, dx, k, t0=0):
    """K2's pair design over its grid: thread x of CTA (t·B + row, j, z)
    draws pair p = z·256 + x < K/2 of group j and writes rows 2j, 2j + 1 at
    particles p and p + K/2; thread 0 of CTA (tr, 0, 0) writes u0."""
    plan = fused_step.k2_plan(t_len, batch, dx, k)
    n_tr, groups, tiles = plan["grid"]
    half = k // 2
    eps = torch.full((t_len, batch, dx, k), float("nan"))
    tr = torch.arange(n_tr)[:, None, None, None]
    j = torch.arange(groups)[None, :, None, None]
    p = (torch.arange(tiles)[:, None] * fused_step.K2_THREADS
         + torch.arange(fused_step.K2_THREADS)[None, :])[None, None]
    shape = (n_tr, groups, tiles, fused_step.K2_THREADS)
    tr, j, p = (v.expand(shape).reshape(-1) for v in (tr, j, p))
    live = p < half
    tr, j, p = tr[live], j[live], p[live]
    t, row = tr // batch + t0, tr % batch
    words = fused_step.philox4x32_reference((p, t, row, j + 1), seed)
    for half_row in range(2):
        d = 2 * j + half_row
        ok = d < dx
        u1 = 1.0 - fused_step._unit24(words[2 * half_row])
        u2 = fused_step._unit24(words[2 * half_row + 1])
        rad = torch.sqrt(-2.0 * torch.log(u1))
        ang = 6.283185307179586 * u2
        ti, ri, di, pi = tr[ok] // batch, row[ok], d[ok], p[ok]
        eps[ti, ri, di, pi] = (rad * torch.cos(ang))[ok]
        eps[ti, ri, di, pi + half] = (rad * torch.sin(ang))[ok]
    trs = torch.arange(t_len * batch)
    zero = torch.zeros((), dtype=torch.int64)
    u0 = fused_step._unit24(fused_step.philox4x32_reference(
        (zero, trs // batch + t0, trs % batch, zero), seed)[0]).reshape(t_len, batch)
    return eps, u0


@pytest.mark.parametrize("dx", [1, 2, 3, 5, 40])
@pytest.mark.parametrize("k", [2, 6, 256, 1026])
def test_k2_pair_write_map_is_bit_equal_to_plain_philox(dx, k):
    seed = (0x1234ABCD, 0x0F0F1234)
    for t0 in (0, 5):
        got = emulate_pair(seed, 2, 3, dx, k, t0)
        want = fused_step.stream_noise_reference(seed, 2, 3, dx, k, t0=t0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("t_len,batch,dx,k", [(99, 32, 2, 1024), (3, 8, 40, 8192), (2, 3, 5, 1026),
                                              (1, 1, 1, 2)])
def test_k2_launch_plan_covers_every_draw_once(t_len, batch, dx, k):
    """Every (t, row, pair, group) is drawn by exactly one thread of the
    grid, and the grid is the issue's: 7,680 CTAs at [3, 8, 40, 8192]."""
    plan = fused_step.k2_plan(t_len, batch, dx, k)
    n_tr, groups, tiles = plan["grid"]
    assert plan["ctas"] == n_tr * groups * tiles
    half = k // 2
    tr = torch.arange(n_tr)[:, None, None, None]
    j = torch.arange(groups)[None, :, None, None]
    p = (torch.arange(tiles)[:, None] * fused_step.K2_THREADS
         + torch.arange(fused_step.K2_THREADS))[None, None]
    shape = (n_tr, groups, tiles, fused_step.K2_THREADS)
    tr, j, p = (v.expand(shape).reshape(-1) for v in (tr, j, p))
    live = p < half
    draw = (tr[live] * groups + j[live]) * half + p[live]  # (t·B + row, group, pair)
    count = torch.bincount(draw, minlength=n_tr * groups * half)
    assert bool((count == 1).all()) and n_tr == t_len * batch and groups == (dx + 1) // 2
    if (t_len, batch, dx, k) == (3, 8, 40, 8192):
        assert plan["ctas"] == 7680
    if (t_len, batch, dx, k) == (99, 32, 2, 1024):
        assert plan["ctas"] == 6336


# ---------------------------------------------------------------------------
# the host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,source,tail,designs", [
    ("psvo_ffbsi_backward", "ffbsi.cu", ["dx", "design"], ffbsi.K6_DESIGNS),
    ("psvo_stream_noise", "stream_noise.cu", ["K", "design"], fused_step.K2_DESIGNS),
])
def test_ctypes_signature_carries_the_design(name, source, tail, designs):
    """The entry point's argtypes match its C parameters (pointers and the
    stream c_void_p, uint32 seeds c_uint32, ints c_int), the design last
    before the stream; design 0 is the new kernel, 1 the previous."""
    src = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    params = [tuple(p.strip().rsplit(None, 1)) for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in t else ctypes.c_uint32 if "uint32_t" in t else ctypes.c_int
            for t, _ in params]
    assert _build.SIGNATURES[name] == want
    assert [n for _, n in params][-len(tail) - 1:] == tail + ["stream"]
    assert "design == 0" in src and len(designs) == 2


def test_designs_and_their_checks():
    """Each wrapper names its designs, new first, refuses an unknown one,
    and counts no launch for CPU tensors (the plain version runs)."""
    assert ffbsi.K6_DESIGNS == ("staged", "row") and fused_step.K2_DESIGNS == ("pair", "particle")
    ops, sel, xtilde = _sweep(2, 2, 3, 8, 2, seed=0)
    with pytest.raises(ValueError, match="no design"):
        ffbsi.ffbsi_backward(*ops[:7], sel, xtilde, design="tiled")
    with pytest.raises(ValueError, match="no design"):
        fused_step.stream_noise((1, 2), 2, 2, 2, 8, "cpu", design="tiled")
    before = (ffbsi.ffbsi_backward.launches, dict(ffbsi.ffbsi_backward.launches_by_design),
              fused_step.stream_noise.launches, dict(fused_step.stream_noise.launches_by_design))
    calls = ffbsi.ffbsi_backward_reference.calls
    ffbsi.ffbsi_backward(*ops[:7], sel, xtilde, d_xtilde=torch.ones_like(xtilde), design="row")
    fused_step.stream_noise((1, 2), 2, 2, 2, 8, "cpu", design="particle")
    assert ffbsi.ffbsi_backward_reference.calls == calls + 1
    assert before == (ffbsi.ffbsi_backward.launches, ffbsi.ffbsi_backward.launches_by_design,
                      fused_step.stream_noise.launches, fused_step.stream_noise.launches_by_design)


@pytest.mark.parametrize("dx", [2, 3])
def test_k6_shared_memory(dx):
    """The all-cotangents kernel's shared memory fits a CTA for every M and
    K of the class: two row buffers for whole rows (K <= K6_CHUNK), one
    chunk's for longer rows, whatever K; two CTAs an SM at the preset."""
    for m in (1, 8, 9, 16, 255, 256):
        for k in (4, 130, 1024, 1025, 8192, 19200):
            nbytes = ffbsi.k6_smem_bytes(dx, m, k)
            assert nbytes <= fused_step.SMEM_LIMIT
            if k > ffbsi.K6_CHUNK:
                assert nbytes == ffbsi.k6_smem_bytes(dx, m, 19200) < ffbsi.k6_smem_bytes(dx, m, 1024)
    assert ffbsi.k6_smem_bytes(3, 16, 1024) == 70592
    assert 2 * ffbsi.k6_smem_bytes(3, 16, 1024) <= fused_step.SMEM_LIMIT
