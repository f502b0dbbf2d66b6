"""Resampling at every K, against the reference.

K7 (`ops/resample_gather.py::ancestor_indices_large`) takes every K from 1
to 32768, the reference's `pallas_resample.MAX_K_IDX`: slices of ceil(K/C)
particles (the last shorter, a thread's chunk cut at the slice's end), the
row's fp64 CDF in each CTA of the cluster where it fits and spread over
the cluster where it does not (each CTA keeps its slice's CDF; a position is
searched in the slice whose end first exceeds it, that slice's offset added
to each value read). Above 32768 `resample_and_gather` takes the count
form as tensor ops on the card, as the reference takes `_indices_jnp`.
Held here, on the CPU:

- K7's plain version (the count form) against the reference's
  `_indices_jnp` at K in {1, 255, 300, 384, 1000, 4096} and its
  `_indices_large` in interpret mode where that kernel runs (K a multiple
  of 128): every index equal but within float32 rounding of a CDF boundary;
- K7's plan for every K from 1 to 32768 (the cluster size, the slices, the
  spread CDF, the shared memory) and a torch emulation of the new slicing
  and of the spread search against the count form, with a mutation that
  must be caught;
- the route above the cap (the count form and K8's plain gather on CPU
  tensors; the training hole `smc.backward_hole`, which follows the
  reference's `_rg_bwd`: its sorted segment sum's kernels at K % 128 == 0
  are a hole, its plain scatter-add elsewhere is the port's `scatter_add_`
  on the card);
- the FHN filter at K = 1000, where the port's CUDA path resampled through
  K7 and raised, against the reference's scan on the same noise: values at
  2e-4, every gradient leaf at rtol 5e-3 / atol 5e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.objectives import make_objective as j_make_objective
from psvo_tpu.ops import pallas_resample
from psvo_tpu_torch import bridge, smc
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective as t_make_objective
from psvo_tpu_torch.ops import fused_step, resampling
from psvo_tpu_torch.ops import resample_gather as rg
from psvo_tpu_torch.ops.fused_step import CLUSTER_SIZES, SMEM_LIMIT
from tests._torch_port import assert_close, assert_grads_close, key_noise, models, observations, to_torch

torch.set_num_threads(1)

_THREADS = 256
_ANY_K = (1, 255, 300, 384, 1000, 4096)


def _weight_rows(k: int, seed: int = 0) -> np.ndarray:
    """Eight log-weight rows as `chip_smoke.weight_rows` makes them: generic,
    uniform, ties, zero weights, all floored, a floored mix, one dominant
    particle and a wide spread."""
    rng = np.random.default_rng(seed)
    i = np.arange(k)
    return np.stack([
        rng.standard_normal(k) * 3,
        np.zeros(k),
        -rng.integers(0, 3, k).astype(np.float64),
        np.where(i % 3 == 0, 0.0, -np.inf),
        np.full(k, -3e30),
        np.where(i % 5 == 0, -1.0, -1e30),
        np.where(i == (517 * k) // 1024, 0.0, -50.0),
        np.linspace(-100.0, 0.0, k),
    ]).astype(np.float32)


def _systematic(k: int, seed: int) -> np.ndarray:
    u0 = np.random.default_rng(seed).uniform(size=8).astype(np.float32)
    return fused_step.systematic_positions(torch.from_numpy(u0), k).numpy()


# ---- the plain version against the reference's index functions ----


@pytest.mark.parametrize("k", _ANY_K)
def test_count_form_matches_the_reference_indices(k):
    """K7's plain version (the count form on an fp64 CDF) gives the
    reference's indices, `_indices_jnp` (a float32 cumsum of the normalised
    weights) and, where it runs, `_indices_large` in interpret mode (an MXU
    cumsum and a two-level count), on every row but the wholly floored one,
    except where a position lies within float32 rounding of a CDF boundary
    (every fp64 CDF value between the two answers within 1e-6 of the row's
    total of the position: the float32 CDFs land on the other side of
    those values, zero weights between them included). On the wholly floored row the reference's float32
    normalisation sends every position to ancestor 0, where the count form,
    exp(lw − max) = 1, takes each particle once."""
    lw, pos = _weight_rows(k, seed=k), _systematic(k, seed=k + 1)
    want = fused_step.count_form_indices(torch.from_numpy(lw), torch.from_numpy(pos)).numpy()
    funcs = [pallas_resample._indices_jnp]
    if k % pallas_resample.Q == 0 and k <= pallas_resample.MAX_K_IDX:
        funcs.append(pallas_resample._indices_large)
    rows = [b for b in range(8) if b != 4]
    for fn in funcs:
        with pallas_resample_interpret():
            got = np.asarray(fn(jnp.asarray(pos), jnp.asarray(lw)))
        for b in rows:
            m = lw[b].max()
            cdf = np.cumsum(np.exp((lw[b] - m).astype(np.float64)))
            bad = np.nonzero(got[b] != want[b])[0]
            assert len(bad) <= max(1, k // 1000), (fn.__name__, b, len(bad))
            for i in bad:  # every CDF value the two counts disagree on is at the position
                lo, hi = sorted((int(got[b, i]), int(want[b, i])))
                dist = np.abs(cdf[lo:hi] - pos[b, i] * cdf[-1]).max() / cdf[-1]
                assert dist <= 1e-6, (fn.__name__, b, i, dist)
    assert (np.asarray(pallas_resample._indices_jnp(jnp.asarray(pos[4:5]), jnp.asarray(lw[4:5])))
            == 0).all()
    assert (want[4] == np.arange(k)).all()


class pallas_resample_interpret:
    """The reference's resample kernels in interpret mode, as its own CPU
    tests run them."""

    def __enter__(self):
        self.was = pallas_resample._INTERPRET
        pallas_resample._INTERPRET = True

    def __exit__(self, *exc):
        pallas_resample._INTERPRET = self.was


# ---- K7's plan for every K ----


def test_k7_plan_holds_every_k_up_to_the_cap():
    """For every K from 1 to 32768 and B in (1, 8, 32, 200) k7_cluster picks a
    C in CLUSTER_SIZES whose slices are all non-empty, with at least 256
    particles a CTA where C > 1; the CTA's shared memory, the row's CDF or
    (k7_spread) the slice's, fits; the CDF is spread only where the row's
    does not fit beside the slice (never up to K = 19200, always at 32768 on
    8 CTAs); above the cap no plan."""
    spread_ks = set()
    for k in range(1, rg.MAX_K + 1):
        for batch in (1, 8, 32, 200):
            c = rg.k7_cluster(batch, k, 132)
            s = -(-k // c)
            assert c in CLUSTER_SIZES and (c - 1) * s < k and (c == 1 or k >= c * _THREADS)
            spread = rg.k7_spread(k, c)
            assert rg.k7_cluster_smem_bytes(k, c, spread) <= SMEM_LIMIT
            assert spread == (rg.k7_cluster_smem_bytes(k, c) > SMEM_LIMIT)
            if spread:
                spread_ks.add(k)
    assert min(spread_ks) > 19200 and rg.MAX_K in spread_ks
    assert rg.k7_cluster(8, rg.MAX_K, 132) == 8 and rg.k7_cluster(32, rg.MAX_K, 132) == 4
    assert rg.k7_cluster_smem_bytes(rg.MAX_K, 8, True) == 8 * (4096 + 10) + 4 * (4096 + 9)
    assert not rg.k_ok(rg.MAX_K + 1)
    with pytest.raises(ValueError, match="no cluster"):
        rg.k7_cluster(8, rg.MAX_K * 2, 132)


# ---- the new slicing and the spread search, emulated ----


def _k7_emulate_any(logw, pos, cluster, spread, mutate=None):
    """K7's cluster design at any K: slices of S = ceil(K/C) (rank r owns
    [r·S, min(K, (r + 1)·S))), a thread's chunk of ceil(S/256) cut at the
    slice's end; each slice's fp64 scan (a thread's weights in order, the
    warp's shuffles, the warps in order); the offsets and the slice ends in
    rank order; each position's count in the whole offset CDF, or (spread)
    in the slice whose end first exceeds it, its offset added to each value
    (mutate="offset": the previous slice's offset)."""
    b, k = logw.shape
    s = -(-k // cluster)
    per = -(-s // _THREADS)
    m = logw.amax(-1, keepdim=True)
    w = torch.exp(logw - m).double()
    lane = torch.arange(32)
    locals_, totals = [], []
    for r in range(cluster):
        lo, n = r * s, min(s, k - r * s)
        chunk = torch.zeros((b, _THREADS * per), dtype=torch.float64)
        chunk[:, :n] = w[:, lo:lo + n]
        run = torch.cumsum(chunk.view(b, _THREADS, per), -1)
        incl = run[..., -1].view(b, _THREADS // 32, 32)
        for o in (1, 2, 4, 8, 16):
            shifted = torch.cat([torch.zeros_like(incl[..., :o]), incl[..., :-o]], -1)
            incl = torch.where(lane >= o, incl + shifted, incl)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
        dred = incl[..., 31]
        for wp in range(_THREADS // 32 - 1):
            excl[:, wp + 1:, :] += dred[:, wp, None, None]
        cdf = (run + excl.reshape(b, _THREADS, 1)).reshape(b, -1)[:, :n]
        locals_.append(cdf)
        totals.append(cdf[:, -1])
    offs, ends, acc = [], [], torch.zeros(b, dtype=torch.float64)
    for r in range(cluster):
        offs.append(acc)
        acc = acc + totals[r]
        ends.append(acc)
    t = pos.double() * acc[:, None]
    if not spread:
        whole = torch.cat([c_ + o_[:, None] for c_, o_ in zip(locals_, offs)], -1)
        count = torch.searchsorted(whole, t.contiguous(), right=True)
    else:
        q = (torch.stack(ends, -1)[:, None, :] <= t[..., None]).sum(-1)  # [B, K]
        count = torch.full_like(q, k)
        for r in range(cluster):
            off = offs[r - 1] if (mutate == "offset" and r > 0) else offs[r]
            vals = locals_[r] + off[:, None]
            inside = torch.searchsorted(vals, t.contiguous(), right=True) + r * s
            count = torch.where(q == r, inside, count)
    return torch.clamp(count, max=k - 1).to(torch.int32)


_EMU_CASES = [(300, 1, False), (1000, 1, False), (1000, 2, False), (1001, 2, False),
              (4097, 4, False), (19456, 4, False), (20000, 8, False), (20000, 8, True),
              (32768, 8, True), (32768, 4, True), (32767, 8, True)]


@pytest.mark.parametrize("k,cluster,spread", _EMU_CASES)
def test_k7_any_k_emulation_gives_the_count_form(k, cluster, spread):
    """Slices of ceil(K/C) with masked tails, and the spread search, give
    count_form_indices' ancestors on every row, systematic and sorted
    multinomial positions; the whole and the spread search agree index for
    index."""
    lw = torch.from_numpy(_weight_rows(k, seed=k + cluster))
    for pos in (torch.from_numpy(_systematic(k, seed=cluster)),
                torch.sort(torch.rand((8, k), generator=torch.Generator().manual_seed(k)), -1)
                .values):
        want = fused_step.count_form_indices(lw, pos)
        got = _k7_emulate_any(lw, pos, cluster, spread)
        assert torch.equal(got, want)
        assert torch.equal(got, _k7_emulate_any(lw, pos, cluster, not spread))


def test_k7_spread_emulation_catches_an_offset_from_the_wrong_slice():
    k = 32768
    lw = torch.from_numpy(_weight_rows(k, seed=3))
    pos = torch.from_numpy(_systematic(k, seed=4))
    bad = _k7_emulate_any(lw, pos, 8, True, mutate="offset")
    assert int((bad != fused_step.count_form_indices(lw, pos)).sum()) > 0


# ---- above the cap ----


def test_resample_above_the_cap_on_cpu_and_the_training_hole():
    """Above K7's cap CPU tensors take the plain versions as at every K (the
    count form, K8's gather; K11's scatter in the backward); `smc.
    backward_hole` says where a CUDA train step would need K11 above its cap
    (K > 32768 with K % 128 == 0, resampling and a gradient), which
    `forward_filter` then refuses up front. At K = 32768 + 64 (K % 128 = 64)
    the reference runs a plain scatter-add, and so does the port's backward
    on the card: no hole there; at 32768 + 128 there is."""
    k = rg.MAX_K + 64
    lw = torch.from_numpy(_weight_rows(k, seed=5))[:2]
    pos = torch.from_numpy(_systematic(k, seed=6))[:2]
    x = torch.randn((2, 3, k), generator=torch.Generator().manual_seed(7))
    idx, x_res = rg.resample_and_gather(pos, lw, x)
    assert torch.equal(idx, fused_step.count_form_indices(lw, pos))
    assert torch.equal(x_res, resampling.gather_particles(x, idx))
    g = torch.randn_like(x)
    assert torch.equal(rg.segment_sum_scatter(g, idx), rg.segment_sum_scatter_reference(g, idx))
    cfg = tconfig.PRESETS["fhn_fivo_k128"]
    ssm = SSM(cfg)
    for n, resampling_, grad, want in ((k, "systematic", True, False),
                                       (k + 64, "systematic", True, True),
                                       (rg.MAX_K, "systematic", True, False),
                                       (k, "none", True, False), (k, "systematic", False, False)):
        sc = dataclasses.replace(cfg.smc, n_particles=n, resampling=resampling_)
        with torch.set_grad_enabled(grad):
            assert smc.backward_hole(ssm, sc) is want, (n, resampling_, grad)


def _rg_bwd_branch(batch: int, k: int) -> str:
    """The branch of the reference's resample backward (`pallas_resample.
    _rg_bwd`, pallas_resample.py:882-895) at (batch, K), its kernels on."""
    if pallas_resample._usable(batch, k):
        return "fused scatter kernel"
    if pallas_resample._win_usable(batch, k):
        return "windowed scatter kernel"
    if k % pallas_resample.Q == 0:
        return "sorted segment sum kernels"
    return "scatter-add"


@pytest.mark.parametrize("k", [rg.MAX_K + 64, rg.MAX_K + 128, 33000, 36864])
def test_backward_hole_follows_the_references_scatter_branches(monkeypatch, k):
    """Above K11's cap the port's resample backward follows `_rg_bwd`'s
    branches: where the reference runs its plain scatter-add (K % 128 != 0)
    the port's `GatherParticles` runs `scatter_add_` on the card
    (`rg.eager_scatter`) and a train step is no hole (K = 32832 trains);
    where it runs its sorted segment sum's kernels (K % 128 == 0) the port
    has none, and the step is refused before any launch (K = 32896 raises)."""
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)  # the reference's kernels on
    branch = _rg_bwd_branch(8, k)
    assert branch in ("scatter-add", "sorted segment sum kernels")
    cfg = tconfig.PRESETS["fhn_fivo_k128"]
    ssm = SSM(cfg)
    sc = dataclasses.replace(cfg.smc, n_particles=k)
    assert rg.eager_scatter(k) == (branch == "scatter-add")
    with torch.enable_grad():
        assert smc.backward_hole(ssm, sc) == (branch != "scatter-add")
        if branch == "scatter-add":
            smc._refuse_backward_hole(ssm, sc)
        else:
            with pytest.raises(NotImplementedError, match="K11"):
                smc._refuse_backward_hole(ssm, sc)
    with torch.no_grad():  # serving takes every K
        assert not smc.backward_hole(ssm, sc)


# ---- the FHN filter at K = 1000 against the reference's scan ----


def test_fhn_filter_at_k1000_matches_the_reference():
    """fhn_fivo_k128 at K = 1000, which the reference runs through its plain
    scan (K % 128 != 0: `_indices_jnp`) and the port's CUDA path resamples
    through K7: the port's loss and every gradient leaf, resampling through
    K7's and K8's plain versions (the card's count form), against
    jax.value_and_grad of the reference's objective on the same noise; the
    port routes it to its plain loop."""
    b, t, k = 4, 8, 1000
    jcfg = jconfig.PRESETS["fhn_fivo_k128"]
    nets = tuple((n, dataclasses.replace(v, hidden=(16,))) for n, v in jcfg.nets)
    jcfg = dataclasses.replace(jcfg, nets=nets, use_pallas=False,
                               data=dataclasses.replace(jcfg.data, t_steps=t),
                               smc=dataclasses.replace(jcfg.smc, n_particles=k, kernel_rng=False))
    tcfg = tconfig.from_dict(jcfg.to_dict())
    jssm, params, tssm = models(jcfg, tcfg)
    assert smc.reference_path(tssm, tcfg.smc) == "scan"
    assert smc.filter_route(tssm, tcfg.smc, t, cuda=True) == "plain"
    ys = observations(b, t, seed=2)
    key = jax.random.key(9)
    noise = to_torch(key_noise(jax.random.split(key)[0], b, t, 2, k, jcfg.smc.resampling))
    want_loss, want = jax.value_and_grad(
        lambda p: j_make_objective(jssm, jcfg)(p, key, ys, None, None).loss)(params)
    calls = rg.ancestor_indices_large_reference.calls
    real = resampling.maybe_resample
    resampling.maybe_resample = lambda *a, **kw: real(*a, **dict(kw, use_kernel=True))
    try:
        got = t_make_objective(tssm, tcfg)(None, torch.from_numpy(ys), noise=noise)
    finally:
        resampling.maybe_resample = real
    got.loss.backward()
    assert rg.ancestor_indices_large_reference.calls - calls == t - 1
    assert_close(got.loss.detach(), want_loss, 2e-4)
    assert_grads_close(bridge.grads_to_numpy(tssm), want, 5e-3, 5e-4)
