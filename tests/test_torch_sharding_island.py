"""The port's collectives, resampling island and global first-argmax against
`psvo_tpu`'s sharded ops and single-process results.

One group of 8 gloo ranks (`tests/_torch_ranks.py`, mesh 2 × 4):

- each collective (`parallel.collectives`) against its single-process
  value, the psum's and the ring shift's gradients against their transposes;
- the resampling island (`ops.sharded_resampling`, K7/K8's plain versions)
  against the reference's island with its Pallas kernel in interpret mode
  (`test_sharded_island_with_pallas_kernel`: one step directly, and the
  filter's log Z at K = 512, B = 16), and against the single-rank count
  form on the same global weights and positions;
- K7's clamped positions: indices of the out-of-range slots that are
  nondecreasing (K11's precondition) and in-range slots unchanged;
- `sharded_ffbsi.global_first_argmax`: `torch.argmax`'s first-maximum tie
  rule, bit for bit, across shards.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from psvo_tpu import config as jconfig
from psvo_tpu.ops import pallas_resample
from psvo_tpu.ops import sharded_resampling as j_sharded_resampling
from psvo_tpu.parallel import context as jcontext
from psvo_tpu.parallel import sharding as jsharding
from psvo_tpu.smc import forward_filter as j_forward_filter
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.ops import fused_step, sharded_resampling
from psvo_tpu_torch.parallel import launch
from tests._torch_port import (
    assert_close, key_noise, models, observations, to_torch, without_compile_cache,
)

torch.set_num_threads(1)

_TOL = 2e-4
_HERE = os.path.dirname(os.path.abspath(__file__))
WORLD, D, PART = 8, 2, 4
B, K, DX = 16, 512, 8  # the reference's Pallas resample gate: 8 rows, 128 particles a shard

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _cfg(k=32, batch=4):
    return jconfig.Config(
        name="shard_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=DX, dy=DX, t_steps=6, n_train=4,
                                n_test=2),
        smc=jconfig.SMCConfig(objective="fivo", n_particles=k, resampling="systematic"),
        train=jconfig.TrainConfig(batch_size=batch),
        mesh=jconfig.MeshConfig(data=D, particle=PART),
        use_pallas=False,
    )


def _island_inputs():
    """Global (u, logw, x) of one step: random rows, plus rows with ties, a
    dominant particle and a wide spread."""
    rng = np.random.default_rng(7)
    logw = (3.0 * rng.standard_normal((B, K))).astype(np.float32)
    logw[1] = 0.0  # uniform: every boundary a tie with a position
    logw[2] = np.where(np.arange(K) % 3 == 0, -1.0, -2.0)
    logw[3] = -50.0
    logw[3, 301] = 0.0  # dominant particle, on the third shard
    logw[4] = np.linspace(-100.0, 0.0, K)
    u0 = rng.random(B).astype(np.float32)
    u = ((np.arange(K)[None, :] + u0[:, None]) / K).astype(np.float32)
    x = rng.standard_normal((B, DX, K)).astype(np.float32)
    return u, logw, x


@pytest.fixture(scope="module")
def runs():
    jobs = []
    tcfg = tconfig.from_dict(_cfg().to_dict())
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((WORLD, 6), generator=gen)
    x[:, 0] = 1.0  # a tie across ranks for pmax / pmin
    g = torch.randn((WORLD, 6), generator=gen)
    jobs.append({"name": "collectives", "kind": "collectives", "cfg": tcfg.to_dict(), "x": x,
                 "g": g, "tag": torch.arange(WORLD, dtype=torch.int32)[:, None] * 10})
    z = torch.randn((4, 5, 32), generator=gen)
    z[0, 0, 3] = z[0, 0, 17] = z[0, 0, 30] = 9.0  # ties on three shards: the first wins
    z[1, 2, 9] = z[1, 2, 10] = 9.0  # a tie inside one shard
    z[2, 1, :] = 0.0  # all equal: index 0
    jobs.append({"name": "argmax", "kind": "first_argmax", "cfg": tcfg.to_dict(), "z": z})
    # the island, one step, at the reference's Pallas gate
    icfg = tconfig.from_dict(_cfg(k=K, batch=B).to_dict())
    u, logw, xp = _island_inputs()
    jobs.append({"name": "island", "kind": "island", "cfg": icfg.to_dict(),
                 "u": torch.from_numpy(u), "logw": torch.from_numpy(logw),
                 "x": torch.from_numpy(xp)})
    # the filter at K = 512, B = 16 (test_sharded_island_with_pallas_kernel)
    jcfg = _cfg(k=K, batch=B)
    jssm, params, tssm = models(jcfg, icfg)
    ys = observations(B, 6, dy=DX, seed=8)
    key = jax.random.key(9)
    jobs.append({"name": "filter", "kind": "filter", "cfg": icfg.to_dict(),
                 "state": tssm.state_dict(), "ys": torch.from_numpy(ys),
                 "noise": to_torch(key_noise(key, B, 6, DX, K))})
    results = launch.run(WORLD, "_torch_ranks:run_jobs", {"jobs": jobs}, pythonpath=[_HERE],
                         timeout=300)
    return results, (jcfg, jssm, params, ys, key), (x, g, z, (u, logw, xp))


# -- collectives -------------------------------------------------------------------------


def _row_of(rank):
    return range(rank // PART * PART, rank // PART * PART + PART)


@pytest.mark.parametrize("op", ["psum", "pmax", "pmin", "psum_data", "gather", "shift"])
def test_collective_matches_single_process(runs, op):
    results, _, (x, _, _, _) = runs
    for rank, res in enumerate(r["collectives"] for r in results):
        row = list(_row_of(rank))
        prev = row[(rank % PART - 1) % PART]
        want = {"psum": x[row].sum(0), "pmax": x[row].amax(0), "pmin": x[row].amin(0),
                "psum_data": x[rank % PART::PART].sum(0), "gather": x[row].T,
                "shift": x[prev]}[op]
        if op in ("psum", "psum_data"):
            assert_close(res[op], want, 1e-6)
        else:
            assert torch.equal(res[op], want)
        if op == "shift":  # the second tensor of the message, another dtype
            assert torch.equal(res["shift_other"], torch.tensor([prev * 10], dtype=torch.int32))


@pytest.mark.parametrize("op", ["psum_grad", "shift_grad"])
def test_collective_gradients_are_their_transposes(runs, op):
    """psum's cotangent is the row's summed cotangents; a ring shift's lands
    on the rank that sent the value (p + 1's cotangent on p)."""
    results, _, (_, g, _, _) = runs
    for rank, res in enumerate(r["collectives"] for r in results):
        row = list(_row_of(rank))
        if op == "psum_grad":
            assert_close(res[op], g[row].sum(0), 1e-6)
        else:
            assert torch.equal(res[op], g[row[(rank % PART + 1) % PART]])


# -- the global first-argmax ---------------------------------------------------------------


def test_global_first_argmax_is_torch_argmax(runs):
    results, _, (_, _, z, _) = runs
    got = results[0]["argmax"]
    assert torch.equal(got["gidx"], torch.argmax(z, dim=-1))
    assert torch.equal(got["picked"], torch.amax(z, dim=-1))
    assert torch.equal(got["owners"], torch.ones_like(got["owners"]))  # one owner a row, path


# -- the island ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_island(runs):
    """The reference's island with its fused Pallas kernel in interpret mode
    on the same global step: (x_out, ess, idx)."""
    _, (jcfg, *_), (_, _, _, (u, logw, x)) = runs
    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_resample, "_INTERPRET", True)
    try:
        mesh = jsharding.make_mesh(jcfg)
        spec_w = NamedSharding(mesh, P("data", "particle"))
        spec_x = NamedSharding(mesh, P("data", None, "particle"))
        fn = jax.jit(lambda u_, lw, x_: j_sharded_resampling.sharded_maybe_resample(
            mesh, u_, lw, x_, use_pallas=True))
        with without_compile_cache():
            x_out, _, _, ess, idx = fn(jax.device_put(u, spec_w), jax.device_put(logw, spec_w),
                                       jax.device_put(x, spec_x))
            return np.asarray(x_out), np.asarray(ess), np.asarray(idx)
    finally:
        mp.undo()


def test_island_matches_reference_pallas_island(runs, reference_island):
    got = runs[0][0]["island"]
    x_out, ess, idx = reference_island
    assert np.array_equal(got["idx"].numpy(), idx)
    assert np.array_equal(got["x"].numpy(), x_out)
    assert_close(got["ess"], ess, 1e-4)


def test_island_matches_single_rank_count_form(runs):
    """The island's global ancestors are K7's (the count form on one
    rank's fp64 CDF) on the same global weights and positions, and the
    particles its gather."""
    results, _, (_, _, _, (u, logw, x)) = runs
    got = results[0]["island"]
    want = fused_step.count_form_indices(torch.from_numpy(logw), torch.from_numpy(u))
    assert torch.equal(got["idx"], want)
    gathered = torch.gather(torch.from_numpy(x), 2, want.long()[:, None, :].expand(-1, DX, -1))
    assert torch.equal(got["x"], gathered)
    # every rank of a row holds the same ESS, and the step resampled every row
    assert torch.all(got["did"])


def test_island_filter_matches_reference_with_pallas_kernel(runs, monkeypatch):
    """test_sharded_island_with_pallas_kernel: the reference's sharded filter
    with the fused kernel per shard (interpret mode) against the port's
    sharded filter, log Z within 2e-4."""
    results, (jcfg, jssm, params, ys, key), _ = runs
    monkeypatch.setattr(pallas_resample, "_INTERPRET", True)
    mesh = jsharding.make_mesh(jcfg)
    ssm_pallas = type(jssm)(dataclasses.replace(jcfg, use_pallas=True, use_pallas_resample=True))
    jcontext.set_mesh(mesh)
    try:
        with without_compile_cache():
            want = np.asarray(jax.jit(
                lambda p, k, y: j_forward_filter(ssm_pallas, p, k, y, jcfg.smc).log_z)(
                params, key, jax.device_put(ys, jsharding.batch_sharding(mesh))))
    finally:
        jcontext.set_mesh(None)
    assert_close(results[0]["filter"]["log_z"], np.asarray(want), _TOL)


@pytest.mark.parametrize("where", ["below", "inside", "above"])
def test_clamped_positions_keep_k11_order(where):
    """`_local_lookup` clamps the positions of the slots other shards own
    into K7's [0, 1): the indices stay nondecreasing, the in-range slots
    keep the count form's index and the out-of-range ones land at the ends."""
    gen = torch.Generator().manual_seed(1)
    logw = torch.randn((3, 64), generator=gen)
    s_r = torch.sum(torch.exp(logw - logw.amax(-1, keepdim=True)).double(), -1, keepdim=True)
    shift = {"below": -0.5, "inside": 0.0, "above": 0.5}[where]
    rel = (torch.linspace(0, 1.5, 64, dtype=torch.float64)[None] + shift) * s_r
    idx, got = sharded_resampling._local_lookup(rel, logw, logw[:, None, :], s_r)
    assert torch.all(idx[:, 1:] >= idx[:, :-1])
    frac = rel / s_r
    inside = (frac >= 0) & (frac < 1)
    want = fused_step.count_form_indices(logw, frac.float().clamp(0, 1))
    assert torch.equal(idx[inside], want[inside])
    assert torch.all(idx[frac < 0] == 0)
    assert torch.equal(got[:, 0, :], torch.gather(logw, 1, idx.long()))
