"""The port's sharded filter paths against `psvo_tpu`'s sharded path.

One group of 8 gloo ranks (`tests/_torch_ranks.py`) runs every case; the
reference runs its mesh over the 8 virtual CPU devices of
`tests/conftest.py`, on the same noise (derived from the reference's key,
handed to the port as the global draws, of which each rank takes its
share). Values within 2e-4, every gradient leaf within rtol 5e-3 /
atol 5e-4 (the port's gradient rule: each rank's loss over P·D, one world
all-reduce). The cases are `tests/test_sharding.py`'s filter checks
(`_cfg`: Lorenz-96 at Dx = Dy = 8, K = 32, B = 4, T = 6, mesh 2 × 4):
FIVO, with controls, IWAE, ESS-adaptive resampling, the full FIVO gradient
through the ring, and a data-only mesh 8 × 1 (each rank the unsharded
route on its rows).
"""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.parallel import context as jcontext
from psvo_tpu.parallel import sharding as jsharding
from psvo_tpu.smc import forward_filter as j_forward_filter
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.parallel import launch
from tests._torch_port import (
    assert_close, assert_grads_close, grads_tree, key_noise, models, observations,
    sharded_reference, to_torch, without_compile_cache,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
_HERE = os.path.dirname(os.path.abspath(__file__))

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _cfg(objective="fivo", d_data=2, d_part=4, batch=4, di=0, **smc):
    """tests/test_sharding.py's `_cfg` (use_pallas off: the reference's
    kernels have no CPU route outside interpret mode)."""
    return jconfig.Config(
        name="shard_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=8, dy=8, t_steps=6, n_train=4,
                                n_test=2, di=di),
        smc=jconfig.SMCConfig(objective=objective, n_particles=32, resampling=smc.pop(
            "resampling", "systematic"), **smc),
        train=jconfig.TrainConfig(batch_size=batch),
        mesh=jconfig.MeshConfig(data=d_data, particle=d_part),
        use_pallas=False,
    )


# name -> the reference's config (di > 0: with controls)
CASES = {
    "fivo 2x4": _cfg(),
    "fivo controls 2x4": _cfg(di=2),
    "iwae 2x4": _cfg("iwae"),
    "fivo ess 0.5 2x4": _cfg(ess_threshold=0.5),
    "fivo full gradient 2x4": _cfg(resampling="multinomial", use_stop_gradient=False),
    "fivo data-only 8x1": _cfg(d_data=8, d_part=1, batch=8),
}


def _inputs(jcfg, seed):
    b, t, d = jcfg.train.batch_size, jcfg.data.t_steps, jcfg.data.dy
    ys = observations(b, t, dy=d, seed=seed)
    u = (np.random.default_rng(seed + 1).standard_normal((b, t, jcfg.data.di)).astype(np.float32)
         if jcfg.data.di else None)
    return ys, u


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, {case: (port config, the reference's (loss,
    output, gradients))}, the reference's sharded filter), the port's from
    one group of 8 ranks, which runs while this process computes the
    reference's."""
    jobs, inputs = [], {}
    for i, (name, jcfg) in enumerate(CASES.items()):
        tcfg = tconfig.from_dict(jcfg.to_dict())
        jssm, params, tssm = models(jcfg, tcfg)
        ys, u = _inputs(jcfg, 10 + i)
        key = jax.random.key(20 + i)
        method = jcfg.smc.resampling if jcfg.smc.objective != "iwae" else "none"
        noise = to_torch(key_noise(jax.random.split(key)[0], jcfg.train.batch_size,
                                   jcfg.data.t_steps, jcfg.data.dx, jcfg.smc.n_particles,
                                   method))
        inputs[name] = (tcfg, jssm, params, key, ys, u)
        jobs.append({"name": name, "kind": "objective_grad", "cfg": tcfg.to_dict(),
                     "state": tssm.state_dict(), "ys": torch.from_numpy(ys), "noise": noise,
                     "controls": None if u is None else torch.from_numpy(u)})
    # the filter alone (test_sharding.py's test_sharded_filter_matches_single_device)
    jcfg = _cfg()
    tcfg = tconfig.from_dict(jcfg.to_dict())
    jssm, params, tssm = models(jcfg, tcfg)
    ys, _ = _inputs(jcfg, 30)
    key = jax.random.key(31)
    jobs.append({"name": "filter", "kind": "filter", "cfg": tcfg.to_dict(),
                 "state": tssm.state_dict(), "ys": torch.from_numpy(ys),
                 "noise": to_torch(key_noise(key, 4, 6, 8, 32))})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.run, 8, "_torch_ranks:run_jobs", {"jobs": jobs},
                            pythonpath=[_HERE], timeout=300)
        refs = {name: (tcfg_, sharded_reference(jssm_, CASES[name], params_, key_, ys_, u_))
                for name, (tcfg_, jssm_, params_, key_, ys_, u_) in inputs.items()}
        mesh = jsharding.make_mesh(jcfg)
        jcontext.set_mesh(mesh)
        try:
            with without_compile_cache():
                fwd = jax.jit(lambda p, k, y: j_forward_filter(jssm, p, k, y, jcfg.smc,
                                                               cache=True))(
                    params, key, jax.device_put(ys, jsharding.batch_sharding(mesh)))
                ref_filter = jax.tree_util.tree_map(np.asarray, (fwd.log_z, fwd.increments,
                                                                 fwd.filtered_means))
        finally:
            jcontext.set_mesh(None)
        return ranks.result(), refs, ref_filter


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_value_matches_reference(runs, case):
    results, refs, _ = runs
    got = results[0][case]
    _, (want_loss, want, _) = refs[case]
    assert np.isfinite(want_loss)
    assert_close(got["loss"], want_loss, _TOL)
    assert_close(got["elbo"], want.elbo, _TOL)
    assert_close(got["metrics"]["log_z_fwd"], want.metrics["log_z_fwd"], _TOL)
    # the loss is replicated: every rank reports the same
    assert {r[case]["loss"] for r in results} == {got["loss"]}


# The full FIVO gradient's score-function terms are sums of large terms that
# cancel: there the reference's own sharded and single-device gradients
# (the same estimator, another summation order) differ beyond rtol 5e-3 /
# atol 5e-4 on single elements, at about 1e-5 relative L2 per leaf. That
# case is held per leaf by relative L2 instead.
_SCORE_REL_L2 = 1e-4


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_match_reference(runs, case):
    results, refs, _ = runs
    tcfg, (_, _, want_grads) = refs[case]
    grads = results[0][case]["grads"]
    got = grads_tree(tcfg, grads)
    if CASES[case].smc.use_stop_gradient:
        assert_grads_close(got, want_grads, _RTOL, _ATOL)
    else:
        flat_want, _ = jax.tree_util.tree_flatten_with_path(want_grads)
        for (path, want), g in zip(flat_want, jax.tree_util.tree_leaves(got)):
            want = np.asarray(want)
            rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-12)
            assert rel < _SCORE_REL_L2, (jax.tree_util.keystr(path), rel)
    # one world all-reduce: every rank holds the same gradient
    for r in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r[case]["grads"], grads))


@pytest.mark.parametrize("field", ["log_z", "increments", "filtered_means"])
def test_sharded_filter_matches_reference(runs, field):
    results, _, ref = runs
    got = results[0]["filter"][field]
    want = ref[("log_z", "increments", "filtered_means").index(field)]
    assert got.shape == want.shape
    assert_close(got, want, _TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_no_k_wide_all_gather(runs, case):
    """The HLO checks of tests/test_sharding.py, on the collective counters:
    per filter step one all-gather of [b] row scalars (8 bytes each) and
    P − 1 ring shifts in the forward when resampling is on, and nothing
    K-wide all-gathered, forward or backward."""
    got = runs[0][0][case]
    jcfg = CASES[case]
    p, d = jcfg.mesh.particle, jcfg.mesh.data
    b, steps = jcfg.train.batch_size // d, jcfg.data.t_steps - 1
    fwd, bwd = got["forward_counts"], got["backward_counts"]
    gathers = {op: c for op, c in {**fwd, **bwd}.items() if op.startswith("all_gather")}
    resampling = p > 1 and jcfg.smc.objective != "iwae"
    if resampling:
        assert gathers == {"all_gather particle": {"calls": steps, "bytes": steps * b * 8}}
        assert fwd["ring_shift particle"]["calls"] == steps * (p - 1)
    else:
        assert gathers == {}
        assert "ring_shift particle" not in fwd
    assert fwd["staged_bytes"] == bwd["staged_bytes"] == 0  # gloo on CPU tensors
