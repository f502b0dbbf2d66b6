"""The port's sharded smoothing objectives against `psvo_tpu`'s sharded path.

As `tests/test_torch_sharding_paths.py` (one group of 8 gloo ranks, the
reference's mesh over the 8 virtual CPU devices, the same noise): PSVO
under both bounds and SVO at mesh 2 × 4
(`test_sharded_smoothing_matches_single_device`), segmented PSVO at T = 7,
S = 2 (`test_particle_mesh_segmented_ffbsi_matches_single_device`), and
PSVO on a data-only mesh 8 × 1 (K5/K6's class per rank,
their plain versions here). The loss, the ELBO, the smoothed paths and the
objective's metrics within 2e-4, every gradient leaf within rtol 5e-3 /
atol 5e-4.

Then the inference API under a 2 × 1 data mesh (a group of 2 gloo ranks):
`filter_posterior` and `smooth_posterior` take the global batch and the
global draws, as the reference's callers pass them, and return the global
arrays, equal to the unsharded call's within 1e-6.
"""

import concurrent.futures
import os

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.infer import filter_posterior, smooth_posterior
from psvo_tpu_torch.parallel import launch
from tests._torch_port import (
    assert_close, assert_grads_close, grads_tree, models, observations, psvo_noise,
    segmented_psvo_noise, sharded_reference, svo_noise,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
_HERE = os.path.dirname(os.path.abspath(__file__))
M = 4

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _cfg(objective, d_data=2, d_part=4, batch=4, t=6, **smc):
    """tests/test_sharding.py's `_smooth_cfg` (Lorenz-96 at Dx = Dy = 8,
    K = 32, M = 4)."""
    return jconfig.Config(
        name="shard_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=8, dy=8, t_steps=t, n_train=4,
                                n_test=2),
        smc=jconfig.SMCConfig(objective=objective, n_particles=32, resampling="systematic",
                              n_smoothing_particles=M, **smc),
        train=jconfig.TrainConfig(batch_size=batch),
        mesh=jconfig.MeshConfig(data=d_data, particle=d_part),
        use_pallas=False,
    )


CASES = {
    "psvo 2x4": _cfg("psvo"),
    "psvo direct 2x4": _cfg("psvo", psvo_bound="direct"),
    "svo 2x4": _cfg("svo"),
    "psvo segmented 2x4": _cfg("psvo", t=7, ffbsi_segments=2),
    "psvo data-only 8x1": _cfg("psvo", d_data=8, d_part=1, batch=8),
}
_METRICS = {"psvo": ("log_joint_smoothed", "elbo_psvo_direct", "log_z_fwd"),
            "svo": ("elbo_svo", "log_z_fwd")}


def _noise(jcfg, key):
    b, t, dx, k = (jcfg.train.batch_size, jcfg.data.t_steps, jcfg.data.dx,
                   jcfg.smc.n_particles)
    if jcfg.smc.objective == "svo":
        return svo_noise(key, b, t, dx, k, M)
    if jcfg.smc.ffbsi_segments > 1:
        return segmented_psvo_noise(key, b, t, dx, k, M, jcfg.smc.ffbsi_segments)
    return psvo_noise(key, b, t, dx, k, M)


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, {case: (port config, the reference's (loss,
    output, gradients))}), the port's from one group of 8 ranks, which runs
    while this process computes the reference's."""
    jobs, inputs = [], {}
    for i, (name, jcfg) in enumerate(CASES.items()):
        tcfg = tconfig.from_dict(jcfg.to_dict())
        jssm, params, tssm = models(jcfg, tcfg)
        b, t = jcfg.train.batch_size, jcfg.data.t_steps
        ys = observations(b, t, dy=8, seed=40 + i)
        key = jax.random.key(60 + i)
        inputs[name] = (tcfg, jssm, params, key, ys)
        jobs.append({"name": name, "kind": "objective_grad", "cfg": tcfg.to_dict(),
                     "state": tssm.state_dict(), "ys": torch.from_numpy(ys),
                     "noise": _noise(jcfg, key)})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.run, 8, "_torch_ranks:run_jobs", {"jobs": jobs},
                            pythonpath=[_HERE], timeout=300)
        refs = {name: (tcfg, sharded_reference(jssm, CASES[name], params, key, ys))
                for name, (tcfg, jssm, params, key, ys) in inputs.items()}
        return ranks.result(), refs


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_smoothing_value_matches_reference(runs, case):
    results, refs = runs
    got = results[0][case]
    _, (want_loss, want, _) = refs[case]
    assert np.isfinite(want_loss)
    assert_close(got["loss"], want_loss, _TOL)
    assert_close(got["elbo"], want.elbo, _TOL)
    for name in _METRICS[CASES[case].smc.objective]:
        assert_close(got["metrics"][name], want.metrics[name], _TOL)
    assert {r[case]["loss"] for r in results} == {got["loss"]}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_smoothed_paths_match_reference(runs, case):
    """The same Gumbels pick the same particles: the global first-argmax
    (PSVO) and the anchors (SVO) reproduce the single-device draws."""
    results, refs = runs
    got = results[0][case]["smoothed"]
    want = refs[case][1][1].smoothed
    assert got.shape == want.shape
    assert_close(got, want, _TOL)
    # replicated over each particle row
    for r in results[1:]:
        assert torch.equal(r[case]["smoothed"], got)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_smoothing_gradients_match_reference(runs, case):
    results, refs = runs
    tcfg, (_, _, want_grads) = refs[case]
    assert_grads_close(grads_tree(tcfg, results[0][case]["grads"]), want_grads, _RTOL, _ATOL)


@pytest.mark.parametrize("case", ["psvo 2x4", "psvo segmented 2x4", "svo 2x4"])
def test_sharded_smoothing_all_gathers_no_k_wide_tensor(runs, case):
    """test_sharded_psvo_hlo_no_full_allgather on the counters: forward and
    backward, the only all-gathers are the island's, one per filter step, of
    [b] row scalars (8 bytes a row); the anchors and the FFBSi steps move
    selected particles and [b, M] scalars through psum, pmax and pmin."""
    jcfg = CASES[case]
    b, steps = jcfg.train.batch_size // jcfg.mesh.data, jcfg.data.t_steps - 1
    got = runs[0][0][case]
    # segmented PSVO runs its forward twice: the segments, then their replays
    calls = (2 if jcfg.smc.ffbsi_segments > 1 else 1) * steps
    gathers = {op: c for counts in (got["forward_counts"], got["backward_counts"])
               for op, c in counts.items() if op.startswith("all_gather")}
    assert gathers == {"all_gather particle": {"calls": calls, "bytes": calls * b * 8}}
    # one global first-argmax (its pmin) for the anchors, and for PSVO one a sweep step
    argmaxes = 1 if jcfg.smc.objective == "svo" else 1 + steps
    assert got["forward_counts"]["pmin particle"]["calls"] == argmaxes


# ---- the inference API under a 2 x 1 data mesh ----------------------------------------

_INFER_OUTPUTS = ("means", "particles", "logws", "paths")


@pytest.fixture(scope="module")
def infer_runs():
    """(each of 2 ranks' outputs of the inference API on a 2 x 1 data mesh,
    the unsharded call's), on the global batch of 4 Lorenz-96 rows and the
    same global draws."""
    import dataclasses

    jcfg = _cfg("psvo", d_data=2, d_part=1, batch=4)
    tcfg = tconfig.from_dict(jcfg.to_dict())
    _, _, tssm = models(jcfg, tcfg)
    b, t = jcfg.train.batch_size, jcfg.data.t_steps
    ys = torch.from_numpy(observations(b, t, dy=8, seed=70))
    noise = psvo_noise(jax.random.key(71), b, t, 8, jcfg.smc.n_particles, M)
    job = {"name": "infer", "kind": "inference", "cfg": tcfg.to_dict(),
           "state": tssm.state_dict(), "ys": ys, "noise": noise[:3], "psvo_noise": noise}
    ranks = launch.run(2, "_torch_ranks:run_jobs", {"jobs": [job]}, pythonpath=[_HERE],
                       timeout=300)
    one = dataclasses.replace(tcfg, mesh=dataclasses.replace(tcfg.mesh, data=1, particle=1))
    means, particles, logws = filter_posterior(tssm, ys, one, return_particles=True,
                                               noise=noise[:3])
    paths = smooth_posterior(tssm, ys, one, noise=noise)
    return [r["infer"] for r in ranks], dict(means=means, particles=particles, logws=logws,
                                              paths=paths)


@pytest.mark.parametrize("output", _INFER_OUTPUTS)
def test_inference_api_returns_global_arrays_on_a_data_mesh(infer_runs, output):
    """Every rank returns the global array (B = 4 rows, not its 2), equal to
    the unsharded call's on the same draws within 1e-6."""
    ranks, want = infer_runs
    w = want[output]
    assert w.shape[0] == 4
    for got in ranks:
        assert got[output].shape == w.shape
        torch.testing.assert_close(got[output], w, rtol=1e-6, atol=1e-6)
