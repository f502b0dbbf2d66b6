"""Sharded training, evaluation and checkpoints of the port.

One group of 8 gloo ranks (`tests/_torch_ranks.py`) on `tests/test_sharding.py`'s
configuration (Lorenz-96 at Dx = Dy = 8, K = 32, B = 4, T = 6):

- 12 sharded FIVO steps at mesh 2 × 4 learn (the mean loss of the last
  three below the first three's), with the replicas' parameters bit-equal
  after every step (`test_sharded_training_converges`);
- three steps at mesh 2 × 4 (FIVO) and 8 × 1 (PSVO, each rank K5/K6's
  class) on given global draws against the unsharded port's steps on the
  same draws: losses within 2e-4, the summed gradients within rtol 5e-3 /
  atol 5e-4 (`test_sharded_train_step_runs`);
- the sharded eval step against the reference's
  (`test_eval_step_sharded`): ELBO, R² and MSE within 2e-4;
- a checkpoint written under the mesh restores bit-equal into one
  process and into a new mesh run, which steps on
  (`test_sharded_checkpoint_roundtrip`);
- the mesh's checks (`make_mesh`, `maybe_mesh`);
- the sharded train and eval steps activate their mesh only while a call
  runs (`test_sharded_steps_enter_the_mesh_per_call`).
"""

import concurrent.futures
import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from psvo_tpu import config as jconfig
from psvo_tpu.parallel import context as jcontext
from psvo_tpu.parallel import sharding as jsharding
from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.data import generate_dataset
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.parallel import launch, sharding
from psvo_tpu_torch.train import make_optimizer, make_train_step
from psvo_tpu_torch.utils.checkpoint import Checkpointer
from tests._torch_port import (
    assert_close, key_noise, models, observations, psvo_noise, to_torch, without_compile_cache,
)

torch.set_num_threads(1)

_TOL = 2e-4
_RTOL, _ATOL = 5e-3, 5e-4
_HERE = os.path.dirname(os.path.abspath(__file__))

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _cfg(objective="fivo", d_data=2, d_part=4, batch=4):
    return jconfig.Config(
        name="shard_test",
        data=jconfig.DataConfig(datatype="lorenz96", dx=8, dy=8, t_steps=6, n_train=16,
                                n_test=2),
        smc=jconfig.SMCConfig(objective=objective, n_particles=32, resampling="systematic",
                              n_smoothing_particles=4),
        train=jconfig.TrainConfig(batch_size=batch),
        mesh=jconfig.MeshConfig(data=d_data, particle=d_part),
        use_pallas=False,
    )


STEPS = {"fivo 2x4": _cfg(), "psvo 8x1": _cfg("psvo", d_data=8, d_part=1, batch=8)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, inputs = [], {}
    jcfg = _cfg()
    tcfg = tconfig.from_dict(jcfg.to_dict())
    jssm, params, tssm = models(jcfg, tcfg)
    state = tssm.state_dict()
    # 12 steps on minibatches of the dataset (test_sharded_training_converges)
    ds = generate_dataset(tcfg.data, tcfg.seed)
    batch = ds.obs_train[: tcfg.train.batch_size]
    jobs.append({"name": "converge", "kind": "train", "cfg": tcfg.to_dict(), "state": state,
                 "batches": [batch] * 12, "seed": 2})
    # three steps on given draws, beside the unsharded port
    for i, (name, cfg) in enumerate(STEPS.items()):
        c = tconfig.from_dict(cfg.to_dict())
        b, t = c.train.batch_size, c.data.t_steps
        batches = [torch.from_numpy(observations(b, t, dy=8, seed=70 + 3 * i + j))
                   for j in range(3)]
        keys = [jax.random.key(80 + 3 * i + j) for j in range(3)]
        noises = [psvo_noise(k, b, t, 8, 32, 4) if c.smc.objective == "psvo"
                  else to_torch(key_noise(k, b, t, 8, 32)) for k in keys]
        inputs[name] = (c, batches, noises)
        jobs.append({"name": name, "kind": "train", "cfg": c.to_dict(), "state": state,
                     "batches": batches, "noises": noises})
    # the eval step (test_eval_step_sharded)
    ys = observations(4, 6, dy=8, seed=90)
    key = jax.random.key(91)
    jobs.append({"name": "eval", "kind": "eval", "cfg": tcfg.to_dict(), "state": state,
                 "ys": torch.from_numpy(ys),
                 "noise": to_torch(key_noise(jax.random.split(key)[0], 4, 6, 8, 32))})
    # the checkpoint round trip (test_sharded_checkpoint_roundtrip)
    ckpt_dir = tmp_path_factory.mktemp("ck")
    other = SSM(tcfg)
    jobs.append({"name": "checkpoint", "kind": "checkpoint", "cfg": tcfg.to_dict(),
                 "state": state, "other_state": other.state_dict(), "dir": str(ckpt_dir),
                 "batch": torch.from_numpy(observations(4, 6, dy=8, seed=92))})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.run, 8, "_torch_ranks:run_jobs", {"jobs": jobs},
                            pythonpath=[_HERE], timeout=300)
        mesh = jsharding.make_mesh(jcfg)
        jcontext.set_mesh(mesh)
        try:
            with without_compile_cache():
                ev = jsharding.make_sharded_eval_step(jssm, jcfg, mesh)(params, key, ys)
                ref_eval = {k: np.asarray(v) for k, v in ev.items()}
        finally:
            jcontext.set_mesh(None)
        return ranks.result(), state, inputs, ref_eval, (tcfg, ckpt_dir)


def test_sharded_training_converges(runs):
    results = runs[0]
    losses = results[0]["converge"]["losses"]
    assert all(math.isfinite(v) for v in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("job", ["converge", *STEPS])
def test_replicas_stay_bit_equal(runs, job):
    results = runs[0]
    for step, params in enumerate(results[0][job]["params"]):
        for r in results[1:]:
            assert torch.equal(r[job]["params"][step], params), (job, step)
        assert {r[job]["losses"][step] for r in results} == {results[0][job]["losses"][step]}


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_steps_match_unsharded_steps(runs, name):
    results, state, inputs = runs[0], runs[1], runs[2]
    cfg, batches, noises = inputs[name]
    single = dataclasses.replace(cfg, mesh=tconfig.MeshConfig())
    ssm = SSM(single)
    ssm.load_state_dict(state)
    step = make_train_step(ssm, single, make_optimizer(single))
    got = results[0][name]
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        metrics = step(torch.Generator(), batch, noise=noise)
        assert_close(got["losses"][i], float(metrics["loss"]), _TOL)
        grads = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                           else p.grad.reshape(-1) for p in ssm.parameters()])
        np.testing.assert_allclose(got["grads"][i], grads, rtol=_RTOL, atol=_ATOL)
    assert not torch.equal(got["params"][-1], torch.cat([v.reshape(-1) for v in state.values()]))


@pytest.mark.parametrize("metric", ["elbo", "r2_k", "mse_k", "log_z_fwd", "ess_mean", "ess_min"])
def test_sharded_eval_matches_reference(runs, metric):
    results, ref = runs[0], runs[3]
    got = results[0]["eval"][metric]
    assert_close(got, ref[metric], _TOL)
    for r in results[1:]:
        assert torch.equal(r["eval"][metric], got)


def test_sharded_checkpoint_roundtrip(runs):
    """Rank 0's checkpoint of a mesh run restores bit-equal into one process
    (from another init) and into every rank of a new mesh run, which steps
    on to a finite loss."""
    results, (tcfg, ckpt_dir) = runs[0], runs[4]
    saved = results[0]["checkpoint"]["saved"]
    for r in results:
        assert r["checkpoint"]["step"] == 1
        assert torch.equal(r["checkpoint"]["saved"], saved)
        assert torch.equal(r["checkpoint"]["restored"], saved)
        assert math.isfinite(r["checkpoint"]["loss"])
    single = SSM(tcfg)
    assert Checkpointer(ckpt_dir, tcfg.resume_hash()).restore_params(single) is not None
    assert torch.equal(torch.cat([p.detach().reshape(-1) for p in single.parameters()]), saved)


def test_make_mesh_checks(monkeypatch):
    """The reference's divisibility errors, and a group of another size than
    the mesh, before any subgroup is made."""
    monkeypatch.setenv("WORLD_SIZE", "8")
    cfg = tconfig.from_dict(_cfg().to_dict())
    with pytest.raises(ValueError, match="not divisible by mesh.particle"):
        sharding.make_mesh(dataclasses.replace(
            cfg, smc=dataclasses.replace(cfg.smc, n_particles=30)))
    with pytest.raises(ValueError, match="not divisible by mesh.data"):
        sharding.make_mesh(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, batch_size=3)))
    with pytest.raises(ValueError, match="needs 16 ranks, have 8"):
        sharding.make_mesh(dataclasses.replace(cfg, mesh=tconfig.MeshConfig(data=4, particle=4)))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="needs 8 ranks, the launcher started 4"):
        sharding.maybe_mesh(cfg)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_sharded_steps_enter_the_mesh_per_call(monkeypatch, kind):
    """The sharded train and eval steps activate their mesh for each call
    and leave none set after it or after being built; the train step keeps
    its optimizer state. On a 1 × 1 mesh (no collective to make) the step
    runs the mesh's route and agrees with the unsharded step."""
    from psvo_tpu_torch import train as ttrain
    from psvo_tpu_torch.parallel import context

    cfg = tconfig.from_dict(_cfg(d_data=1, d_part=1).to_dict())
    mesh = context.Mesh(data=1, particle=1, rank=0, backend="gloo", row_group=None,
                        col_group=None, row_ranks=(0,))
    seen, real = [], ttrain.local_rows
    monkeypatch.setattr(ttrain, "local_rows",
                        lambda m, *t: seen.append(context.get_mesh()) or real(m, *t))
    ys = torch.from_numpy(observations(4, 6, dy=8, seed=93))
    got, want = [], []
    for m, out in ((mesh, got), (None, want)):
        torch.manual_seed(0)
        ssm = SSM(cfg)
        if kind == "train":
            opt = make_optimizer(cfg)
            step = (sharding.make_sharded_train_step(ssm, cfg, opt, m) if m is not None
                    else make_train_step(ssm, cfg, opt))
            if m is not None:
                assert step.opt_state is not None and callable(step.single_step)
        else:
            step = (sharding.make_sharded_eval_step(ssm, cfg, m) if m is not None
                    else ttrain.make_eval_step(ssm, cfg))
        assert context.get_mesh() is None
        metrics = step(torch.Generator().manual_seed(3), ys)
        assert context.get_mesh() is None
        out.append(float(metrics["loss" if kind == "train" else "elbo"]))
    assert seen and all(s is mesh for s in seen)
    assert math.isfinite(got[0])
    assert_close(got[0], want[0], _TOL)
