"""The port's command line under a mesh, and the sharded dry run.

`python -m psvo_tpu_torch.cli train` started as one process per mesh
position (RANK, WORLD_SIZE and LOCAL_RANK in the environment, as
`torch.distributed.run` sets them, and a `file://` rendezvous) trains
sharded on gloo and evaluates, and rank 0 alone writes the results
(`test_cli_sharded_end_to_end`); until the sharded path was ported, a mesh
with enough ranks stopped with NotImplementedError there. Started as one
process, a mesh preset runs unsharded (`tests/test_torch_cli.py`).
`sharding.dryrun(8, "cpu")` runs the reference's dry run
(`dryrun_multichip`) on 8 spawned ranks.
"""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from psvo_tpu_torch.parallel import sharding

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (preset, (mesh.data, mesh.particle), --set overrides)
RUNS = {
    "lorenz96 fivo 1x8": ("lorenz96_fivo_k8192_sharded", (1, 8), [
        "smc.n_particles=64", "data.dx=8", "data.dy=8", "data.t_steps=6", "data.n_train=8",
        "data.n_test=4", "train.batch_size=4", "train.eval_every=3", "train.save_every=3"]),
    "lorenz63 psvo 2x2": ("lorenz63_psvo_k1024", (2, 2), [
        "mesh.data=2", "mesh.particle=2", "smc.n_particles=32", "smc.n_smoothing_particles=4",
        "data.t_steps=8", "data.n_train=8", "data.n_test=4", "train.batch_size=4",
        "train.steps_per_call=1", "train.eval_every=2", "train.save_every=2"]),
}


def _spawn_cli(n_ranks, argv, tmp_path, timeout=240.0):
    """Run the CLI on n_ranks processes; every rank's (return code, output)."""
    env = dict(os.environ, WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    argv = [*argv, "--device", "cpu", "--dist-init", f"file://{tmp_path / 'rendezvous'}"]
    procs = [subprocess.Popen([sys.executable, "-m", "psvo_tpu_torch.cli", *argv], cwd=ROOT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_sharded_end_to_end(run, tmp_path):
    preset, (d, p), sets = RUNS[run]
    n_ranks = d * p
    argv = ["train", "--preset", preset, "--steps", "6",
            *[a for s in sets for a in ("--set", s)], "--results-root", str(tmp_path / "res")]
    ranks = _spawn_cli(n_ranks, argv, tmp_path)
    for rank, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {rank}:\n{out[-3000:]}"
    out0 = ranks[0][1]
    assert f"mesh: data={d} x particle={p} ({n_ranks} ranks, gloo)" in out0
    assert "test_elbo" in out0 and "step      6" in out0
    for _, out in ranks[1:]:
        assert "results:" not in out and "test_elbo" not in out  # rank 0 alone writes
    runs = list((tmp_path / "res").iterdir())
    assert len(runs) == 1
    history = json.loads((runs[0] / "history.json").read_text())
    assert [h["step"] for h in history][-1] == 6
    assert all(math.isfinite(h["test_elbo"]) for h in history)
    assert (runs[0] / "checkpoints" / "6.pt").exists()


def test_dryrun_8_ranks(capsys):
    """The reference's `dryrun_multichip(8)`: mesh 2 × 4, one sharded FIVO,
    PSVO and segmented PSVO train step, finite losses, the same on every rank."""
    summary = sharding.dryrun(8, "cpu")
    assert [label for label, _, _ in summary] == ["fivo", "psvo", "psvo-seg2"]
    assert all(k == 64 for _, k, _ in summary)
    assert "dryrun ok: mesh data=2 particle=4" in capsys.readouterr().out
