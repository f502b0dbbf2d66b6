"""The port's command line (`psvo_tpu_torch.cli`) against the reference's
(`psvo_tpu.cli`), on the CPU (`--device cpu`, the kernels' plain versions)
at a small size: the presets listing, --set overrides and their config
hash, the dataset npz in both directions, the files a train run writes
(params.json as the reference writes it), resume, PSVO eval with both
bounds, plots without matplotlib, the refusal without a card, and an
import without JAX.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from psvo_tpu import cli as jcli
from psvo_tpu.config import preset as jpreset
from psvo_tpu_torch import cli as tcli
from psvo_tpu_torch.config import preset as tpreset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["data.n_train=8", "data.n_test=3", "data.t_steps=8", "smc.n_particles=32",
         "train.batch_size=4", "train.mse_k_steps=3", "train.steps_per_call=2",
         "train.eval_every=2", "train.save_every=2"]


def _sets(sets):
    return [a for s in sets for a in ("--set", s)]


def _train(root, *extra, preset="fhn_fivo_k128", steps=4, sets=SMALL):
    """Run `train --device cpu` in-process; (rc, stdout, the results dir)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(["train", "--preset", preset, "--device", "cpu", "--steps", str(steps),
                        "--results-root", str(root), *_sets(sets), *extra])
    text = out.getvalue()
    path = next(line.split(": ", 1)[1] for line in text.splitlines()
                if line.startswith("results: "))
    return rc, text, path


@pytest.fixture(scope="module")
def fhn_run(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("runs"))


def test_presets_print_what_the_reference_prints(capsys):
    assert jcli.main(["presets"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["presets"]) == 0
    assert capsys.readouterr().out == want
    assert "fhn_fivo_k1024_bench" in want


@pytest.mark.parametrize("sets", [[], SMALL, ["smc.kernel_rng=false", "train.lr=0.01",
                                              "data.dyn_overrides=[[\"a\", 0.8]]"]])
@pytest.mark.parametrize("name", ["fhn_fivo_k128", "lorenz63_psvo_k1024"])
def test_apply_overrides_gives_the_reference_hash(name, sets):
    want = jcli.apply_overrides(jpreset(name), sets)
    got = tcli.apply_overrides(tpreset(name), sets)
    assert json.loads(json.dumps(got.to_dict())) == json.loads(json.dumps(want.to_dict()))
    assert (got.config_hash(), got.resume_hash()) == (want.config_hash(), want.resume_hash())


@pytest.mark.parametrize("item,match", [("smc.no_such_key=1", "unknown config key"),
                                        ("smc.n_particles", "expects key=value")])
def test_bad_override_exits(item, match):
    with pytest.raises(SystemExit, match=match):
        tcli.apply_overrides(tpreset("fhn_fivo_k128"), [item])


def test_reference_npz_trains_through_data_npz(tmp_path, capsys):
    """A dataset the reference's `data` wrote trains through the port's
    --data-npz (its trajectories, not the port's own simulation)."""
    path = str(tmp_path / "ref.npz")
    assert jcli.main(["data", "--preset", "fhn_fivo_k128", *_sets(SMALL), "--out", path]) == 0
    capsys.readouterr()
    rc, text, _ = _train(tmp_path / "runs", "--data-npz", path)
    assert rc == 0 and "step      4" in text
    with np.load(path) as z:
        from psvo_tpu_torch.data import load_dataset

        assert np.array_equal(load_dataset(path).obs_train.numpy(), z["obs_train"])


def test_port_npz_loads_in_the_reference(tmp_path, capsys):
    from psvo_tpu.data import load_dataset as j_load_dataset
    from psvo_tpu_torch.data import generate_dataset

    path = str(tmp_path / "port.npz")
    assert tcli.main(["data", "--preset", "lorenz63_psvo_k1024", *_sets(SMALL),
                      "--out", path]) == 0
    assert "saved lorenz63 dataset (8+3 trajectories, T=8)" in capsys.readouterr().out
    ds = j_load_dataset(path)
    cfg = tcli.apply_overrides(tpreset("lorenz63_psvo_k1024"), SMALL)
    want = generate_dataset(cfg.data, cfg.seed)
    for field in ("obs_train", "obs_test", "hidden_train", "hidden_test", "emission_matrix"):
        np.testing.assert_array_equal(np.asarray(getattr(ds, field)),
                                      getattr(want, field).numpy(), err_msg=field)


def test_train_writes_params_json_as_the_reference(fhn_run, tmp_path):
    """params.json: the config of the run (n_steps from --steps) and its hash,
    the same content the reference's ResultsDir writes for that config."""
    from psvo_tpu.utils.results import ResultsDir as JResultsDir

    rc, _, path = fhn_run
    assert rc == 0
    jcfg = jcli.apply_overrides(jpreset("fhn_fivo_k128"), SMALL)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, n_steps=4))
    want = JResultsDir(tmp_path, jcfg).path / "params.json"
    got = json.loads(open(os.path.join(path, "params.json")).read())
    assert got == json.loads(want.read_text())
    assert got["config_hash"] == jcfg.config_hash()


def test_train_writes_metrics_history_checkpoints_and_plots(fhn_run):
    rc, text, path = fhn_run
    history = json.loads(open(os.path.join(path, "history.json")).read())
    assert [r["step"] for r in history] == [2, 4]
    assert all(math.isfinite(r["test_elbo"]) and len(r["r2_k"]) == 3 for r in history)
    lines = [json.loads(s) for s in open(os.path.join(path, "metrics.jsonl"))]
    assert [ln["step"] for ln in lines] == [2, 4] and all("time" in ln for ln in lines)
    assert sorted(os.listdir(os.path.join(path, "checkpoints"))) == ["2.pt", "4.pt"]
    for name in ("elbo.png", "r2.png", "phase_portrait.png"):
        assert os.path.getsize(os.path.join(path, name)) > 0, name
    assert "plots: " in text and "phase_portrait.png" in text


def test_resume_continues_from_the_checkpoint(fhn_run, tmp_path):
    """--resume restores the newest checkpoint, says so, and the history
    continues after it."""
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(fhn_run[2], "checkpoints"), ckpt)
    rc, text, path = _train(tmp_path / "runs", "--resume", str(ckpt), steps=6)
    assert rc == 0 and "resumed from step 4" in text
    history = json.loads(open(os.path.join(path, "history.json")).read())
    assert [r["step"] for r in history] == [6]
    assert "6.pt" in os.listdir(ckpt)


def test_cli_eval_prints_both_psvo_bounds(tmp_path, capsys):
    """`eval` of a PSVO checkpoint prints the forward `elbo` and the direct
    `elbo_psvo_direct` in its JSON and the bounds line on stderr, from the
    checkpoint's parameters."""
    sets = SMALL + ["smc.n_smoothing_particles=4", "use_pallas=false"]
    rc, _, path = _train(tmp_path / "runs", preset="lorenz63_psvo_k1024", steps=2, sets=sets)
    assert rc == 0
    capsys.readouterr()
    ckpt = os.path.join(path, "checkpoints")
    assert tcli.main(["eval", "--preset", "lorenz63_psvo_k1024", "--device", "cpu",
                      *_sets(sets), "--checkpoint", ckpt]) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out)
    assert np.isfinite(out["elbo"]) and np.isfinite(out["elbo_psvo_direct"])
    assert "PSVO bounds" in cap.err
    # without the checkpoint the fresh weights give another bound
    assert tcli.main(["eval", "--preset", "lorenz63_psvo_k1024", "--device", "cpu",
                      *_sets(sets)]) == 0
    assert json.loads(capsys.readouterr().out)["elbo"] != out["elbo"]


def test_train_without_matplotlib_still_succeeds(tmp_path, monkeypatch):
    """Plots are not on the device path: without matplotlib the run writes
    none, prints the note and exits 0."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    rc, text, path = _train(tmp_path / "runs", steps=2)
    assert rc == 0
    assert "plots: none written, matplotlib is not importable" in text
    assert not [n for n in os.listdir(path) if n.endswith(".png")]
    assert os.path.exists(os.path.join(path, "history.json"))


@pytest.mark.parametrize("cmd", ["train", "eval"])
def test_no_card_without_device_cpu_is_an_error(cmd, monkeypatch, tmp_path):
    """The default device is the card: without one the command stops with an
    error naming it, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd, "--preset", "fhn_fivo_k128", *_sets(SMALL)]
    if cmd == "train":
        argv += ["--steps", "2", "--results-root", str(tmp_path)]
    with pytest.raises(SystemExit, match="no CUDA card is visible"):
        tcli.main(argv)
    assert not os.listdir(tmp_path)


def test_mesh_preset_runs_unsharded_on_one_device(capsys):
    cfg = tpreset("lorenz96_fivo_k8192_sharded")
    tcli._mesh_gate(cfg, torch.device("cpu"))
    assert "mesh 1x8 requested but only 1 device(s) present — running unsharded" in (
        capsys.readouterr().out)


def test_cli_imports_without_jax():
    """The CLI and everything it imports load with jax and psvo_tpu blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['psvo_tpu'] = None\n"
            "import psvo_tpu_torch.cli as c, psvo_tpu_torch.utils.checkpoint, "
            "psvo_tpu_torch.utils.results, psvo_tpu_torch.utils.plots, "
            "psvo_tpu_torch.utils.metrics\n"
            "assert 'matplotlib' not in sys.modules\n"
            "sys.exit(c.main(['presets']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "fhn_fivo_k128" in res.stdout
