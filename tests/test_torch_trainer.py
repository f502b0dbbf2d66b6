"""The port's Trainer against the reference's (`psvo_tpu.train.Trainer`).

The loop's control flow is held to the reference's with stub train and eval
steps put on both Trainers' instances in the test: both draw the same
minibatch indices step by step (the rows of obs_train are their own
indices), evaluate at the same steps, stop early at the same step, save at
the same steps and end keep_best on the same step's parameters for one
scripted test-ELBO sequence. Then one short real FIVO run on the CPU, the
history keys, the profiler window and `train.debug_checks`.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psvo_tpu import train as jtrain
from psvo_tpu.models.ssm import init_ssm as j_init_ssm
from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.config import from_dict
from psvo_tpu_torch.data import generate_dataset
from psvo_tpu_torch.models.ssm import init_ssm
from tests._torch_port import small_configs

torch.set_num_threads(1)

N_TRAIN, BATCH, T, DY = 10, 4, 3, 2


def _configs(**train_kw):
    jcfg, _ = small_configs(t=T, k=32)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, batch_size=BATCH,
                                                                 **train_kw))
    return jcfg, from_dict(jcfg.to_dict())


def _index_data():
    """obs whose row i holds i everywhere, so a batch names its rows."""
    obs = np.broadcast_to(np.arange(N_TRAIN, dtype=np.float32)[:, None, None],
                          (N_TRAIN, T, DY)).copy()
    test = np.zeros((3, T, DY), np.float32)
    return obs, test


class _Saves:
    """A checkpointer that records what the Trainer asks it to save."""

    def __init__(self):
        self.calls = []

    def save(self, state, force=False):
        self.calls.append((state.step, force))


def _scripted(elbos):
    it = iter(elbos)
    return lambda: next(it, -100.0)


def _reference_trainer(jcfg, elbos, with_extras=False):
    """The reference's Trainer with stubs: its params are {"tag": steps taken}."""
    jssm, params = j_init_ssm(jcfg, jax.random.key(0))
    tr = jtrain.Trainer(jcfg, jssm, params, checkpointer=_Saves())
    tr.state.params = {"tag": np.float32(0)}
    tr.indices = []
    next_elbo = _scripted(elbos)

    def train_step(params, opt_state, key, batch, enc, ctrl):
        b = np.asarray(batch)
        rows = b[..., 0, 0].astype(int).reshape(-1, b.shape[-3])
        tr.indices.extend(r.tolist() for r in rows)
        metrics = {"loss": jnp.float32(2.0), "grad_norm": jnp.float32(0.5),
                   "log_z_fwd": jnp.float32(-2.0)}
        return {"tag": params["tag"] + len(rows)}, opt_state, metrics

    def eval_step(params, key, ys, enc, ctrl):
        ev = {"elbo": jnp.float32(next_elbo()), "r2_k": jnp.asarray([0.5, 0.25, 0.0]),
              "ess_mean": jnp.float32(3.0)}
        if with_extras:
            ev.update(elbo_psvo_direct=jnp.float32(-4.0), log_joint_smoothed=jnp.float32(-5.0))
        return ev

    tr.train_step, tr.eval_step = train_step, eval_step
    return tr


def _port_trainer(tcfg, elbos, with_extras=False):
    """The port's Trainer with stubs: each step adds one to prior_mean[0]."""
    ssm = init_ssm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tr = ttrain.Trainer(tcfg, ssm, checkpointer=_Saves())
    tr.indices = []
    next_elbo = _scripted(elbos)

    def single_step(gen, batch, enc=None, noise=None, ctrl=None):
        tr.indices.append(batch[:, 0, 0].long().tolist())
        with torch.no_grad():
            ssm.prior_mean[0] += 1
        return {"loss": torch.tensor(2.0), "grad_norm": torch.tensor(0.5),
                "log_z_fwd": torch.tensor(-2.0)}

    def train_step(gen, batch, enc=None, noise=None, ctrl=None):
        if batch.dim() == 3:
            return single_step(gen, batch)
        for b in batch:
            metrics = single_step(gen, b)
        return metrics

    def eval_step(gen, ys, enc=None, noise=None, ctrl=None):
        ev = {"elbo": torch.tensor(next_elbo()), "r2_k": torch.tensor([0.5, 0.25, 0.0]),
              "ess_mean": torch.tensor(3.0)}
        if with_extras:
            ev.update(elbo_psvo_direct=torch.tensor(-4.0), log_joint_smoothed=torch.tensor(-5.0))
        return ev

    train_step.single_step = single_step
    tr.train_step, tr.eval_step = train_step, eval_step
    return tr


def _both(elbos, n_steps, with_extras=False, **train_kw):
    jcfg, tcfg = _configs(**train_kw)
    obs, test = _index_data()
    ref = _reference_trainer(jcfg, elbos, with_extras)
    ref_hist = ref.run(obs, test, n_steps=n_steps)
    port = _port_trainer(tcfg, elbos, with_extras)
    port_hist = port.run(torch.from_numpy(obs), torch.from_numpy(test), n_steps=n_steps)
    return ref, ref_hist, port, port_hist


@pytest.mark.parametrize("epochs,spc", [(0, 1), (0, 2), (3, 1), (3, 2)])
def test_minibatch_indices_match_reference(epochs, spc):
    """The same trajectory indices at every step: choice without replacement
    (epochs = 0) or an epoch permutation (epochs > 0), from
    default_rng(seed + 2); with steps_per_call 2 and 7 steps the tail chunk
    runs one step."""
    ref, _, port, _ = _both([-1.0] * 20, n_steps=7, epochs=epochs, steps_per_call=spc,
                            eval_every=2, save_every=2, patience=100)
    assert len(ref.indices) == 7
    assert port.indices == ref.indices
    assert port.state.step == ref.state.step == 7


# test ELBOs, one an eval: +5e-7 is inside the 1e-6 margin (no improvement),
# the best is the fifth eval, and patience 3 stops the run at the eighth
_ELBOS = [-10.0, -8.0, -8.0 + 5e-7, -9.0, -7.0, -7.5, -7.2, -7.9, -6.0, -5.0]


@pytest.mark.parametrize("spc,keep_best", [(1, True), (2, True), (2, False)])
def test_control_flow_matches_reference(spc, keep_best):
    """Eval steps, the early-stopping step, the checkpoint calls and the
    keep_best outcome for one scripted test-ELBO sequence."""
    ref, ref_hist, port, port_hist = _both(
        _ELBOS, n_steps=40, steps_per_call=spc, eval_every=2, save_every=4, patience=3,
        keep_best=keep_best)
    assert [r["step"] for r in port_hist] == [r["step"] for r in ref_hist] == list(range(2, 17, 2))
    assert [r["test_elbo"] for r in port_hist] == [r["test_elbo"] for r in ref_hist]
    assert port.checkpointer.calls == ref.checkpointer.calls
    assert ref.checkpointer.calls[-1] == (16, True)
    st_p, st_r = port.state, ref.state
    assert st_p.step == st_r.step == 16
    assert st_p.evals_since_best == st_r.evals_since_best == 3
    assert st_p.best_elbo == pytest.approx(st_r.best_elbo)
    assert float(st_r.params["tag"]) == (10 if keep_best else 16)
    assert port.ssm.prior_mean[0].item() == float(st_r.params["tag"])
    assert (st_p.best_params is None) == (st_r.best_params is None)


def test_tail_chunk_and_cadence_match_reference():
    """n_steps not a multiple of steps_per_call: evals at 2, 4, 6 and the last
    step, saves at 4 and the forced one at the end, in both."""
    ref, ref_hist, port, port_hist = _both(
        [-3.0, -2.0, -1.0, -0.5], n_steps=7, steps_per_call=2, eval_every=2, save_every=4)
    assert [r["step"] for r in port_hist] == [r["step"] for r in ref_hist] == [2, 4, 6, 7]
    assert port.checkpointer.calls == ref.checkpointer.calls == [(4, False), (7, True)]


@pytest.mark.parametrize("field,value", [("eval_every", 3), ("save_every", 5)])
def test_steps_per_call_cadence_is_refused(field, value):
    """eval_every and save_every must be multiples of steps_per_call, in both."""
    jcfg, tcfg = _configs(**{"steps_per_call": 2, "eval_every": 4, "save_every": 4, field: value})
    obs, test = _index_data()
    with pytest.raises(ValueError, match="multiple of"):
        _reference_trainer(jcfg, []).run(obs, test, n_steps=4)
    with pytest.raises(ValueError, match=f"train.{field}={value} must be a multiple of"):
        _port_trainer(tcfg, []).run(torch.from_numpy(obs), torch.from_numpy(test), n_steps=4)


@pytest.mark.parametrize("with_extras", [False, True])
def test_history_records_carry_the_reference_keys(with_extras, tmp_path):
    """The same keys and values in each record (PSVO's extras when the eval
    gives them), and metrics.jsonl holds the records with a time field."""
    from psvo_tpu_torch.utils.metrics import MetricsWriter

    ref, ref_hist, port, port_hist = _both([-3.0, -2.0], n_steps=4, with_extras=with_extras,
                                           eval_every=2, save_every=2)
    assert len(port_hist) == len(ref_hist) == 2
    for got, want in zip(port_hist, ref_hist):
        assert got.keys() == want.keys()
        for key in want:
            if key != "steps_per_sec":
                assert got[key] == pytest.approx(want[key]), key
    with MetricsWriter(tmp_path / "m.jsonl") as w:
        for rec in port_hist:
            w.write(rec)
    lines = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [2, 4] and all("time" in ln for ln in lines)


def test_profile_window_writes_a_chrome_trace(tmp_path, capsys):
    """--profile's window starts at eval_every + 1 and here outlives the run,
    which closes it: the trace file is written and parses."""
    _, tcfg = _configs(eval_every=2, save_every=2)
    obs, test = _index_data()
    port = _port_trainer(tcfg, [-1.0] * 4)
    port.profile_dir = str(tmp_path / "prof")
    port.run(torch.from_numpy(obs), torch.from_numpy(test), n_steps=5)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in trace
    assert "profiler trace written to" in capsys.readouterr().out


def _fivo_config(**train_kw):
    _, tcfg = small_configs(t=10, k=32)
    return dataclasses.replace(
        tcfg,
        data=dataclasses.replace(tcfg.data, n_train=16, n_test=4),
        train=dataclasses.replace(tcfg.train, batch_size=8, lr=1e-2, eval_every=10,
                                  save_every=10, **train_kw),
    )


def test_short_fivo_run_raises_the_test_elbo():
    """30 real FIVO steps on the CPU (the kernels' plain versions) raise the
    test ELBO from the first eval to the last."""
    cfg = _fivo_config(steps_per_call=5)
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    hist = ttrain.Trainer(cfg, ssm).run(ds.obs_train, ds.obs_test, n_steps=30)
    assert [r["step"] for r in hist] == [10, 20, 30]
    assert all(math.isfinite(r["test_elbo"]) for r in hist)
    assert hist[-1]["test_elbo"] > hist[0]["test_elbo"]


@pytest.mark.parametrize("poison", ["parameter", "gradient", "update"])
def test_debug_checks_flags_nonfinite_and_passes_clean(poison):
    """train.debug_checks: a clean step passes; a NaN parameter entering the
    step, a NaN gradient (a hook poisons it), or an update that makes a
    parameter non-finite (lr = inf) raises FloatingPointError naming the
    parameter."""
    cfg = _fivo_config(debug_checks=True)
    if poison == "update":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=math.inf))
    ds = generate_dataset(cfg.data, cfg.seed)
    ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = ttrain.make_train_step(ssm, cfg, ttrain.make_optimizer(cfg))
    batch = ds.obs_train[: cfg.train.batch_size]
    if poison == "parameter":
        assert math.isfinite(float(step(torch.Generator().manual_seed(1), batch)["loss"]))
        with torch.no_grad():
            ssm.heads["f"].weights[0][0, 0] = float("nan")
        with pytest.raises(FloatingPointError,
                           match=r"heads\.f\.weights\.0 is not finite entering the step"):
            step(torch.Generator().manual_seed(1), batch)
    elif poison == "gradient":
        ssm.heads["g"].mean_b.register_hook(lambda g: g * float("nan"))
        with pytest.raises(FloatingPointError, match=r"the gradient of heads\.g\.mean_b is not "
                                                     "finite after the backward"):
            step(torch.Generator().manual_seed(1), batch)
    else:
        # prior_mean is the first parameter: its update is ±inf, or NaN on a zero gradient
        with pytest.raises(FloatingPointError, match="prior_mean is not finite after the update"):
            step(torch.Generator().manual_seed(1), batch)
