"""The port's checkpoints (`psvo_tpu_torch.utils.checkpoint`) against what
the reference's hold (tests/test_train.py::test_checkpoint_roundtrip): the
parameters, the optimizer state, the best-params snapshot with its flag, the
generator, the early-stopping scalars and the config hash; plus max_to_keep,
`restore_params`, and a restore into a live Trainer whose next step must
equal the uninterrupted Trainer's (the optimizer state lives in the train
step's closure and must be restored in place).
"""

import dataclasses

import pytest
import torch

from psvo_tpu_torch import train as ttrain
from psvo_tpu_torch.data import generate_dataset
from psvo_tpu_torch.models.ssm import init_ssm
from psvo_tpu_torch.utils.checkpoint import Checkpointer
from tests._torch_port import small_configs

torch.set_num_threads(1)


def _cfg(**train_kw):
    _, tcfg = small_configs(t=6, k=32)
    return dataclasses.replace(
        tcfg,
        data=dataclasses.replace(tcfg.data, n_train=8, n_test=3),
        train=dataclasses.replace(tcfg.train, batch_size=4, keep_best=False, **train_kw),
    )


def _state(cfg, seed=0, **kw):
    ssm = init_ssm(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = ttrain.make_optimizer(cfg)
    return ttrain.TrainState(ssm, opt.init(list(ssm.parameters())),
                             torch.Generator().manual_seed(5), **kw)


def _params(ssm):
    return {k: v.detach().clone() for k, v in ssm.state_dict().items()}


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_roundtrip(tmp_path):
    cfg = _cfg()
    state = _state(cfg, step=17, best_elbo=-3.5, evals_since_best=2)
    best = {k: v + 1.0 for k, v in _params(state.model).items()}
    state.best_params = best
    for i, (m, v) in enumerate(zip(state.opt_state.mu, state.opt_state.nu)):
        m.fill_(0.1 * i)
        v.fill_(0.2 * i)
    state.opt_state.count.fill_(17)
    state.opt_state.notfinite_count.fill_(3)
    state.generator.manual_seed(11)
    torch.randn(3, generator=state.generator)  # a generator mid-stream
    want_draw = torch.randn(4, generator=torch.Generator().set_state(state.generator.get_state()))
    Checkpointer(tmp_path / "ck", cfg.config_hash()).save(state, force=True)

    fresh = _state(cfg, seed=1)
    restored = Checkpointer(tmp_path / "ck", cfg.config_hash()).restore(fresh)
    assert restored is fresh
    assert (fresh.step, fresh.best_elbo, fresh.evals_since_best) == (17, -3.5, 2)
    _assert_same(_params(fresh.model), _params(state.model))
    _assert_same(fresh.best_params, best)
    for got, want in zip(fresh.opt_state.mu + fresh.opt_state.nu,
                         state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(got, want)
    assert int(fresh.opt_state.count) == 17 and int(fresh.opt_state.notfinite_count) == 3
    assert torch.equal(torch.randn(4, generator=fresh.generator), want_draw)

    # a state saved without a best snapshot restores best_params=None
    state.best_params, state.step = None, 18
    Checkpointer(tmp_path / "ck", cfg.config_hash()).save(state, force=True)
    again = Checkpointer(tmp_path / "ck", cfg.config_hash()).restore(_state(cfg, seed=1))
    assert again.step == 18 and again.best_params is None


def test_wrong_config_hash_refuses(tmp_path):
    """A checkpoint of another config raises before it changes anything;
    strict=False (tooling only) restores it."""
    cfg = _cfg()
    Checkpointer(tmp_path / "ck", cfg.config_hash()).save(_state(cfg, step=3), force=True)
    fresh = _state(cfg, seed=1)
    before = _params(fresh.model)
    with pytest.raises(ValueError, match="config hash"):
        Checkpointer(tmp_path / "ck", "deadbeef0000").restore(fresh)
    _assert_same(_params(fresh.model), before)
    assert fresh.step == 0
    assert Checkpointer(tmp_path / "ck", "deadbeef0000").restore(fresh, strict=False).step == 3


def test_restore_params_loads_only_the_model(tmp_path):
    """The eval path: the newest checkpoint's parameters into a model, in
    place; None without a checkpoint."""
    cfg = _cfg()
    state = _state(cfg, step=4)
    ck = Checkpointer(tmp_path / "ck", cfg.resume_hash())
    assert ck.restore_params(_state(cfg, seed=1).model) is None
    ck.save(state)
    other = init_ssm(cfg, torch.Generator().manual_seed(1), device="cpu")
    weight = other.heads["f"].mean_w
    assert ck.restore_params(other) is other
    assert other.heads["f"].mean_w is weight
    _assert_same(_params(other), _params(state.model))


def test_max_to_keep_and_save_dedup(tmp_path):
    """The newest three steps stay; a step saved twice is written once unless
    forced; no temporary file is left."""
    cfg = _cfg()
    state = _state(cfg)
    ck = Checkpointer(tmp_path / "ck", cfg.config_hash())
    for step in range(1, 6):
        state.step = step
        ck.save(state)
    assert ck.steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["3.pt", "4.pt", "5.pt"]
    mtime = (tmp_path / "ck" / "5.pt").stat().st_mtime_ns
    ck.save(state)
    assert (tmp_path / "ck" / "5.pt").stat().st_mtime_ns == mtime


def test_restore_into_a_live_trainer_continues_exactly(tmp_path):
    """Trainer A runs 2 steps and saves; Trainer B, built fresh from other
    weights, restores that checkpoint. One more step on the same batch then
    gives both the same parameters and moments, bit for bit: B's train step
    holds the restored optimizer state and generator, not new ones."""
    cfg = _cfg(eval_every=2, save_every=2)
    ds = generate_dataset(cfg.data, cfg.seed)
    a_ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device="cpu")
    a = ttrain.Trainer(cfg, a_ssm, checkpointer=Checkpointer(tmp_path / "ck", cfg.resume_hash()))
    a.run(ds.obs_train, ds.obs_test, n_steps=2)

    b_ssm = init_ssm(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = ttrain.Trainer(cfg, b_ssm, checkpointer=Checkpointer(tmp_path / "ck", cfg.resume_hash()))
    opt_state = b.train_step.opt_state
    assert b.restore() == 2
    assert b.state.opt_state is opt_state and int(opt_state.count) == 2

    batch = ds.obs_train[: cfg.train.batch_size]
    a.train_step(a.state.generator, batch)
    b.train_step(b.state.generator, batch)
    _assert_same(_params(b_ssm), _params(a_ssm))
    for got, want in zip(b.state.opt_state.mu + b.state.opt_state.nu,
                         a.state.opt_state.mu + a.state.opt_state.nu):
        assert torch.equal(got, want)
