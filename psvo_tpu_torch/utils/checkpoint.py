"""Checkpoints for step-exact resume (counterpart of `psvo_tpu/utils/checkpoint.py`).

One file per saved step, `<directory>/<step>.pt`, written by `torch.save` to
a temporary name and moved into place with `os.replace`, so a reader never
sees half a file; the newest `max_to_keep` stay. The payload holds only
tensors, numbers, strings, lists and dicts, so it loads with
`torch.load(weights_only=True)`:

- `params`: the model's `state_dict`;
- `opt_state`: Adam's moments `mu` and `nu` (lists in parameter order) and
  the counters `count` and `notfinite_count` (`train.OptState`);
- `best_params` and `has_best`: the keep_best snapshot, saved as the params
  when there is none, as the reference does;
- `generator`: the run generator's `get_state()`, so a resumed run draws the
  streams (K1's in-kernel seeds too) that the uninterrupted run would;
- `step`, `best_elbo`, `evals_since_best`, and `config_hash`.

`restore` writes into the live objects in place: `load_state_dict` copies
into the parameters, the moments and counters are copied into the tensors of
the `OptState` that the train step holds, and the generator is set from its
state. A train step built before the restore therefore steps on the
restored state. The reference's legacy-format branch (round-1 Orbax
checkpoints without `best_params`) has no torch counterpart to read, so it
is not ported.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str | Path, config_hash: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.config_hash = config_hash
        self.max_to_keep = max_to_keep
        self._last_saved = -1

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        if not self.directory.is_dir():
            return []
        found = (_NAME.match(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state, force: bool = False) -> None:
        """Write `state` (a `train.TrainState`) at its step, unless that step
        was the last one saved and `force` is False."""
        if state.step == self._last_saved and not force:
            return
        params = state.model.state_dict()
        has_best = state.best_params is not None
        opt = state.opt_state
        payload = {
            "params": params,
            "opt_state": {"mu": list(opt.mu), "nu": list(opt.nu), "count": opt.count,
                          "notfinite_count": opt.notfinite_count},
            # best_params travels with best_elbo: restoring the threshold
            # without its snapshot would end a resumed keep_best run on the
            # last params
            "best_params": state.best_params if has_best else params,
            "has_best": has_best,
            "generator": state.generator.get_state(),
            "step": int(state.step),
            "best_elbo": float(state.best_elbo),
            "evals_since_best": int(state.evals_since_best),
            "config_hash": self.config_hash,
        }
        self.directory.mkdir(parents=True, exist_ok=True)
        final = self._path(state.step)
        tmp = final.with_name(f".{final.name}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, final)
        self._last_saved = state.step
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def _load(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_params(self, ssm):
        """Load only the model's parameters of the newest checkpoint into `ssm`
        (the evaluation path; independent of the optimizer's layout). Returns
        ssm, or None when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        ssm.load_state_dict(self._load(step)["params"])
        return ssm

    def restore(self, state, strict: bool = True):
        """Restore the newest checkpoint into `state` in place and return it;
        None when there is no checkpoint. A checkpoint of another config hash
        raises ValueError unless strict=False (tooling and inspection only)."""
        step = self.latest_step()
        if step is None:
            return None
        payload = self._load(step)
        if strict and payload["config_hash"] != self.config_hash:
            raise ValueError(f"checkpoint config hash {payload['config_hash']!r} != current "
                             f"{self.config_hash!r}")
        opt, saved = state.opt_state, payload["opt_state"]
        pairs = list(zip(opt.mu + opt.nu, saved["mu"] + saved["nu"]))
        if (len(saved["mu"]) != len(opt.mu) or len(saved["nu"]) != len(opt.nu)
                or any(d.shape != s.shape for d, s in pairs)):
            raise ValueError("checkpoint's optimizer moments do not match the model's parameters")
        gen_state = payload["generator"]
        if gen_state.numel() != state.generator.get_state().numel():
            raise ValueError(f"checkpoint's generator state ({gen_state.numel()} bytes) does not "
                             f"fit this run's {state.generator.device} generator")
        state.model.load_state_dict(payload["params"])
        with torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
            opt.count.copy_(saved["count"])
            opt.notfinite_count.copy_(saved["notfinite_count"])
        live = state.model.state_dict()
        state.best_params = ({k: v.to(live[k].device) for k, v in payload["best_params"].items()}
                             if payload["has_best"] else None)
        state.generator.set_state(gen_state)
        state.step = payload["step"]
        state.best_elbo = payload["best_elbo"]
        state.evals_since_best = payload["evals_since_best"]
        self._last_saved = state.step
        return state
