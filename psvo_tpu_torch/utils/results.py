"""Results directory (counterpart of `psvo_tpu/utils/results.py`).

A timestamped directory per run holding the full config as JSON
(`params.json`, with its `config_hash`), the metric stream
(`metrics.jsonl`), the eval history (`history.json`), the checkpoints and
the plots of `psvo_tpu_torch.utils.plots`.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

from psvo_tpu_torch.config import Config


class ResultsDir:
    def __init__(self, root: str | Path, cfg: Config):
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = Path(root) / f"{cfg.name}_{stamp}"
        self.path.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.save_params_json()

    def save_params_json(self) -> None:
        """The full hyperparameters as JSON, plus the config hash."""
        payload = self.cfg.to_dict()
        payload["config_hash"] = self.cfg.config_hash()
        (self.path / "params.json").write_text(json.dumps(payload, indent=2, default=str))

    def metrics_path(self) -> Path:
        return self.path / "metrics.jsonl"

    def checkpoint_dir(self) -> Path:
        return self.path / "checkpoints"

    def save_history(self, history: list[dict]) -> None:
        (self.path / "history.json").write_text(json.dumps(history, indent=2))

    def plot_all(self, history, dataset=None, inferred=None) -> tuple[list[Path], str | None]:
        """(plots written, note): the ELBO curve and R² bars from the history,
        and with the dataset and the inferred test latents the FHN phase
        portrait (Dx = 2) or the Lorenz 3-D paths (Dx = 3). Without
        matplotlib no plot is written and the note says why."""
        try:
            import matplotlib  # noqa: F401
        except ImportError as exc:
            return [], f"plots: none written, matplotlib is not importable ({exc})"
        from psvo_tpu_torch.utils import plots

        written = []
        if history:
            written.append(plots.plot_elbo_curve(history, self.path / "elbo.png"))
            written.append(plots.plot_r2(history, self.path / "r2.png"))
        if dataset is not None and inferred is not None:
            dx = dataset.hidden_test.shape[-1]
            if dx == 2:
                written.append(plots.plot_phase_portrait_2d(
                    dataset.hidden_test, inferred, self.path / "phase_portrait.png"))
            elif dx == 3:
                written.append(plots.plot_trajectories_3d(
                    dataset.hidden_test, inferred, self.path / "trajectory_3d.png"))
        return [w for w in written if w is not None], None
