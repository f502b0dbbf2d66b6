"""Experiment plots (counterpart of `psvo_tpu/utils/plots.py`): ELBO curves,
k-step R², FHN phase portraits and Lorenz 3-D paths.

matplotlib is imported inside each function, with the Agg backend, never
when this module is imported: a machine without it (the GPU machine has
none) still imports the package and trains; `ResultsDir.plot_all` then
writes no plots and says so. Every function writes a PNG and returns its
path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_elbo_curve(history: list[dict], path: Path) -> Path:
    plt = _pyplot()
    steps = [h["step"] for h in history]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(steps, [h["train_elbo"] for h in history], label="train ELBO")
    ax.plot(steps, [h["test_elbo"] for h in history], label="test ELBO")
    ax.set_xlabel("step")
    ax.set_ylabel("ELBO (log Ẑ)")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_r2(history: list[dict], path: Path) -> Path | None:
    last = history[-1].get("r2_k")
    if last is None:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(1, len(last) + 1), last, marker="o")
    ax.set_xlabel("prediction horizon k")
    ax.set_ylabel("R²")
    ax.set_ylim(min(-0.1, min(last) - 0.05), 1.05)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _align(inferred: np.ndarray, true: np.ndarray) -> np.ndarray:
    """Least-squares linear alignment of inferred latents onto the true frame
    (x_true ≈ x_inf A + b over all plotted trajectories): a learned SSM
    identifies its latent space only up to an invertible linear map, which
    the emission absorbs. The plot labels say so."""
    n, t, d = inferred.shape
    xi = np.concatenate([inferred.reshape(-1, d), np.ones((n * t, 1))], axis=1)
    coef, *_ = np.linalg.lstsq(xi, true.reshape(-1, d), rcond=None)
    return (xi @ coef).reshape(n, t, d)


def plot_phase_portrait_2d(hidden_true, inferred, path: Path, n_show: int = 4) -> Path:
    """FHN-style phase portrait: true vs inferred 2-D latent paths."""
    plt = _pyplot()
    true = np.asarray(hidden_true)[:n_show]
    inf = _align(np.asarray(inferred)[:n_show], true)
    n_show = len(true)
    fig, axes = plt.subplots(1, n_show, figsize=(4 * n_show, 4), squeeze=False)
    for i, ax in enumerate(axes[0]):
        ax.plot(true[i, :, 0], true[i, :, 1], "k-", lw=1.5, label="true")
        ax.plot(inf[i, :, 0], inf[i, :, 1], "r--", lw=1.2, label="inferred (linearly aligned)")
        ax.set_xlabel("$x_1$")
        ax.set_ylabel("$x_2$")
        if i == 0:
            ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_trajectories_3d(hidden_true, inferred, path: Path, n_show: int = 2) -> Path:
    """Lorenz-style 3-D trajectory plot: true vs inferred latent paths."""
    plt = _pyplot()
    true = np.asarray(hidden_true)[:n_show]
    inf = _align(np.asarray(inferred)[:n_show], true)
    n_show = len(true)
    fig = plt.figure(figsize=(6 * n_show, 5))
    for i in range(n_show):
        ax = fig.add_subplot(1, n_show, i + 1, projection="3d")
        ax.plot(*true[i].T[:3], "k-", lw=1.0, label="true")
        ax.plot(*inf[i].T[:3], "r--", lw=1.0, label="inferred (linearly aligned)")
        if i == 0:
            ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
