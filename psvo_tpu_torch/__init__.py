"""psvo_tpu_torch — the PyTorch/CUDA port of `psvo_tpu`.

Module names mirror `psvo_tpu`'s so each counterpart is easy to find. The
port imports torch and never jax; importing it builds nothing and starts
no compile cache — the CUDA kernels (`ops/fused_step.py`, sources in
`csrc/`) are compiled on first use on a machine with a GPU.

Ported so far: the FIVO/IWAE filter of the diagonal-Gaussian model class
(FHN, Lorenz-63 and Lorenz-96 data) with its gradients, PSVO's FFBSi
smoothing, the optimizer and the train step, the evaluation, and the
filtering and smoothing posterior APIs, plus the loader of the reference's
.npz params snapshots. In the whole-scan class (FHN, Lorenz-63) the forward
scan is one hand-written CUDA kernel and its backward another; the FFBSi
sweep and its backward are two more. The wide Lorenz-96 state is served step
by step through three more: the large-K ancestor indices, the particle
gather and the trunk kernel (`ops/resample_gather.py`, `ops/trunk.py`); and
trained through two more, the trunk kernel's VJP and the segment-sum
scatter that transposes the gather. The same step-by-step trunk path
serves the reference's trunk class at the FHN and Lorenz-63 widths too:
ESS-adaptive resampling, IWAE at K >= 128 and the full FIVO gradient
(`smc.use_stop_gradient=False`, whose score-function term the filter
returns as `FilterResult.score_surrogate`). Models with exogenous controls
(data.di > 0, `controls=` on the entry points) run the whole-scan,
per-step and trunk kernels in their control mode, for every objective, and
SVO's sweep kernels in theirs; multinomial resampling runs on every kernel
path. PSVO
runs long sequences segmented (`smc.ffbsi_segments`): the filter keeps only
the segment boundaries and replays each segment for the backward sweep.
Bootstrap mode and the LGSSM data (the Kalman oracle's model) run on the
CPU. The product surface: the `Trainer` (`train.py`), checkpoints and
resume, metric and result files, plots, and the command line
(`python -m psvo_tpu_torch.cli`: presets, train, eval, data). Data and
particle sharding over `torch.distributed` (`parallel`): a (data, particle)
mesh of ranks splits the batch and the K particles, with the resampling
ring (K7/K8 per shard) and a sharded FFBSi; the sharded train and eval
steps, the Trainer and the command line run under it.
"""

__version__ = "0.1.0"

from psvo_tpu_torch import distributions, networks
from psvo_tpu_torch.bridge import load_params_npz
from psvo_tpu_torch.config import (
    PRESETS,
    Config,
    DataConfig,
    MeshConfig,
    NetConfig,
    SMCConfig,
    TrainConfig,
    preset,
)
from psvo_tpu_torch.data import Dataset, generate_dataset, load_dataset, save_dataset
from psvo_tpu_torch.infer import filter_posterior, smooth_posterior
from psvo_tpu_torch.models.ssm import SSM, init_ssm
from psvo_tpu_torch.objectives import make_objective
from psvo_tpu_torch.smc import FilterResult, forward_filter
from psvo_tpu_torch.train import (
    Trainer,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "Config",
    "DataConfig",
    "Dataset",
    "FilterResult",
    "MeshConfig",
    "NetConfig",
    "PRESETS",
    "SMCConfig",
    "SSM",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "distributions",
    "filter_posterior",
    "forward_filter",
    "generate_dataset",
    "init_ssm",
    "load_dataset",
    "load_params_npz",
    "make_eval_step",
    "make_objective",
    "make_optimizer",
    "make_train_step",
    "networks",
    "preset",
    "save_dataset",
    "smooth_posterior",
]
