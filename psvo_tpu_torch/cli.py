"""The port's experiment command line (counterpart of `psvo_tpu/cli.py`).

Usage:
    python -m psvo_tpu_torch.cli train --preset fhn_fivo_k128 [--steps N] [--resume DIR]
    python -m psvo_tpu_torch.cli eval  --preset ... --checkpoint DIR
    python -m psvo_tpu_torch.cli data  --preset ... --out FILE.npz
    python -m psvo_tpu_torch.cli presets

train and eval run on the card (`--device cuda`, the default) through the
hand-written kernels; without a card they stop with an error and never
fall back to the CPU. `--device cpu` runs the kernels' plain versions on
the CPU, for tests and small runs. --set dotted.key=value overrides any
config field, e.g. --set smc.n_particles=512. The `bench` subcommand waits
for the port's benchmark.

A preset with a mesh (cfg.mesh, e.g. lorenz96_fivo_k8192_sharded's 1x8)
trains sharded when started as one rank per mesh position:

    python -m torch.distributed.run --nproc-per-node 8 -m psvo_tpu_torch.cli train \
        --preset lorenz96_fivo_k8192_sharded [--dist-backend gloo]

Each rank joins the process group from its launcher's environment
(`--dist-init`, env:// by default), on NCCL with one card a rank or gloo
(`--dist-backend`: gloo where ranks share a card, and on the CPU); rank 0
alone writes the results. Started as one process, a mesh preset runs
unsharded, as the reference does on too few devices.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import torch

from psvo_tpu_torch.config import PRESETS, Config, from_dict, preset
from psvo_tpu_torch.utils.rng import run_generator


def apply_overrides(cfg: Config, sets: list[str]) -> Config:
    """Apply --set dotted.key=value overrides onto the config dataclass tree."""
    d = cfg.to_dict()
    for item in sets:
        key, _, raw = item.partition("=")
        if not raw:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        if parts[-1] not in node:
            raise SystemExit(f"unknown config key {key!r}")
        node[parts[-1]] = value
    return from_dict(d)


def _device(name: str) -> torch.device:
    """The run's device. A CUDA device that is not there stops the command:
    the port trains and evaluates on the card, or on the CPU only when asked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA card is visible (torch.cuda.is_available() is False); "
            "the port runs on the card, or pass --device cpu to run the kernels' plain "
            "versions on the CPU"
        )
    return device


def _mesh_gate(cfg: Config, device: torch.device, backend: str | None = None,
               init_method: str = "env://"):
    """The reference's `sharding.maybe_mesh` on the port: (mesh, this rank's
    device). One process runs a mesh preset unsharded, with the reference's
    line (mesh None); a launcher's ranks, one per mesh position
    (WORLD_SIZE in the environment), join the process group on `backend`
    (NCCL on the card, gloo on the CPU by default) and build the mesh, each
    rank on its own card (`launch.rank_device`: LOCAL_RANK modulo the cards)."""
    from psvo_tpu_torch.parallel import launch, sharding

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        sharding.maybe_mesh(cfg)  # the unsharded line of a mesh preset
        return None, device
    if cfg.mesh.data * cfg.mesh.particle == 1:
        raise SystemExit(f"{world} ranks started for {cfg.name}, which has no mesh: start one "
                         "process, or set mesh.data and mesh.particle")
    if device.type == "cuda":
        device = launch.rank_device("cuda")
    if not torch.distributed.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        torch.distributed.init_process_group(backend, init_method=init_method,
                                             rank=int(os.environ["RANK"]), world_size=world)
    return sharding.maybe_mesh(cfg), device


def build(cfg: Config, data_npz: str | None = None, device="cuda"):
    """(dataset on the CPU, model on `device`): the dataset simulated from
    cfg.seed or loaded from an npz, the model initialised from cfg.seed."""
    from psvo_tpu_torch.data import generate_dataset, load_dataset
    from psvo_tpu_torch.models.ssm import init_ssm

    dataset = load_dataset(data_npz) if data_npz else generate_dataset(cfg.data, cfg.seed)
    ssm = init_ssm(cfg, run_generator(cfg, 0, "cpu"), device=device)
    return dataset, ssm


@torch.no_grad()
def _inferred_test_latents(cfg, ssm, dataset, device):
    """Posterior latent paths on the test set for the parity plots, as numpy
    [n_test, T, Dx]: the smoothed trajectories (mean over the M backward
    draws) for smoothing objectives, else the filtering means, through the
    inference API (which, under the active mesh, infers each rank's rows and
    gathers them over the data axis)."""
    from psvo_tpu_torch.infer import filter_posterior, smooth_posterior

    gen = run_generator(cfg, 9, device)
    obs = dataset.obs_test.to(device)
    # q_uses_true_x: the encoder heads take Dx inputs and must see the latents
    enc = _encoder_inputs_for(cfg, dataset, device)
    ctrl = dataset.controls_test.to(device) if cfg.data.di else None
    if cfg.smc.objective in ("svo", "psvo"):
        paths = smooth_posterior(ssm, obs, cfg, gen, method=cfg.smc.objective,
                                 encoder_inputs=enc, controls=ctrl)
        means = paths.mean(dim=1)
    else:
        means = filter_posterior(ssm, obs, cfg, gen, encoder_inputs=enc, controls=ctrl)
    return means.cpu().numpy()


def _encoder_inputs_for(cfg: Config, dataset, device):
    """Test-set encoder inputs under the q_uses_true_x debug flag, else None."""
    if not cfg.smc.q_uses_true_x:
        return None
    if dataset.hidden_test is None:
        raise SystemExit("q_uses_true_x=True requires a dataset with saved latents")
    return dataset.hidden_test.to(device)


def cmd_train(args) -> int:
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = apply_overrides(preset(args.preset), args.set or [])
    if args.debug_checks:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, debug_checks=True))
    if args.steps:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, n_steps=args.steps))
    device = _device(args.device)
    main = int(os.environ.get("RANK", "0")) == 0  # the rank that writes the results
    say = print if main else (lambda *a, **k: None)
    say(f"config: {cfg.name} (hash {cfg.config_hash()})", flush=True)
    joined = torch.distributed.is_initialized()  # by a caller, who then leaves it
    mesh, device = _mesh_gate(cfg, device, args.dist_backend, args.dist_init)
    from psvo_tpu_torch.parallel import context

    if mesh is not None:
        say(f"mesh: data={mesh.data} x particle={mesh.particle} ({mesh.size} ranks, "
            f"{mesh.backend})", flush=True)
    try:
        history, results, dataset, ssm = _train(args, cfg, device, mesh, main, say)
        with context.using(mesh):
            inferred = _inferred_test_latents(cfg, ssm, dataset, device)
    finally:
        if mesh is not None and not joined:
            torch.distributed.destroy_process_group()
    if main:
        results.save_history(history)
        written, note = results.plot_all(history, dataset, inferred)
        say(note or " ".join(["plots:", *map(str, written)]), flush=True)
    return 0


def _train(args, cfg, device, mesh, main: bool, say):
    """Build, restore and run the Trainer; (history, results dir (rank 0's,
    else None), dataset, model)."""
    dataset, ssm = build(cfg, args.data_npz, device)
    from psvo_tpu_torch.train import Trainer
    from psvo_tpu_torch.utils.checkpoint import Checkpointer
    from psvo_tpu_torch.utils.metrics import MetricsWriter
    from psvo_tpu_torch.utils.results import ResultsDir

    results = ResultsDir(args.results_root, cfg) if main else None
    if main:
        say(f"results: {results.path}", flush=True)
    ckpt_dir = args.resume if args.resume else (results.checkpoint_dir() if main else None)
    with contextlib.ExitStack() as stack:
        metrics_writer = (stack.enter_context(MetricsWriter(results.metrics_path()))
                          if main else None)
        trainer = Trainer(
            cfg,
            ssm,
            mesh=mesh,
            metrics_writer=metrics_writer,
            checkpointer=None if ckpt_dir is None else Checkpointer(ckpt_dir, cfg.resume_hash()),
            profile_dir=args.profile,
        )
        if args.resume:
            step = trainer.restore()
            say(f"resumed from step {step}", flush=True)
        history = trainer.run(
            dataset.obs_train,
            dataset.obs_test,
            hidden_train=dataset.hidden_train,
            hidden_test=dataset.hidden_test,
            controls_train=dataset.controls_train,
            controls_test=dataset.controls_test,
        )
    return history, results, dataset, ssm


def cmd_eval(args) -> int:
    cfg = apply_overrides(preset(args.preset), args.set or [])
    device = _device(args.device)
    dataset, ssm = build(cfg, device=device)
    from psvo_tpu_torch.train import make_eval_step
    from psvo_tpu_torch.utils.checkpoint import Checkpointer

    if args.checkpoint:
        if Checkpointer(args.checkpoint, cfg.resume_hash()).restore_params(ssm) is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint}")
    ev = make_eval_step(ssm, cfg)(
        run_generator(cfg, 3, device),
        dataset.obs_test.to(device),
        _encoder_inputs_for(cfg, dataset, device),
        None,
        dataset.controls_test.to(device) if cfg.data.di else None,
    )
    out = {k: v.detach().cpu().tolist() for k, v in ev.items()}
    if cfg.smc.objective == "psvo":
        # both PSVO bound forms side by side: `elbo` is the Rao-Blackwellized
        # forward bound, `elbo_psvo_direct` the sampled-trajectory one
        print(
            f"# PSVO bounds: forward (reported `elbo`) {out['elbo']:.3f} | "
            f"direct sampled-trajectory (`elbo_psvo_direct`) "
            f"{out['elbo_psvo_direct']:.3f} — see docs/DESIGN.md for the "
            "support-size offset between the two",
            file=sys.stderr,
        )
    print(json.dumps(out, indent=2))
    return 0


def cmd_data(args) -> int:
    """Generate a dataset from a preset's data config and save it as .npz."""
    from psvo_tpu_torch.data import generate_dataset, save_dataset

    cfg = apply_overrides(preset(args.preset), args.set or [])
    ds = generate_dataset(cfg.data, cfg.seed)
    save_dataset(ds, args.out)
    print(f"saved {cfg.data.datatype} dataset ({cfg.data.n_train}+{cfg.data.n_test} "
          f"trajectories, T={cfg.data.t_steps}) to {args.out}")
    return 0


def cmd_presets(_args) -> int:
    for name, cfg in PRESETS.items():
        print(
            f"{name:32s} objective={cfg.smc.objective:5s} K={cfg.smc.n_particles:<6d}"
            f" data={cfg.data.datatype:8s} T={cfg.data.t_steps}"
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="psvo_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = "cuda (the default: the card, the kernels) or cpu (their plain versions)"

    p_train = sub.add_parser("train")
    p_train.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_train.add_argument("--steps", type=int, default=0)
    p_train.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_train.add_argument("--results-root", default="results")
    p_train.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p_train.add_argument(
        "--data-npz", default=None, help="load a saved dataset instead of simulating"
    )
    p_train.add_argument(
        "--debug-nans", action="store_true",
        help="torch.autograd.set_detect_anomaly(True): a NaN made in a backward raises",
    )
    p_train.add_argument(
        "--debug-checks", action="store_true",
        help="check every step's parameters, loss and gradients for finite values and "
        "name the first that is not (syncs every step)",
    )
    p_train.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of steady-state steps into DIR",
    )
    p_train.add_argument("--device", default="cuda", help=device_help)
    p_train.add_argument(
        "--dist-backend", default=None, choices=("nccl", "gloo"),
        help="the process group's backend under a launcher (default: nccl on the card, "
        "gloo on the CPU; gloo where ranks share a card)",
    )
    p_train.add_argument(
        "--dist-init", default="env://",
        help="the process group's rendezvous under a launcher (default env://, as "
        "torch.distributed.run sets it; or file:///path)",
    )
    p_train.set_defaults(fn=cmd_train)

    p_eval = sub.add_parser("eval")
    p_eval.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_eval.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_eval.add_argument("--checkpoint", default=None)
    p_eval.add_argument("--device", default="cuda", help=device_help)
    p_eval.set_defaults(fn=cmd_eval)

    p_data = sub.add_parser("data", help="generate + save a dataset (.npz)")
    p_data.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p_data.add_argument("--set", action="append", metavar="KEY=VALUE")
    p_data.add_argument("--out", required=True)
    p_data.set_defaults(fn=cmd_data)

    p_presets = sub.add_parser("presets")
    p_presets.set_defaults(fn=cmd_presets)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
