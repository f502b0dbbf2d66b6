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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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


def _mesh_gate(cfg: Config, device: torch.device) -> None:
    """The reference's `sharding.maybe_mesh` on the port: a mesh preset runs
    unsharded on one device when the devices for its mesh are not there;
    with enough devices it stops, since sharding is not ported yet."""
    n = cfg.mesh.data * cfg.mesh.particle
    if n <= 1:
        return
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count < n:
        print(
            f"mesh {cfg.mesh.data}x{cfg.mesh.particle} requested but only "
            f"{count} device(s) present — running unsharded",
            flush=True,
        )
        return
    raise NotImplementedError(
        f"mesh {cfg.mesh.data}x{cfg.mesh.particle} over {count} devices: sharded training "
        "is not ported yet (ROADMAP.md, queue 1 item 9)"
    )


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
    draws) for smoothing objectives, else the filtering means."""
    from psvo_tpu_torch.objectives import make_objective
    from psvo_tpu_torch.smc import forward_filter
    from psvo_tpu_torch.train import filtered_means

    gen = run_generator(cfg, 9, device)
    obs = dataset.obs_test.to(device)
    # q_uses_true_x: the encoder heads take Dx inputs and must see the latents
    enc = _encoder_inputs_for(cfg, dataset, device)
    ctrl = dataset.controls_test.to(device) if cfg.data.di else None
    if cfg.smc.objective in ("svo", "psvo"):
        out = make_objective(ssm, cfg)(gen, obs, enc, None, ctrl)
        return out.smoothed.mean(dim=2).transpose(0, 1).cpu().numpy()
    kw = {} if ctrl is None else {"controls": ctrl}
    fwd = forward_filter(ssm, gen, obs, cfg.smc, cache=True, encoder_inputs=enc, **kw)
    return filtered_means(fwd).cpu().numpy()


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
    print(f"config: {cfg.name} (hash {cfg.config_hash()})", flush=True)

    _mesh_gate(cfg, device)
    dataset, ssm = build(cfg, args.data_npz, device)
    from psvo_tpu_torch.train import Trainer
    from psvo_tpu_torch.utils.checkpoint import Checkpointer
    from psvo_tpu_torch.utils.metrics import MetricsWriter
    from psvo_tpu_torch.utils.results import ResultsDir

    results = ResultsDir(args.results_root, cfg)
    print(f"results: {results.path}", flush=True)
    ckpt_dir = args.resume if args.resume else results.checkpoint_dir()
    with MetricsWriter(results.metrics_path()) as metrics_writer:
        trainer = Trainer(
            cfg,
            ssm,
            metrics_writer=metrics_writer,
            checkpointer=Checkpointer(ckpt_dir, cfg.resume_hash()),
            profile_dir=args.profile,
        )
        if args.resume:
            step = trainer.restore()
            print(f"resumed from step {step}", flush=True)
        history = trainer.run(
            dataset.obs_train,
            dataset.obs_test,
            hidden_train=dataset.hidden_train,
            hidden_test=dataset.hidden_test,
            controls_train=dataset.controls_train,
            controls_test=dataset.controls_test,
        )
    results.save_history(history)
    inferred = _inferred_test_latents(cfg, ssm, dataset, device)
    written, note = results.plot_all(history, dataset, inferred)
    print(note or " ".join(["plots:", *map(str, written)]), flush=True)
    return 0


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
