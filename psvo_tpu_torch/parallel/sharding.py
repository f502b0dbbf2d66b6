"""The mesh, the sharded train and eval steps, and the dry run (counterpart
of `psvo_tpu/parallel/sharding.py`).

The reference's backend is GSPMD over `jax.sharding.Mesh(("data",
"particle"))`. Here each mesh position is a rank of a `torch.distributed`
process group, one process each:

- the batch of trajectories splits over "data": each rank takes its rows of
  the global batch, and the gradients are summed over all ranks once per
  step (`collectives.all_reduce_grads`);
- the K particles split over "particle": per step a psum'd weight
  normalizer and the resampling ring (`ops.sharded_resampling`), and for
  PSVO/SVO the sharded anchors and FFBSi sweep (`ops.sharded_ffbsi`);
- parameters and optimizer state are replicated; every rank takes the same
  optimizer step on the same summed gradients, so the replicas stay equal
  bit for bit.

The gradient rule: each rank differentiates its particle row's loss scaled
by 1 / (P·D). A term computed alike on every rank of a row (q2 on the
observations, the smoothed paths' log-joint) is then counted P times over
the row at 1/P each, and every psum's backward sums the row's cotangents,
so the world sum of the ranks' gradients is the gradient of the mean of the
D rows' losses: the single-device gradient.

Backends: NCCL with one card a rank; gloo on the CPU and wherever ranks
share a card (NCCL refuses two ranks on one GPU). The caller chooses it and
it is never switched after a failure. `MeshConfig.slices` (the DCN layout)
is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import torch
import torch.distributed as dist

from psvo_tpu_torch.config import Config
from psvo_tpu_torch.parallel import context, launch


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group, or of the launcher's
    environment before it is joined."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(cfg: Config) -> context.Mesh:
    """The (data, particle) mesh of cfg.mesh over the joined process group,
    row-major as the reference's `make_mesh`, with the reference's checks.
    Every rank calls it: the subgroups are made collectively."""
    d, p = cfg.mesh.data, cfg.mesh.particle
    n = d * p
    rank, world = _world()
    if world < n:
        raise ValueError(f"config mesh {cfg.mesh} needs {n} ranks, have {world}")
    if world > n:
        raise ValueError(f"config mesh {cfg.mesh} takes {n} ranks, the group has {world}: "
                         "start as many ranks as the mesh has positions")
    if cfg.smc.n_particles % p:
        raise ValueError(f"K={cfg.smc.n_particles} not divisible by mesh.particle={p}")
    if cfg.train.batch_size % d:
        raise ValueError(f"batch_size={cfg.train.batch_size} not divisible by mesh.data={d}")
    rows = [tuple(range(i * p, (i + 1) * p)) for i in range(d)]
    cols = [tuple(range(j, n, p)) for j in range(p)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    col_groups = [dist.new_group(list(c)) for c in cols]
    return context.Mesh(data=d, particle=p, rank=rank, backend=dist.get_backend(),
                        row_group=row_groups[rank // p], col_group=col_groups[rank % p],
                        row_ranks=rows[rank // p])


def maybe_mesh(cfg: Config):
    """The mesh of cfg.mesh when the launcher started its ranks, else None:
    one rank runs the preset unsharded, with the reference's line. Any
    other count of ranks is refused."""
    n = cfg.mesh.data * cfg.mesh.particle
    if n <= 1:
        return None
    _, world = _world()
    if world == 1:
        print(f"mesh {cfg.mesh.data}x{cfg.mesh.particle} requested but only 1 device(s) present "
              "— running unsharded", flush=True)
        return None
    if world != n:
        raise SystemExit(f"mesh {cfg.mesh.data}x{cfg.mesh.particle} needs {n} ranks, the "
                         f"launcher started {world}: start {n}, or one to run unsharded")
    return make_mesh(cfg)


def _under(mesh: context.Mesh, step):
    """step, run under `mesh` on every call (the mesh active only while it
    runs), with step's attributes (`opt_state`, `single_step`)."""

    def call(*args, **kwargs):
        with context.using(mesh):
            return step(*args, **kwargs)

    call.__dict__.update(step.__dict__)
    if hasattr(step, "single_step"):
        call.single_step = _under(mesh, step.single_step)
    return call


def make_sharded_train_step(ssm, cfg: Config, optimizer, mesh: context.Mesh):
    """The train step under `mesh` (`train.make_train_step`, each call with
    the mesh active): it takes the global batch, steps on this rank's rows
    with the loss scaled by 1 / (P·D), sums the gradients over the world and
    averages the metrics over the data axis. The dispatch reads the mesh: a
    particle mesh runs the plain step body with the sharded island and the
    sharded FFBSi, and no path draws in-kernel (`smc._mesh_cfg`)."""
    from psvo_tpu_torch.train import make_train_step

    return _under(mesh, make_train_step(ssm, cfg, optimizer))


def make_sharded_eval_step(ssm, cfg: Config, mesh: context.Mesh):
    """The eval step under `mesh`: the test batch split over "data", the
    particles over "particle"; the metrics averaged over the data axis and
    the k-step R² on the gathered filtering means, as on one device."""
    from psvo_tpu_torch.train import make_eval_step

    return _under(mesh, make_eval_step(ssm, cfg))


def place_replicated(mesh: context.Mesh, tensors) -> None:
    """Make every rank's tensors rank 0's, in place (one broadcast): after a
    checkpoint restore, as the reference re-places restored state on its
    mesh."""
    from psvo_tpu_torch.parallel import collectives

    with context.using(mesh):
        collectives.broadcast_(list(tensors))


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def _dryrun_configs(d_data: int, d_part: int) -> list:
    """The reference's dryrun configurations (`sharding.dryrun`): Lorenz-96
    FIVO, Lorenz-63 PSVO and PSVO in two segments, at tiny shapes."""
    from psvo_tpu_torch.config import preset

    cfg = preset("lorenz96_fivo_k8192_sharded")
    fivo = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=8, n_train=8, n_test=4),
        smc=dataclasses.replace(cfg.smc, n_particles=16 * d_part),
        train=dataclasses.replace(cfg.train, batch_size=2 * d_data),
        mesh=dataclasses.replace(cfg.mesh, data=d_data, particle=d_part),
    )
    cfg = preset("lorenz63_psvo_k1024")
    psvo = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, t_steps=8, n_train=8, n_test=4),
        smc=dataclasses.replace(cfg.smc, n_particles=16 * d_part, n_smoothing_particles=4),
        train=dataclasses.replace(cfg.train, batch_size=2 * d_data, steps_per_call=1),
        mesh=dataclasses.replace(cfg.mesh, data=d_data, particle=d_part),
    )
    seg = dataclasses.replace(
        psvo,
        data=dataclasses.replace(psvo.data, t_steps=9),  # T − 1 = 8: two 4-step segments
        smc=dataclasses.replace(psvo.smc, ffbsi_segments=2),
    )
    return [("fivo", fivo), ("psvo", psvo), ("psvo-seg2", seg)]


def dryrun_rank(payload: dict) -> list:
    """One rank of `dryrun`: one sharded train step of each configuration.
    Returns [label, K, loss] per configuration."""
    from psvo_tpu_torch.models.ssm import init_ssm
    from psvo_tpu_torch.train import make_optimizer

    device = launch.rank_device(payload["device"])
    out = []
    for label, cfg in _dryrun_configs(payload["d_data"], payload["d_part"]):
        mesh = make_mesh(cfg)
        ssm = init_ssm(cfg, torch.Generator().manual_seed(0), device=device)
        step = make_sharded_train_step(ssm, cfg, make_optimizer(cfg), mesh)
        batch = torch.zeros((cfg.train.batch_size, cfg.data.t_steps, cfg.data.dy), device=device)
        metrics = step(torch.Generator(device=device).manual_seed(1), batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"sharded {label} train step produced non-finite loss {loss}")
        out.append([label, cfg.smc.n_particles, loss])
    return out


def dryrun(n_ranks: int, device: str = "cuda", verbose: bool = True) -> list:
    """One sharded FIVO, PSVO and segmented PSVO train step on n_ranks gloo
    ranks at tiny shapes (the reference's `dryrun_multichip`): mesh 2 × n/2
    when n >= 4 is even (both axes), else 1 × n. The ranks run on the CPU, or
    all on the card (`device="cuda"`). Returns rank 0's summary; raises if a
    rank fails or a loss is not finite."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"dryrun on {device}: no CUDA card is visible; pass device='cpu'")
    d_data = 2 if n_ranks >= 4 and n_ranks % 2 == 0 else 1
    d_part = n_ranks // d_data
    results = launch.run(n_ranks, "psvo_tpu_torch.parallel.sharding:dryrun_rank",
                         {"device": device, "d_data": d_data, "d_part": d_part})
    if any(r != results[0] for r in results):
        raise RuntimeError(f"the ranks disagree on the replicated losses: {results}")
    if verbose:
        print(f"dryrun ok: mesh data={d_data} particle={d_part} on {n_ranks} {device} ranks; "
              + "; ".join(f"{label} K={k} loss={loss:.3f}" for label, k, loss in results[0]),
              flush=True)
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m psvo_tpu_torch.parallel.sharding",
                                 description="Sharded train steps on spawned gloo ranks.")
    ap.add_argument("--dryrun", type=int, required=True, metavar="N", help="ranks to spawn")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: every rank on the card) or cpu")
    args = ap.parse_args(argv)
    dryrun(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
