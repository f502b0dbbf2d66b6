"""Rank workers of the port's sharding tests (`tests/test_torch_sharding_*.py`).

Each test module starts one group of gloo ranks on the CPU through
`psvo_tpu_torch.parallel.launch.run(n, "_torch_ranks:run_jobs", payload)`
and checks the results against `psvo_tpu`. This module imports torch and the
port only, so the ranks stay light. A job is a dict with a "kind" (a
function below), a config dict "cfg" whose `mesh` is the job's mesh, the
port's parameters "state" (a state dict) and its inputs; what it returns
holds tensors, numbers and strings.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from psvo_tpu_torch import config as tconfig
from psvo_tpu_torch.models.ssm import SSM
from psvo_tpu_torch.objectives import make_objective
from psvo_tpu_torch.ops import sharded_resampling
from psvo_tpu_torch.parallel import collectives, context, sharding
from psvo_tpu_torch.smc import forward_filter
from psvo_tpu_torch.train import _data_metrics


def run_jobs(payload: dict) -> dict:
    """Run the payload's jobs in order on this rank; {name: result}."""
    out = {}
    for job in payload["jobs"]:
        cfg = tconfig.from_dict(job["cfg"])
        mesh = sharding.make_mesh(cfg)
        with context.using(mesh):
            out[job["name"]] = _KINDS[job["kind"]](job, cfg, mesh)
    return out


def _model(job, cfg):
    ssm = SSM(cfg)
    ssm.load_state_dict(job["state"])
    return ssm


def _rows(mesh, t):
    return None if t is None else mesh.local(t, 0)


def objective_grad(job, cfg, mesh):
    """The objective's loss and every gradient leaf on job["ys"] with the
    global noise job["noise"], the sharded train step's gradient rule
    (the loss over P·D, one world all-reduce), and the collectives that the
    forward and the backward made."""
    ssm = _model(job, cfg)
    objective = make_objective(ssm, cfg)
    collectives.reset_counts()
    out = objective(None, _rows(mesh, job["ys"]), None, job["noise"],
                    _rows(mesh, job.get("controls")))
    forward_counts = collectives.counts()
    collectives.reset_counts()
    (out.loss / mesh.size).backward()
    backward_counts = collectives.counts()
    params = list(ssm.parameters())
    grads = collectives.all_reduce_grads(
        [torch.zeros_like(p) if p.grad is None else p.grad for p in params])
    smoothed = None if out.smoothed is None else collectives.gather_rows(out.smoothed.detach(), 1)
    return {"loss": float(collectives.data_mean(out.loss.detach())),
            "elbo": collectives.gather_rows(out.elbo.detach()), "smoothed": smoothed,
            "metrics": {k: float(v) for k, v in _data_metrics(out.metrics).items()},
            "grads": grads, "forward_counts": forward_counts,
            "backward_counts": backward_counts}


def filter_result(job, cfg, mesh):
    """forward_filter's log Z, increments, ESS and filtered means on the
    global noise, gathered to the whole batch, and its collectives."""
    ssm = _model(job, cfg)
    collectives.reset_counts()
    with torch.no_grad():
        fwd = forward_filter(ssm, None, _rows(mesh, job["ys"]), cfg.smc, noise=job["noise"])
    return {"log_z": collectives.gather_rows(fwd.log_z),
            "increments": collectives.gather_rows(fwd.increments, dim=1),
            "ess": collectives.gather_rows(fwd.ess, dim=1),
            "filtered_means": collectives.gather_rows(fwd.filtered_means, dim=1),
            "counts": collectives.counts()}


def island(job, cfg, mesh):
    """One resampling step of the sharded island on the global (u, logw, x):
    the global ancestors and resampled particles, gathered (every rank's
    slots, in particle order), and the ESS."""
    u, logw, x = (mesh.local(t, 0, True) for t in (job["u"], job["logw"], job["x"]))
    x_out, logw_out, did, ess, idx, _ = sharded_resampling.sharded_maybe_resample(
        u, logw, x, ess_threshold=job.get("ess_threshold", 1.0))
    gather = [torch.empty_like(idx) for _ in range(mesh.particle)]
    dist.all_gather(gather, idx, group=mesh.row_group)
    gx = [torch.empty_like(x_out) for _ in range(mesh.particle)]
    dist.all_gather(gx, x_out.contiguous(), group=mesh.row_group)
    return {"idx": collectives.gather_rows(torch.cat(gather, dim=-1)),
            "x": collectives.gather_rows(torch.cat(gx, dim=-1)),
            "ess": collectives.gather_rows(ess), "did": collectives.gather_rows(did)}


def train(job, cfg, mesh):
    """Sharded train steps on job["batches"] (global batches), from a
    generator seeded with job["seed"] or on the global draws of
    job["noises"]: the losses, the gradient norms and the summed gradients,
    and this rank's parameters after every step (the replicas must stay
    equal)."""
    from psvo_tpu_torch.train import make_optimizer

    ssm = _model(job, cfg)
    step = sharding.make_sharded_train_step(ssm, cfg, make_optimizer(cfg), mesh)
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    noises = job.get("noises") or [None] * len(job["batches"])
    losses, norms, grads, snapshots = [], [], [], []
    for batch, noise in zip(job["batches"], noises):
        metrics = step(gen, batch, noise=noise)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        grads.append(torch.cat([p.grad.reshape(-1) for p in ssm.parameters()]))
        snapshots.append(torch.cat([p.detach().reshape(-1) for p in ssm.parameters()]))
    return {"losses": losses, "grad_norms": norms, "grads": grads, "params": snapshots}


def eval_metrics(job, cfg, mesh):
    """The sharded eval step on the global test batch and noise."""
    ssm = _model(job, cfg)
    ev = sharding.make_sharded_eval_step(ssm, cfg, mesh)(None, job["ys"], None, job["noise"])
    return {k: v.detach() for k, v in ev.items()}


def checkpoint(job, cfg, mesh):
    """A sharded train step, a checkpoint written by rank 0, then a restore
    on every rank into a model from another init, re-placed from rank 0,
    and one more sharded step from it."""
    from psvo_tpu_torch.train import Trainer
    from psvo_tpu_torch.utils.checkpoint import Checkpointer

    ssm = _model(job, cfg)
    ckpt = Checkpointer(job["dir"], cfg.resume_hash())
    trainer = Trainer(cfg, ssm, mesh=mesh, checkpointer=ckpt)
    trainer.train_step(trainer.state.generator, job["batch"])
    trainer.state.step = 1
    if mesh.rank == 0:
        ckpt.save(trainer.state, force=True)
    dist.barrier()
    saved = torch.cat([p.detach().reshape(-1) for p in ssm.parameters()])
    other = SSM(cfg)
    other.load_state_dict(job["other_state"])
    fresh = Trainer(cfg, other, mesh=mesh, checkpointer=Checkpointer(job["dir"],
                                                                     cfg.resume_hash()))
    step = fresh.restore()
    restored = torch.cat([p.detach().reshape(-1) for p in other.parameters()])
    metrics = fresh.train_step(fresh.state.generator, job["batch"])
    return {"step": step, "saved": saved, "restored": restored,
            "loss": float(metrics["loss"])}


def collective_ops(job, cfg, mesh):
    """Each collective on this rank's row of job["x"] [world, n] (and the
    cotangents job["g"]): psum and pmax over the particle axis, psum over the
    data axis, the row's all-gather, a ring shift, and the gradients of the
    psum and of the shift (the cotangent lands on the sender)."""
    x = job["x"][mesh.rank].clone().requires_grad_(True)
    g = job["g"][mesh.rank]
    out = {"psum": collectives.psum(x), "pmax": collectives.pmax(x),
           "pmin": collectives.pmin(x), "psum_data": collectives.psum(x, "data"),
           "gather": collectives.all_gather_rows(x.detach())}
    (torch.sum(out["psum"] * g)).backward()
    out["psum_grad"], x.grad = x.grad, None
    shifted, other = collectives.ring_shift(x, job["tag"][mesh.rank])
    torch.sum(shifted * g).backward()
    out["shift"], out["shift_other"], out["shift_grad"] = shifted.detach(), other, x.grad
    return {k: v.detach() for k, v in out.items()}


def first_argmax(job, cfg, mesh):
    """The global first-argmax of job["z"] [b, M, K] over this rank's
    particles, and the owner-selected values."""
    from psvo_tpu_torch.ops import sharded_ffbsi

    z = mesh.local(job["z"], 0, True)
    gidx, aloc, own = sharded_ffbsi.global_first_argmax(z)
    picked = sharded_ffbsi.psum_select(torch.gather(z, 2, aloc[..., None])[..., 0], own)
    return {"gidx": collectives.gather_rows(gidx), "picked": collectives.gather_rows(picked),
            "owners": collectives.psum(own.to(torch.int64))}


def inference(job, cfg, mesh):
    """The inference API under the mesh on the global batch job["ys"] and the
    global draws: filter_posterior's means, particles and log-weights (the
    filter's draws job["noise"]) and smooth_posterior's paths (the PSVO
    objective's draws job["psvo_noise"])."""
    from psvo_tpu_torch.infer import filter_posterior, smooth_posterior

    ssm = _model(job, cfg)
    means, particles, logws = filter_posterior(ssm, job["ys"], cfg, return_particles=True,
                                               noise=job["noise"])
    paths = smooth_posterior(ssm, job["ys"], cfg, noise=job["psvo_noise"])
    return {"means": means, "particles": particles, "logws": logws, "paths": paths}


_KINDS = {"objective_grad": objective_grad, "filter": filter_result, "island": island,
          "train": train, "eval": eval_metrics, "checkpoint": checkpoint,
          "collectives": collective_ops, "first_argmax": first_argmax,
          "inference": inference}
