"""The collectives of the sharded paths, called explicitly.

No counterpart in the reference: there GSPMD inserts the collectives that
`jax.lax.psum`, `pmax`, `pmin`, `all_gather` and `ppermute` name inside its
`shard_map` islands, and partitions every other reduction over K by itself.
In PyTorch nothing is inserted, so every reduction over K on a sharded path
calls one of these, and so does every gradient:

- `psum`: the sum over a mesh axis; its backward is the psum of the
  cotangents (the transpose of a replicated sum);
- `pmax`, `pmin`: no gradient, as the reference detaches them
  (`sharded_resampling.py:118-122`, `sharded_ffbsi.py:60-62`);
- `all_gather_rows`: [b] row scalars of every rank of an axis, as [b, n];
  no gradient (it feeds index arithmetic only);
- `ring_shift` (`RingShift`): tensors sent to the next rank of the particle
  row and received from the previous one in one message; the backward sends
  the cotangents the other way;
- `gather_rows`, `data_mean`, `data_min`, `all_reduce_grads` and
  `broadcast_`: the data axis and the world (eval metrics, the gradient
  all-reduce, replicated parameters);
- the particle-axis reductions the filter and the objectives take in place
  of their local ops: `logsumexp`, `log_normalize`, `weighted_mean` and
  `effective_sample_size`. With no particle mesh each is the local op it
  replaces, bit for bit.

Backends: NCCL takes device tensors. Gloo takes host tensors for its
point-to-point calls, so under gloo a CUDA tensor goes through a host
buffer on every collective: copied down, exchanged, copied up. Those bytes
are counted (`counts()["staged_bytes"]`) beside each op's calls and bytes
(the bytes this rank contributes). A collective on an axis of one rank
moves nothing and returns its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from psvo_tpu_torch.distributions import effective_sample_size as _local_ess
from psvo_tpu_torch.distributions import log_normalize as _local_log_normalize
from psvo_tpu_torch.parallel import context

PARTICLE = context.PARTICLE_AXIS
DATA = context.DATA_AXIS

_COUNTS: dict = {}  # op -> [calls, bytes]
_STAGED = [0]


def reset_counts() -> None:
    _COUNTS.clear()
    _STAGED[0] = 0


def counts() -> dict:
    """{op: {"calls": n, "bytes": n}} since the last reset, and
    "staged_bytes": the bytes copied between the card and host buffers."""
    out = {op: {"calls": c, "bytes": n} for op, (c, n) in sorted(_COUNTS.items())}
    out["staged_bytes"] = _STAGED[0]
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(op: str, t: torch.Tensor) -> None:
    c = _COUNTS.setdefault(op, [0, 0])
    c[0] += 1
    c[1] += _nbytes(t)


def _active(axis: str):
    """The active mesh if `axis` has more than one rank on it, else None."""
    mesh = context.get_mesh()
    return mesh if mesh is not None and mesh.axis_size(axis) > 1 else None


def _down(mesh, t: torch.Tensor) -> torch.Tensor:
    """The buffer a collective takes: a host copy of a CUDA tensor under gloo
    (counted), else a fresh contiguous copy on the tensor's device."""
    if mesh.backend == "gloo" and t.is_cuda:
        _STAGED[0] += _nbytes(t)
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def _up(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if buf.device != like.device:
        _STAGED[0] += _nbytes(buf)
        return buf.to(like.device)
    return buf


def _all_reduce(t: torch.Tensor, op, axis: str, name: str) -> torch.Tensor:
    mesh = _active(axis)
    if mesh is None:
        return t
    _count(name, t)
    buf = _down(mesh, t)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return _up(buf, t)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, dist.ReduceOp.SUM, axis, f"psum {axis}")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.axis, f"psum {ctx.axis} (backward)"), None


def psum(x: torch.Tensor, axis: str = PARTICLE) -> torch.Tensor:
    """Σ over the ranks of `axis`, on every one of them; differentiable."""
    if _active(axis) is None:
        return x
    return _PSum.apply(x, axis)


def pmax(x: torch.Tensor, axis: str = PARTICLE) -> torch.Tensor:
    """The max over the ranks of `axis`; no gradient."""
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, axis, f"pmax {axis}")


def pmin(x: torch.Tensor, axis: str = PARTICLE) -> torch.Tensor:
    """The min over the ranks of `axis`; no gradient."""
    return _all_reduce(x.detach(), dist.ReduceOp.MIN, axis, f"pmin {axis}")


def _all_gather(t: torch.Tensor, axis: str, name: str) -> list:
    mesh = _active(axis)
    if mesh is None:
        return [t.detach()]
    _count(name, t)
    buf = _down(mesh, t)
    outs = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(outs, buf, group=mesh.group(axis))
    return [_up(o, t) for o in outs]


def all_gather_rows(s: torch.Tensor, axis: str = PARTICLE) -> torch.Tensor:
    """s [b] of every rank of `axis`, [b, n] in rank order; no gradient."""
    return torch.stack(_all_gather(s, axis, f"all_gather {axis}"), dim=-1)


def gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data axis's shards of t concatenated along `dim` in data order:
    the global batch of a row-sharded tensor; no gradient."""
    return torch.cat(_all_gather(t.contiguous(), DATA, "gather_rows data"), dim=dim)


def data_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of a per-shard value; no gradient."""
    mesh = _active(DATA)
    if mesh is None:
        return t
    return _all_reduce(t.detach(), dist.ReduceOp.SUM, DATA, "data_mean") / mesh.data


def data_min(t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(t.detach(), dist.ReduceOp.MIN, DATA, "data_min")


def all_reduce_grads(grads: list) -> list:
    """Σ over every rank of each gradient, one message for all of them (the
    data-parallel all-reduce)."""
    if _active("world") is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = _all_reduce(flat, dist.ReduceOp.SUM, "world", "grad all_reduce world")
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def broadcast_(tensors: list, src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank src's (one message)."""
    mesh = _active("world")
    if mesh is None or not tensors:
        return
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    _count("broadcast world", flat)
    buf = _down(mesh, flat)
    dist.broadcast(buf, src=src)
    buf = _up(buf, flat)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = _nbytes(t)
            t.copy_(buf[offset:offset + n].clone().view(t.dtype).view_as(t))
            offset += n


def _shift(tensors, direction: int, name: str) -> list:
    """Send the tensors, as one byte message, to the rank `direction` places
    on in the particle row and receive the same shapes from the rank as far
    back."""
    mesh = context.get_mesh()
    p, n = mesh.particle_index, mesh.particle
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors])
    _count(name, flat)
    send = _down(mesh, flat)
    recv = torch.empty_like(send)
    group = mesh.group(PARTICLE)
    ops = [dist.P2POp(dist.isend, send, mesh.row_ranks[(p + direction) % n], group),
           dist.P2POp(dist.irecv, recv, mesh.row_ranks[(p - direction) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    recv = _up(recv, flat)
    out, offset = [], 0
    for t in tensors:
        nb = _nbytes(t)
        out.append(recv[offset:offset + nb].clone().view(t.dtype).view(t.shape))
        offset += nb
    return out


class RingShift(torch.autograd.Function):
    """apply(*tensors): each tensor of the previous rank of the particle row
    (p − 1), this rank's sent to the next (p + 1); the backward sends the
    cotangents of the inputs that take one back to p − 1 and receives
    p + 1's, one message each way."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(_shift(tensors, 1, "ring_shift particle"))

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad  # the same on every rank: their graphs are one program
        sent = iter(_shift([g for g, n in zip(grads, need) if n], -1,
                           "ring_shift particle (backward)"))
        return tuple(next(sent) if n else None for n in need)


def ring_shift(*tensors):
    """The particle row's ring step (`RingShift`); the identity on a row of
    one rank."""
    if _active(PARTICLE) is None:
        return tensors
    return RingShift.apply(*tensors)


# ---------------------------------------------------------------------------
# Reductions over the particle axis K: local ops without a particle mesh
# ---------------------------------------------------------------------------


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis, which a particle mesh splits: a
    max-shifted psum (the reference's `_lse_sharded`), the shift detached;
    `torch.logsumexp` without one."""
    if _active(PARTICLE) is None:
        return torch.logsumexp(x, dim=-1)
    m = pmax(torch.amax(x.detach(), dim=-1))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = psum(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    return torch.log(s) + m


def log_normalize(logw: torch.Tensor):
    """(normalized log-weights, logsumexp) over the last axis
    (`distributions.log_normalize`, with a particle mesh's global sum)."""
    if _active(PARTICLE) is None:
        return _local_log_normalize(logw, dim=-1)
    m = pmax(torch.amax(logw.detach(), dim=-1, keepdim=True))
    lse = torch.log(psum(torch.sum(torch.exp(logw - m), dim=-1, keepdim=True))) + m
    return logw - lse, lse.squeeze(-1)


def weighted_mean(logw: torch.Tensor, x: torch.Tensor, lse=None) -> torch.Tensor:
    """Σ_k softmax(logw)_k x[:, :, k]: logw [B, K], x [B, D, K] -> [B, D].
    Under a particle mesh `lse`, logsumexp(logw) where the caller has it,
    saves its two collectives; without one it is not read."""
    if _active(PARTICLE) is None:
        return torch.einsum("bk,bdk->bd", torch.softmax(logw, dim=-1), x)
    w = torch.exp(logw - (logsumexp(logw) if lse is None else lse)[:, None])
    return psum(torch.einsum("bk,bdk->bd", w, x))


def effective_sample_size(logw: torch.Tensor) -> torch.Tensor:
    """1 / Σ_k W_k² over the last axis (`distributions.effective_sample_size`)."""
    if _active(PARTICLE) is None:
        return _local_ess(logw, dim=-1)
    logw_norm, _ = log_normalize(logw)
    return torch.exp(-logsumexp(2.0 * logw_norm))
