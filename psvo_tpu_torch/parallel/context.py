"""The active mesh (counterpart of `psvo_tpu/parallel/context.py`).

Ranks of the process group stand in for the reference's devices. A mesh is
a (data, particle) grid of the ranks, laid out row-major as the reference's
`make_mesh`: rank r sits at data index r // P and particle index r % P. Its
particle row (the P ranks of one data index) shares a batch shard and splits
the K axis; its data column (the D ranks of one particle index) holds the
same particles of other rows. Each row and each column is a subgroup.

The filter, the objectives and the train step read the active mesh
(`get_mesh`); with none set every path runs unsharded, as before. A caller
makes the mesh (`sharding.make_mesh`) and activates it for a block
(`using`); the sharded train and eval steps do so on each call.

Under a mesh every rank draws the run's global streams from its generator
and keeps its share (`Mesh.local`): its batch rows and, on a particle mesh,
its K / P particles. The draws of a sharded run are therefore those of the
unsharded run on the same seed.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

DATA_AXIS = "data"
PARTICLE_AXIS = "particle"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, particle) grid of the process group."""

    data: int  # D, ranks along the batch axis
    particle: int  # P, ranks along the K axis
    rank: int  # this rank in the process group
    backend: str  # "gloo" or "nccl"
    row_group: object  # process group of this rank's particle row
    col_group: object  # process group of this rank's data column
    row_ranks: tuple  # global ranks of the row, by particle index

    @property
    def size(self) -> int:
        return self.data * self.particle

    @property
    def data_index(self) -> int:
        return self.rank // self.particle

    @property
    def particle_index(self) -> int:
        return self.rank % self.particle

    def group(self, axis: str):
        """The subgroup of `axis` ("particle": the row, "data": the column,
        "world": every rank; None there means the default group)."""
        if axis == PARTICLE_AXIS:
            return self.row_group
        if axis == DATA_AXIS:
            return self.col_group
        if axis == "world":
            return None
        raise ValueError(f"unknown mesh axis {axis!r}")

    def axis_size(self, axis: str) -> int:
        return {PARTICLE_AXIS: self.particle, DATA_AXIS: self.data, "world": self.size}[axis]

    def local(self, t: torch.Tensor, row_dim: Optional[int], particles: bool = False):
        """This rank's share of a global tensor: its rows of dimension row_dim
        (batch B = b·D, or None for a tensor without a batch axis) and, with
        `particles`, its K / P particles of the last dimension. A share is a
        contiguous copy, so that the global draw it came from can be freed."""
        share = t
        if row_dim is not None and self.data > 1:
            b = t.shape[row_dim] // self.data
            share = share.narrow(row_dim, self.data_index * b, b)
        if particles and self.particle > 1:
            ks = t.shape[-1] // self.particle
            share = share.narrow(-1, self.particle_index * ks, ks)
        return t if share is t else share.clone(memory_format=torch.contiguous_format)


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def particle_mesh() -> Optional[Mesh]:
    """The active mesh iff its particle axis is sharded (the reference's
    `objectives._particle_mesh`)."""
    return _MESH if _MESH is not None and _MESH.particle > 1 else None


@contextlib.contextmanager
def using(mesh: Optional[Mesh]):
    """Set `mesh` as the active mesh for a block, then restore the previous."""
    previous = _MESH
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(previous)


def global_rows(batch: int) -> int:
    """The global batch of a rank that holds `batch` rows."""
    return batch * _MESH.data if _MESH is not None else batch


def local_draw(t: torch.Tensor, row_dim: Optional[int], particles: bool) -> torch.Tensor:
    """A global draw's share on this rank (the draw itself without a mesh)."""
    return t if _MESH is None else _MESH.local(t, row_dim, particles)
