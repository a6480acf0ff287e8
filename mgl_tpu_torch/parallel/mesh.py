"""The ('dp', 'hp') mesh of ranks for multi-process runs.

The port of ``mgl_tpu/parallel/mesh.py``: data-parallel reads ('dp'),
haplotype-parallel likelihood columns ('hp').  The JAX package lays many
devices of one process out as ``reshape(n_dp, n_hp)``; here one rank is
one process on one device (PyTorch's idiom), and rank r sits at
``(r // n_hp, r % n_hp)``, the same layout.  The collectives run on
``torch.distributed``: NCCL between cards, gloo between CPU processes.

A mesh carries its device and, for each axis, the group of ranks that
share this rank's index on the other axis: the dp group (ranks along dp,
one for each hp index) and the hp group (ranks along hp, one for each dp
index).  Every rank creates every group, in the same order, as
``dist.new_group`` requires.  A 1 x 1 mesh in a process with no process
group is valid: its collectives are identities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mgl_tpu_torch.device import resolve_device

AXES = ("dp", "hp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of an (n_dp, n_hp) mesh."""

    n_dp: int
    n_hp: int
    rank: int
    device: torch.device
    # the process groups of this rank's dp column and hp row; None where
    # the mesh has one rank (no process group)
    groups: dict = dataclasses.field(repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.n_dp, "hp": self.n_hp}

    @property
    def size(self) -> int:
        return self.n_dp * self.n_hp

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.rank // self.n_hp if axis == "dp" else self.rank % self.n_hp

    def group(self, axis: str):
        """The process group of the ranks along ``axis`` that share this
        rank's index on the other axis (None on a one-rank mesh)."""
        return self.groups[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` in this rank's group."""
        if axis == "dp":
            return index * self.n_hp + self.index("hp")
        return self.index("dp") * self.n_hp + index


def make_mesh(n_dp: int | None = None, n_hp: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """Build this rank's ('dp', 'hp') mesh over the process group's ranks;
    ``n_dp`` defaults to all ranks on dp.  With a process group, the device
    follows its backend (NCCL: this process's card; gloo: the CPU); with
    none, the mesh is 1 x 1 on ``device``.  A shape that does not cover the
    world raises ``ValueError``, as the JAX package's does."""
    pg = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if pg else 1
    if n_dp is None:
        n_dp = n // n_hp
    if n_dp * n_hp != n:
        raise ValueError(f"mesh {n_dp}x{n_hp} != {n} devices")
    if not pg:
        return Mesh(n_dp, n_hp, 0, resolve_device(device),
                    {"dp": None, "hp": None})
    backend = dist.get_backend()
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported process group backend {backend!r}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(n_dp, n_hp)
    groups = {}
    # every rank creates every group in the same order
    for h in range(n_hp):
        g = dist.new_group(grid[:, h].tolist())
        if h == rank % n_hp:
            groups["dp"] = g
    for d in range(n_dp):
        g = dist.new_group(grid[d].tolist())
        if d == rank // n_hp:
            groups["hp"] = g
    return Mesh(n_dp, n_hp, rank, dev, groups)


def shard_host_arrays(mesh: Mesh, arrays: dict[str, np.ndarray],
                      axis: str | None) -> dict[str, np.ndarray]:
    """This rank's slice of each host array along its leading dimension:
    the ``mesh.index(axis)``-th of ``mesh.shape[axis]`` equal blocks, or the
    whole array where ``axis`` is None (replicated)."""
    if axis is None:
        return dict(arrays)
    p, i = mesh.shape[axis], mesh.index(axis)
    out = {}
    for k, v in arrays.items():
        if len(v) % p:
            raise ValueError(f"{k}: {len(v)} rows do not split over {p} "
                             f"ranks of {axis!r}")
        per = len(v) // p
        out[k] = v[i * per:(i + 1) * per]
    return out


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The blocks of ``t`` from every rank along ``axis``, concatenated on
    ``dim`` in index order (``t`` itself on a one-rank axis)."""
    if mesh.shape[axis] == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)
