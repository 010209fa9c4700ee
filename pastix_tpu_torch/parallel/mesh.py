"""Mesh helpers (counterpart of ``pastix_tpu/parallel/mesh.py``) and the
collectives the level bodies call.

The reference's mesh is a ``jax.sharding.Mesh`` whose ``shard_map``
bodies run once per device; the port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the current process
group, whose bodies run once per rank (process).  ``lax.psum`` becomes
:func:`all_reduce` and ``lax.all_gather`` :func:`all_gather` over the
axis's group (``mesh.get_group("tp")``).  The backend is the caller's:
NCCL with one card per rank, gloo on the CPU or on CUDA tensors of ranks
that share a card.  The collectives pick their form from the group's
backend (gloo gathers into a list), never from a caught error.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

# one DeviceMesh per (shape, names, device type) and process group: a
# mesh makes a process group per axis, collectively, so every rank makes
# the same ones in the same order and a solver reuses them
_MESHES: dict = {}


def world_size() -> int:
    """The current process group's size (0 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 0


def check_world(shape) -> int:
    """The rank count of ``shape``; ``ValueError`` naming both numbers
    when no process group is initialized or its size differs (the
    reference's ``mesh_shape ... needs N devices``)."""
    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape))
    have = world_size()
    if have != need:
        raise ValueError(
            f"mesh_shape {shape} needs a process group of {need} ranks, but "
            + (f"the current one has {have}" if have else
               "no process group is initialized (torch.distributed."
               "init_process_group, or parallel.launch.run_ranks)"))
    return need


def make_mesh(shape=None, axis_names=("dp", "tp"), device_type=None):
    """A ``DeviceMesh`` of ``shape`` over the current process group, its
    axes named ``axis_names[:len(shape)]``; ``shape=None``: every rank on
    one ``tp`` axis under a ``dp`` axis of 1, as the reference's.
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu`` (gloo
    carries CUDA tensors as well: the mesh's device type only names the
    backend's home)."""
    if shape is None:
        shape = (1, world_size())
    shape = tuple(int(s) for s in shape)
    n = check_world(shape)
    names = tuple(axis_names[: len(shape)])
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (shape, names, device_type, id(dist.group.WORLD))
    if key not in _MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _MESHES[key] = DeviceMesh(device_type,
                                  torch.arange(n).reshape(shape),
                                  mesh_dim_names=names)
    return _MESHES[key]


class Axis:
    """One mesh axis (``mesh.get_group(name)``, or a process ``group``)
    as the level bodies see it: ``size``, this rank's index ``me`` on it
    (``lax.axis_index``) and its collectives.  ``Axis()``, with no
    group, is that of one process and runs none; a process group runs
    every collective, one of a single rank too."""

    def __init__(self, mesh=None, name=None, group=None):
        if mesh is not None and name is not None:
            group = mesh.get_group(name)
        if group is None:
            self.group, self.size, self.me = None, 1, 0
        else:
            self.group = group
            self.size = dist.get_world_size(group)
            self.me = dist.get_rank(group)
        self.nccl = (self.group is not None
                     and dist.get_backend(self.group) == "nccl")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum over the axis, in place on ``t``."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather(t, axis=0)``: (size, *t.shape), every rank's
        ``t`` (of one shape on every rank) in rank order."""
        t = t.contiguous()
        if self.group is None:
            return t[None]
        if self.nccl:
            out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)


def world() -> Axis:
    """Every rank of the current process group as one axis."""
    return Axis(group=dist.group.WORLD)


def rank_device(device=None) -> torch.device:
    """A rank's device: ``device``, or with None its card,
    ``cuda:LOCAL_RANK`` (``torchrun`` and ``launch.run_ranks`` set it),
    else ``cuda:(rank % device_count())``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return torch.device("cuda")  # resolve_device raises on it
    import os

    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else dist.get_rank()
    return torch.device("cuda", idx % torch.cuda.device_count())
