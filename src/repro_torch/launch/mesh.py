"""Device meshes over ``torch.distributed``, the JAX package's
``repro/launch/mesh.py``, and the process-group bootstrap every
multi-rank entry point shares.

A ``Mesh`` names the axes of a grid of ranks (``("data", "model")``),
row-major over the world's ranks, as ``jax.make_mesh`` lays devices out.
It holds a ``torch.distributed`` ``DeviceMesh`` of the same shape, whose
placements the port's sharded trees (DTensors) carry, and a collective
over ``"model"`` or over ``("data", "model")`` runs on the group of the
ranks that differ only along those axes: the ``DeviceMesh``'s group of
the one axis, or a group over several axes made the first time a
collective names them.  An abstract mesh (shape and
names, no ranks) is enough to compute sharding specs
(``distributed.sharding``, ``launch.specs``).

Functions, not module-level constants: importing this module touches no
process group and no device.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def init_process(backend: Optional[str] = None, *, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 init_method: Optional[str] = None, device="cuda",
                 timeout_s: float = 600.0) -> tuple:
    """Join the default process group once per process.  Rank and world
    come from the caller or, when it gives none, from the environment
    torchrun sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  ``backend`` defaults to NCCL for a CUDA device and
    gloo otherwise.  On CUDA the rank's device is ``LOCAL_RANK`` modulo
    the cards there are.  Returns (rank, world size)."""
    dev = torch.device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if world_size is None:
        raise ValueError("init_process: a rank needs a world size")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


class Mesh:
    """A named grid of ranks.  ``shape`` maps each axis name to its size
    (an ordered dict, as ``jax.sharding.Mesh.shape``); ``axis_names`` is
    the axes in order.  A mesh made with ``abstract=True`` has no ranks,
    groups or device: it serves the sharding specs alone."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None, *, abstract: bool = False):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        self.shape = OrderedDict(zip(axis_names, map(int, shape)))
        self.axis_names = tuple(axis_names)
        self.size = math.prod(self.shape.values())
        self.device = None if abstract else torch.device(device)
        self.rank = None
        self.coords = None
        self.device_mesh = None
        self._groups = {}
        if abstract:
            return
        if not dist.is_initialized():
            raise RuntimeError("Mesh: join a process group first "
                               "(launch.mesh.init_process)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {dict(self.shape)} needs {self.size} "
                             f"ranks; the world has {world}")
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names, self._unravel(self.rank)))
        from torch.distributed.device_mesh import DeviceMesh
        self.device_mesh = DeviceMesh(
            self.device.type,
            torch.arange(world).reshape(list(self.shape.values())),
            mesh_dim_names=self.axis_names)

    def _unravel(self, rank: int) -> tuple:
        out = []
        for n in reversed(list(self.shape.values())):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def axes(self, names) -> tuple:
        """An axis name or a tuple of them as a tuple in mesh order."""
        names = (names,) if isinstance(names, str) else tuple(names or ())
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_size(self, names) -> int:
        return math.prod(self.shape[a] for a in self.axes(names))

    def axis_index(self, names) -> int:
        """This rank's coordinate along ``names`` (row-major over a tuple
        of axes)."""
        idx = 0
        for a in self.axes(names):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, names):
        """The process group of the ranks that differ from this one only
        along ``names`` (axes of size 1 aside).  A group over several axes
        is made on first use, on every rank at once: the collectives that
        name it run on all ranks, in one order, as ``new_group`` needs."""
        axes = tuple(a for a in self.axes(names) if self.shape[a] > 1)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            others = [a for a in self.axis_names if a not in axes]
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                ranks = [r for r in range(self.size)
                         if all(self._unravel(r)[self.axis_names.index(a)]
                                == c for a, c in zip(others, fixed))]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axes] = group
        return self._groups[axes]

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """A mesh of ``shape`` over the world's ranks, on ``device`` (each
    rank's CUDA device by default; ``"cpu"`` for gloo on the host)."""
    return Mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): only in a world of that many ranks; raises
    otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), device="cpu"):
    """Tiny mesh for CPU tests.  A one-rank mesh joins a one-process gloo
    group of its own when the process has none."""
    if not dist.is_initialized() and math.prod(shape) == 1:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh(shape, axes, device)


def abstract_mesh(shape, axes) -> Mesh:
    """Shape and axis names only (no ranks): for sharding specs."""
    return Mesh(shape, axes, abstract=True)
