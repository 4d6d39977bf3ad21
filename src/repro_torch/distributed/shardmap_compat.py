"""``shard_map`` and its axis-named collectives over ``torch.distributed``,
the port of the JAX package's ``repro/distributed/shardmap_compat.py``.

- ``P`` is a PartitionSpec: one entry per tensor dimension, naming the
  mesh axis it is split over, a tuple of axes (split over their product,
  the first the major one), or None (whole).  ``placements`` translates it
  into the DTensor placements of a ``launch.mesh.Mesh`` (one per mesh
  axis: ``Shard(dim)`` or ``Replicate()``); ``local_slices`` gives the
  block of the global tensor one rank holds.  Shards are even: the
  sharding rules replicate a dimension its axes do not divide.
- A sharded tree is a tree of DTensors: the rank's block as its local
  tensor, the mesh and the placements beside it.  ``distribute`` makes one
  from a global tensor every rank holds, ``gather_full`` the global tensor
  back (through the collectives below, not DTensor's own).
- ``shard_map(f, mesh=, in_specs=, out_specs=)`` runs ``f`` on each rank's
  local blocks with the mesh bound, so that inside ``f`` the collectives
  name axes, as in JAX: ``psum``, ``pmean``, ``all_gather`` (tiled),
  ``axis_index``, ``ppermute``.  Each goes over the process group of its
  axes (``Mesh.group``) and is differentiable with the transpose JAX
  gives it under ``shard_map``: a psum's gradient is the psum of the
  gradients, an all-gather's the reduce-scatter (sum) of them, a
  ppermute's the inverse permutation.  The whole sharded train step is
  one such region (``launch.steps``).
- Each collective is one custom op (``repro_torch::all_reduce``,
  ``::all_gather``, ``::reduce_scatter``, ``::permute``) that takes its
  group's name and size, so a traced step (``make_fx``, the dry run's
  fake process group) holds it as one node; ``COLLECTIVE_OPS`` names the
  HLO collective of each.

Every collective runs on the tensors as they are, but for one: gloo's
send and receive on CUDA tensors, the kind named in ``GLOO_HOST_STAGED``,
which ``_exchange`` (``ppermute``) stages through host memory, as gloo
refuses it on device memory.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

# the collectives the gloo backend takes on host tensors only: on an H100
# with torch 2.11, gloo's point-to-point send and receive refuse CUDA
# memory ("writev ... Bad address"), while all-reduce, all-gather,
# reduce-scatter and barrier give bitwise the host's results
# (scripts/gloo_cuda_probe.py); ``_exchange`` copies a CUDA tensor through
# the host for it
GLOO_HOST_STAGED = frozenset({"send_recv"})
# the reduce-scatter into one tensor: ``reduce_scatter_single`` where this
# torch has it (``reduce_scatter_tensor``, its older name, warns there)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_BOUND: list = []


class P(tuple):
    """A PartitionSpec: ``P("model", None)``, ``P(("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names, in the order it names them."""
    return tuple(a for e in spec for a in entry_axes(e))


def check_spec(spec, mesh, ndim: Optional[int] = None) -> None:
    """A spec names each axis of ``mesh`` at most once, a tuple entry in
    mesh order, and has at most ``ndim`` entries."""
    names = spec_axes(spec)
    if len(set(names)) != len(names):
        raise ValueError(f"{spec}: a mesh axis maps to one dimension at "
                         f"most")
    for e in spec:
        axes = entry_axes(e)
        if axes != mesh.axes(axes):
            raise ValueError(f"{spec}: the axes of {e} are not in mesh "
                             f"order {mesh.axis_names}")
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than {ndim} dims")


def placements(spec, mesh) -> list:
    """DTensor placements (one per mesh axis) of ``spec``."""
    check_spec(spec, mesh)
    out = []
    for a in mesh.axis_names:
        dims = [i for i, e in enumerate(spec) if a in entry_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(t: DTensor) -> P:
    """The spec of a DTensor's placements (mesh-order tuples)."""
    entries: list = [[] for _ in range(t.dim())]
    for a, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(a)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"spec_of: placement {pl} is not a shard or a "
                             f"replica")
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e)
               for e in entries))


def local_slices(shape, spec, mesh, coords: Optional[dict] = None) -> tuple:
    """The block of a ``shape`` tensor the rank at ``coords`` (this rank
    by default) holds under ``spec``."""
    coords = coords if coords is not None else mesh.coords
    out = []
    for i, dim in enumerate(shape):
        axes = entry_axes(spec[i]) if i < len(spec) else ()
        n = 1
        idx = 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def distribute(full: torch.Tensor, spec, mesh) -> DTensor:
    """A DTensor of ``full`` (the same global tensor on every rank) under
    ``spec``: this rank keeps its block (a copy, so ``full`` may go)."""
    block = full[local_slices(full.shape, spec, mesh)].contiguous().clone()
    return DTensor.from_local(block, mesh.device_mesh,
                              placements(spec, mesh), run_check=False,
                              shape=full.shape, stride=full.stride())


def local(t):
    """A DTensor's local block (the same storage); any other tensor as
    it is."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def wrap(block: torch.Tensor, spec, mesh) -> DTensor:
    """A DTensor of this rank's ``block`` under ``spec``."""
    pl = placements(spec, mesh)
    shape = list(block.shape)
    for i, e in enumerate(spec):
        shape[i] *= mesh.axis_size(entry_axes(e))
    return DTensor.from_local(block, mesh.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def like(t: DTensor, block: torch.Tensor) -> DTensor:
    """A DTensor with ``t``'s mesh and placements holding ``block``."""
    return DTensor.from_local(block, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def gather_spec(x: torch.Tensor, spec, keep: tuple = ()) -> tuple:
    """``x`` (a rank's block under ``spec``, inside a bound mesh region)
    gathered over every axis of its spec but those in ``keep`` (kept only
    where an entry names one axis); differentiable.  Returns (the tensor,
    its spec after)."""
    after = []
    for i, e in enumerate(spec):
        axes = entry_axes(e)
        if axes and not (len(axes) == 1 and axes[0] in keep):
            x = all_gather(x, axes, axis=i, tiled=True)
            after.append(None)
        else:
            after.append(e)
    return x, P(*after)


def reshard(x: torch.Tensor, src, dst) -> torch.Tensor:
    """``x`` (a rank's block under spec ``src``, inside a bound mesh
    region) as its block under ``dst``: every dimension whose axes differ
    all-gathered over ``src``'s axes first, then sliced to this rank's
    part along ``dst``'s.  ``x`` itself where the specs agree."""
    mesh = bound()
    pairs = [(entry_axes(src[i]) if i < len(src) else (),
              entry_axes(dst[i]) if i < len(dst) else ())
             for i in range(x.dim())]
    for i, (s, d) in enumerate(pairs):
        if s and s != d:
            x = all_gather(x, s, axis=i, tiled=True)
    for i, (s, d) in enumerate(pairs):
        if d and s != d:
            step = x.shape[i] // mesh.axis_size(d)
            x = x.narrow(i, mesh.axis_index(d) * step, step)
    return x


def gather_full(t, mesh=None) -> torch.Tensor:
    """The global tensor of a DTensor, on every rank (all-gathers over the
    axes of each sharded dimension)."""
    if not isinstance(t, DTensor):
        return t
    with bind(mesh or bound()), torch.no_grad():
        return gather_spec(local(t), spec_of(t))[0]


# ---------------------------------------------------------------------------
# the bound mesh
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def bind(mesh):
    """Bind ``mesh`` for the axis-named collectives inside."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound():
    if not _BOUND:
        raise RuntimeError("no mesh is bound: collectives name axes inside "
                           "shard_map (or distributed.shardmap_compat.bind)")
    return _BOUND[-1]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
# Each collective is a custom op of the port's own: eagerly it makes the
# same ``torch.distributed`` call on the same tensors as a direct call
# would, and a tracer (``make_fx``, ``torch.export``) records it as one
# node that names its group and the group's size, which
# ``core.export.module_from_graph`` maps to the HLO collective the
# reference's partitioned module holds (``COLLECTIVE_OPS``).  The fake
# implementations give the result's shape alone, so a trace on fake
# tensors (the dry run's, over a fake process group) moves no data.
def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


@torch.library.custom_op("repro_torch::all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, group_name: str,
                   group_size: int) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_group(group_name))
    return out


@_all_reduce_op.register_fake
def _(x, group_name, group_size):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, group_name: str,
                   group_size: int) -> torch.Tensor:
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(),
                                group=_group(group_name))
    return out


@_all_gather_op.register_fake
def _(x, group_name, group_size):
    return x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))


@torch.library.custom_op("repro_torch::reduce_scatter", mutates_args=())
def _reduce_scatter_op(x: torch.Tensor, group_name: str,
                       group_size: int) -> torch.Tensor:
    out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
    _reduce_scatter(out, x.contiguous(), group=_group(group_name))
    return out


@_reduce_scatter_op.register_fake
def _(x, group_name, group_size):
    return x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))


@torch.library.custom_op("repro_torch::permute", mutates_args=())
def _permute_op(x: torch.Tensor, group_name: str, group_size: int,
                send_to: int, recv_from: int) -> torch.Tensor:
    return _exchange(x, _group(group_name), None if send_to < 0 else send_to,
                     None if recv_from < 0 else recv_from)


@_permute_op.register_fake
def _(x, group_name, group_size, send_to, recv_from):
    return torch.empty_like(x)


# custom op -> the HLO opcode of the collective it is
COLLECTIVE_OPS = {"repro_torch::all_reduce": "all-reduce",
                  "repro_torch::all_gather": "all-gather",
                  "repro_torch::reduce_scatter": "reduce-scatter",
                  "repro_torch::permute": "collective-permute"}


def _all_reduce(x, group):
    return _all_reduce_op(x, group.group_name, dist.get_world_size(group))


def _gather_dim0(x, group, n):
    return _all_gather_op(x, group.group_name, n)


def _scatter_dim0(x, group, n):
    return _reduce_scatter_op(x, group.group_name, n)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        y = _gather_dim0(x.movedim(dim, 0), group, n)
        return y.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        y = _scatter_dim0(g.movedim(ctx.dim, 0), ctx.group, ctx.n)
        return y.movedim(0, ctx.dim), None, None, None


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over the ranks along ``axes`` (a name or a tuple); every rank
    gets the sum."""
    mesh = bound()
    if mesh.axis_size(axes) == 1:
        return x
    return _Psum.apply(x, mesh.group(axes))


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    n = bound().axis_size(axes)
    return x if n == 1 else psum(x, axes) / n


def all_gather(x: torch.Tensor, axes, *, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along dimension ``axis`` (``tiled``),
    in the order of their coordinate along ``axes``; untiled stacks them
    on a new leading ``axis``."""
    mesh = bound()
    n = mesh.axis_size(axes)
    if not tiled:
        x = x.unsqueeze(axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.group(axes), n, axis)


def axis_index(axes) -> int:
    """This rank's coordinate along ``axes``."""
    return bound().axis_index(axes)


def _exchange(x: torch.Tensor, group, send_to: Optional[int],
              recv_from: Optional[int]) -> torch.Tensor:
    """Send ``x`` to one group rank and receive a tensor like it from
    another (either may be None); a rank that receives nothing gets
    zeros.  Gloo on CUDA tensors stages it through host memory
    (``GLOO_HOST_STAGED``)."""
    if x.is_cuda and "send_recv" in GLOO_HOST_STAGED and \
            dist.get_backend(group) == "gloo":
        return _exchange(x.cpu(), group, send_to, recv_from).to(x.device)
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _permute(x, group, me: int, perm) -> torch.Tensor:
    """``x`` sent along ``perm`` from this rank (``me``) through the
    permute op (-1: no peer)."""
    dst = dict(perm).get(me, -1)
    src = {d: s for s, d in perm}.get(me, -1)
    return _permute_op(x, group.group_name, dist.get_world_size(group), dst,
                       src)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, perm):
        ctx.group, ctx.me, ctx.perm = group, me, perm
        return _permute(x, group, me, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.group, ctx.me, inv), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm: Sequence) -> torch.Tensor:
    """Send ``x`` along ``axis`` by ``perm`` ((source, destination) pairs
    of coordinates); a rank no pair sends to gets zeros."""
    mesh = bound()
    perm = tuple((int(s), int(d)) for s, d in perm)
    if mesh.axis_size(axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh.group(axis), mesh.axis_index(axis), perm)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
def _is_leaf(t) -> bool:
    return isinstance(t, torch.Tensor)


def _map(fn, tree, spec):
    """``fn(leaf, spec)`` over a tree; ``spec`` is a P for every leaf
    below it (a prefix) or a tree of the same structure."""
    if isinstance(spec, P) or spec is None:
        if isinstance(tree, dict):
            return {k: _map(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not _is_leaf(tree):
            return type(tree)(_map(fn, v, spec) for v in tree)
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: _map(fn, v, spec[k]) for k, v in tree.items()}
    return type(tree)(_map(fn, v, s) for v, s in zip(tree, spec))


def to_local(t, spec, mesh):
    """This rank's block of ``t`` under ``spec``: a DTensor's local
    tensor (its placements must be ``spec``'s), or the block of a global
    tensor."""
    if t is None or not isinstance(t, torch.Tensor):
        return t
    spec = P(*(spec or ()))
    if isinstance(t, DTensor):
        if list(t.placements) != placements(spec, mesh):
            raise ValueError(f"shard_map: an input placed "
                             f"{tuple(t.placements)} where {spec} is asked")
        return t.to_local()
    return t[local_slices(t.shape, spec, mesh)]


def shard_map(f: Callable, *, mesh, in_specs, out_specs) -> Callable:
    """``f`` over each rank's blocks of its inputs (``in_specs``: one spec,
    or a tree of specs, per argument), with ``mesh`` bound; the outputs
    are this rank's blocks under ``out_specs``, returned as DTensors."""
    def run(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) and \
            not isinstance(in_specs, P) else (in_specs,)
        loc = [_map(lambda t, s: to_local(t, s, mesh), a, s)
               for a, s in zip(args, specs)]
        with bind(mesh):
            out = f(*loc)
        return _map(lambda t, s: wrap(t, P(*(s or ())), mesh), out,
                    out_specs)
    return run


def tree_specs(tree: Any) -> Any:
    """The spec of every DTensor leaf of a tree (P() for other tensors)."""
    if isinstance(tree, dict):
        return {k: tree_specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_specs(v) for v in tree))
    return spec_of(tree) if isinstance(tree, DTensor) else P()
