"""Sharding rules: parameter, optimizer, batch and cache specs for a
device mesh, the JAX package's ``repro/distributed/sharding.py``.

Strategy ``tp`` (default): megatron-style tensor parallel over ``model``
(q heads, ffn hidden, vocab, experts), FSDP over ``data`` on the
complementary matrix dim, batch over (``pod``, ``data``).

Strategy ``fsdp``: ZeRO-3, batch over every axis, each parameter sharded
over ("data", "model") on its largest divisible dim, no tensor
parallelism.

Strategy ``dp_only``: parameters replicated, batch over every axis.

A sharding is ``Sharding(mesh, spec)``, the counterpart of
``NamedSharding``: ``spec`` is a ``shardmap_compat.P`` and
``placements`` its DTensor placements.  The rules match leaves by their
path in the tree (``repro_torch.tree``: the keys from the root, which the
reference joins with ``/``).  Explicit shardings must divide exactly, so a
dimension its axes do not divide is replicated (the divisibility guard).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.distributed.shardmap_compat import (P, check_spec,
                                                     placements)
from repro_torch.models.moe import MoEMeshArgs
from repro_torch.tree import map_with_paths


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec (a leaf of the trees of shardings below)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def _sharding(mesh, spec: P, ndim: int) -> Sharding:
    check_spec(spec, mesh, ndim)
    return Sharding(mesh, spec)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any
    dp_axes: Tuple[str, ...]
    fsdp_axis: Optional[str]
    model_axis: Optional[str]
    strategy: str = "tp"
    moe_weight_mode: str = "gather"   # gather | stationary (see moe.py)

    def moe_args(self) -> Optional[MoEMeshArgs]:
        if self.mesh is None:
            return None
        if self.strategy == "dp_only" or self.model_axis is None:
            return None
        return MoEMeshArgs(self.mesh, self.dp_axes, self.fsdp_axis,
                           self.model_axis,
                           weight_mode=self.moe_weight_mode)

    def batch_spec(self) -> P:
        if self.strategy == "dp_only":
            axes = tuple(self.dp_axes) + ((self.model_axis,)
                                          if self.model_axis else ())
            return P(axes)
        return P(tuple(self.dp_axes))

    def batch_axes(self) -> tuple:
        """The mesh axes the batch dimension is split over."""
        return tuple(self.batch_spec()[0])


def make_plan(mesh, *, multi_pod: bool = False, strategy: str = "tp",
              moe_weight_mode: str = "gather") -> ShardingPlan:
    if mesh is None:
        return ShardingPlan(None, (), None, None, strategy)
    names = mesh.axis_names
    if strategy == "fsdp":
        dp = tuple(a for a in ("pod", "data", "model") if a in names)
        return ShardingPlan(mesh, dp, None, None, strategy)
    dp = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    fsdp = "data" if "data" in names and mesh.shape.get("data", 1) > 1 \
        else None
    return ShardingPlan(mesh, dp or names[:1], fsdp, model, strategy,
                        moe_weight_mode)


# --------------------------------------------------------------------------
# Parameter specs, by tree-path matching
# --------------------------------------------------------------------------
def _param_spec(path: tuple, ndim: int, plan: ShardingPlan) -> P:
    if plan.strategy == "dp_only":
        return P()
    f = plan.fsdp_axis
    m = plan.model_axis
    leaf = path[-1]
    stacked = path[0] == "layers"
    pre: Tuple = (None,) if stacked else ()

    def spec(*s):
        full = pre + s
        assert len(full) == ndim, (path, ndim, full)
        return P(*full)

    if path == ("embed",):
        return P(m, f)
    if path == ("unembed",):
        return P(f, m)
    if leaf in ("final_norm", "ln1", "ln2", "out_norm", "b", "b_if", "beta",
                "dt_bias", "A_log", "D", "q_norm", "k_norm"):
        return P(*([None] * ndim))
    if leaf in ("wq", "wk", "wv") and ndim == 4:       # (P, d|i, H, Dh)
        return spec(f, m, None)
    if leaf == "wo":                                   # (P, H, Dh, d)
        return spec(m, None, f)
    if leaf in ("bq", "bk", "bv"):                     # (P, H, Dh)
        return spec(m, None)
    if leaf in ("w1", "w3"):
        if ndim == 4:                                  # moe (P, E, d, f)
            if plan.moe_weight_mode == "stationary":
                return spec(m, None, f)                # f-dim sharded
            return spec(m, f, None)
        return spec(f, m)                              # dense (P, d, f)
    if leaf == "w2":
        if ndim == 4:                                  # moe (P, E, f, d)
            if plan.moe_weight_mode == "stationary":
                return spec(m, f, None)
            return spec(m, None, f)
        return spec(m, f)                              # dense (P, f, d)
    if leaf == "router":                               # (P, d, E)
        return spec(None, None)
    if leaf in ("up_proj", "in_proj", "wx", "up1", "up2"):  # (P, d, inner)
        return spec(f, m)
    if leaf in ("down_proj", "out_proj", "down"):      # (P, inner, d)
        return spec(m, f)
    if leaf == "r":                                    # (P, nh, dh, 4dh)
        return spec(m, None, None)
    if leaf == "conv":                                 # (P, w, inner)
        return spec(None, m)
    if leaf in ("wBC", "wdt"):                         # (P, inner, k)
        return spec(m, None)
    if leaf == "wif":                                  # (P, inner, nh, 2)
        return spec(f, m, None)
    return P(*([None] * ndim))


def _fsdp_spec(path: tuple, shape, plan: ShardingPlan) -> P:
    """ZeRO-3 rule: shard the largest divisible dim over ("data","model")
    combined; fall back to a single axis; else replicate.  The stacked
    period dim of layer params (dim 0) is never sharded."""
    sizes = dict(plan.mesh.shape)
    combined = tuple(a for a in ("data", "model") if a in sizes)
    n_comb = int(np.prod([sizes[a] for a in combined]))
    stacked = path[0] == "layers"
    dims = list(enumerate(shape))
    if stacked:
        dims = dims[1:]
    dims.sort(key=lambda kv: -kv[1])
    for axes, n in ((combined, n_comb),) + tuple(
            ((a,), sizes[a]) for a in combined):
        for i, d in dims:
            if n > 1 and d % n == 0:
                spec = [None] * len(shape)
                spec[i] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return P(*([None] * len(shape)))


def _divisible(spec, shape, sizes) -> P:
    """``spec`` with every entry its axes do not divide replaced by None."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            fixed.append(None)
            continue
        n = np.prod([sizes[a] for a in (ax if isinstance(ax, tuple)
                                        else (ax,))])
        fixed.append(ax if dim % n == 0 else None)
    return P(*fixed)


def param_shardings(params_shape, cfg, plan: ShardingPlan):
    """Map a params tree (tensors, meta tensors or numpy arrays: anything
    with a ``shape``) to Shardings (None leaves without a mesh)."""
    if plan.mesh is None:
        return map_with_paths(lambda p, _: None, params_shape)
    if plan.strategy == "fsdp":
        return map_with_paths(
            lambda p, leaf: _sharding(
                plan.mesh, _fsdp_spec(p, leaf.shape, plan), len(leaf.shape)),
            params_shape)
    sizes = dict(plan.mesh.shape)

    def one(path, leaf):
        spec = _param_spec(path, len(leaf.shape), plan)
        return _sharding(plan.mesh, _divisible(spec, leaf.shape, sizes),
                         len(leaf.shape))
    return map_with_paths(one, params_shape)


def batch_shardings(batch_shape, plan: ShardingPlan):
    if plan.mesh is None:
        return map_with_paths(lambda p, _: None, batch_shape)
    bs = plan.batch_spec()
    sizes = dict(plan.mesh.shape)
    n_dp = int(np.prod([sizes[a] for a in (bs[0] if isinstance(bs[0], tuple)
                                           else (bs[0],))])) if bs else 1

    def spec(_, leaf):
        if len(leaf.shape) == 0 or leaf.shape[0] % n_dp != 0:
            return Sharding(plan.mesh, P())   # tiny batch: replicate
        extra = (None,) * (len(leaf.shape) - 1)
        return _sharding(plan.mesh, P(*(tuple(bs) + extra)),
                         len(leaf.shape))
    return map_with_paths(spec, batch_shape)


def cache_shardings(cache_shape, cfg, plan: ShardingPlan,
                    kv_seq_axis: Optional[str] = None):
    """Cache tree: (period, B, ...) leaves, batch over dp.

    ``kv_seq_axis``: optionally shard the KV-cache sequence dim over this
    axis (flash-decode style).
    """
    if plan.mesh is None:
        return map_with_paths(lambda p, _: None, cache_shape)
    bs = plan.batch_spec()
    dp = bs[0] if len(bs) else None
    m = plan.model_axis if plan.strategy != "dp_only" else None
    sizes = dict(plan.mesh.shape)

    n_dp = 1
    for a in (dp if isinstance(dp, tuple) else (dp,) if dp else ()):
        n_dp *= sizes.get(a, 1)
    ms = sizes.get(m, 1) if m else 1

    def spec(path, leaf):
        name = path[-1]
        nd = len(leaf.shape)
        if name in ("k", "v") and nd == 5:     # (Pd, B, S, Hkv, Dh)
            hkv, smax = leaf.shape[3], leaf.shape[2]
            if kv_seq_axis and smax % sizes.get(kv_seq_axis, 1) == 0:
                s = P(None, dp, kv_seq_axis, None, None)
            elif m and hkv % ms == 0:
                s = P(None, dp, None, m, None)
            elif m and smax % ms == 0:
                # flash-decode style: shard cache sequence over model
                s = P(None, dp, m, None, None)
            else:
                s = P(None, dp, None, None, None)
        elif name == "ssm" and nd == 5:        # (Pd, B, nh, hd, st)
            s = P(None, dp, m, None, None)
        elif name == "conv" and nd == 4:       # (Pd, B, w, inner)
            s = P(None, dp, None, m)
        elif name == "H" and nd == 5:          # (Pd, B, nh, dqk, dv+1)
            s = P(None, dp, m, None, None)
        elif nd >= 2:
            s = P(None, dp)
        else:
            s = P(None)
        dims = list(s)
        for i, ax in enumerate(dims):
            if ax is None:
                continue
            if isinstance(ax, tuple):
                if leaf.shape[i] % n_dp != 0:
                    dims[i] = None
            elif leaf.shape[i] % sizes.get(ax, 1) != 0:
                dims[i] = None
        return _sharding(plan.mesh, P(*dims), nd)

    return map_with_paths(spec, cache_shape)


def opt_shardings(opt_shape, params_sharding, *,
                  zero1_axis: Optional[str] = None):
    """AdamState(step, mu, nu): mu/nu mirror params, step replicated.

    ``zero1_axis``: opt-in ZeRO-1, mu/nu additionally shard their largest
    still-unsharded divisible dim over that axis (specs only: the port's
    train step keeps the moments in the parameters' layout, as the
    reference's ``train`` does)."""
    from repro_torch.optim.adamw import AdamState
    from repro_torch.tree import leaves
    mesh = None
    for s in leaves(params_sharding):
        if s is not None:
            mesh = s.mesh
            break
    step_s = Sharding(mesh, P()) if mesh is not None else None
    mom = params_sharding
    if mesh is not None and zero1_axis in mesh.axis_names \
            and mesh.shape[zero1_axis] > 1:
        n_z = mesh.shape[zero1_axis]

        def zshard(path, shape_leaf):
            sharding = _at(params_sharding, path)
            spec = list(sharding.spec) + [None] * (
                len(shape_leaf.shape) - len(sharding.spec))
            cands = sorted(
                ((d, i) for i, (d, ax) in
                 enumerate(zip(shape_leaf.shape, spec))
                 if ax is None and d % n_z == 0),
                reverse=True)
            if cands:
                spec[cands[0][1]] = zero1_axis
            return _sharding(mesh, P(*spec), len(shape_leaf.shape))

        mom = map_with_paths(zshard, opt_shape.mu)
    return AdamState(step=step_s, mu=mom, nu=mom)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def shard_tree(tree, shardings):
    """A tree of global tensors (the same on every rank) as DTensors under
    ``shardings`` (a matching tree; None leaves stay as they are)."""
    from repro_torch.distributed.shardmap_compat import distribute

    def one(path, t):
        s = _at(shardings, path)
        return t if s is None else distribute(t, s.spec, s.mesh)
    return map_with_paths(one, tree)

