"""Mixture-of-Experts FFN, the local (one-device) path: softmax top-k
routing, capacity-bounded dispatch, per-expert SwiGLU and a gated
combine, as the JAX package's ``_local_moe`` computes it without a mesh.

Tokens routed beyond an expert's capacity C = max(top_k, T * top_k / E *
cf) are dropped (Switch/GShard semantics); slots are assigned in
token-major order over the flattened (T * top_k) assignments, so the same
tokens are dropped as in the reference.  The aux load-balance loss is the
Switch one.  The expert products are plain batched matmuls: the reference
computes them outside any Pallas kernel.  The gated combine is one custom
op, ``kernels.ops.moe_combine``: on the CPU the reference's arithmetic,
on the card a kernel whose backward writes each kept slot's gradient once
(``kernels/moe_combine.py``).

Expert parallelism (``mesh_args``) runs the reference's ``shard_map``
path with explicit collectives over a ``model`` mesh axis (DESIGN.md §5):
activations enter replicated over ``model``, so each model shard sees
every local-data token; shard ``i`` owns experts [i*E_loc, (i+1)*E_loc),
keeps only the slots bound for its own experts, and a single psum over
``model`` merges the shards.  Expert weights are FSDP-sharded over
``data`` and all-gathered just in time (``gather``), or stay resident
with their ffn-hidden dim sharded while the tokens are all-gathered and
the partial outputs psum'd over (``fsdp``, ``model``) (``stationary``).
The capacity is per shard, from the tokens a shard routes (``t_loc``),
so with data > 1 it drops other tokens than the one-device path does.

On one device the layer may hold only some of the experts
(``moe_ffn(..., experts=(first, held))``: the device's share of an expert
split, as a rank of the expert-parallel path holds its ``E_loc``): it
routes every token over all ``n_experts``, computes the part of the
result that experts [first, first + held) give, and drops the other
assignments as the mesh path drops those of another shard's experts; no
exchange, and nothing stands in for the absent experts.  The capacity is
the whole layer's, from all T * top_k assignments.

While torch.profiler records (``core.scope.recording()``) every
``_local_moe`` call counts its dispatch into a device-side accumulator,
as ``kernels.ops`` counts launches: the assignments routed to this
shard's experts (T * top_k without a mesh and with every expert held),
those dropped (over their expert's capacity: sent to the dump row), the
largest expert's load and every assignment over all experts (T * top_k).
``dispatch_counts()`` reads them, and is the only place that syncs;
untraced, the path launches nothing for them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import scope
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

# device -> int64 (routed, kept, largest load, routed over every expert):
# sums, sums, a maximum, sums
_COUNTS: dict = {}
_CALLS = {"calls": 0, "capacity": 0}


def _count(mine, keep, counts, capacity: int) -> None:
    """Adds one call's dispatch to its device's accumulator, on the
    device."""
    acc = _COUNTS.get(mine.device)
    if acc is None:
        acc = _COUNTS[mine.device] = torch.zeros(4, dtype=torch.int64,
                                                 device=mine.device)
    acc[:2] += torch.stack((mine.sum(), keep.sum()))
    torch.maximum(acc[2:3], counts[-1].max(), out=acc[2:3])
    acc[3] += mine.numel()
    _CALLS["calls"] += 1
    _CALLS["capacity"] = capacity


def dispatch_counts() -> dict:
    """The MoE dispatch's counts since ``reset_dispatch_counts``, as
    ints: ``calls`` (each ``_local_moe`` call while recording, the
    remat's recompute in the backward included), ``routed`` and
    ``dropped`` assignments summed over the calls (``routed``: to this
    shard's or device's experts), ``routed_all`` every assignment over all
    experts (T * top_k a call), ``max_load`` the largest expert's
    assignments in any one call (before its capacity), ``capacity`` a
    call's slots an expert (the last call's)."""
    out = dict(_CALLS, routed=0, dropped=0, max_load=0, routed_all=0)
    for acc in _COUNTS.values():
        routed, kept, load, routed_all = acc.tolist()
        out["routed"] += routed
        out["routed_all"] += routed_all
        out["dropped"] += routed - kept
        out["max_load"] = max(out["max_load"], load)
    return out


def reset_dispatch_counts() -> None:
    _COUNTS.clear()
    _CALLS.update(calls=0, capacity=0)


class MoEMeshArgs(NamedTuple):
    mesh: object          # launch.mesh.Mesh
    dp_axes: tuple        # axes the batch is sharded over, e.g. ("pod","data")
    fsdp_axis: Optional[str]   # axis expert weights' d_model dim is sharded on
    model_axis: str       # expert-parallel axis
    # "gather": FSDP weights, all-gathered per invocation (training);
    # "stationary": weights resident with the ffn-hidden dim sharded over
    #   fsdp_axis, the token batch all-gathered instead and partial expert
    #   outputs psum'd (decode/serving)
    weight_mode: str = "gather"


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype: torch.dtype, *,
                    lead: tuple = (), held: Optional[int] = None) -> dict:
    """Router (float32 whatever ``dtype`` is, as in the JAX package) over
    all ``n_experts`` and the stacked SwiGLU weights of ``held`` experts
    (by default all), drawn from ``gen``; ``lead`` stacks them (the period
    axis)."""
    e = n_experts if held is None else held
    return {
        "router": dense_init(gen, (d_model, n_experts), torch.float32,
                             lead=lead),
        "w1": dense_init(gen, (e, d_model, d_ff), dtype, lead=lead),
        "w3": dense_init(gen, (e, d_model, d_ff), dtype, lead=lead),
        "w2": dense_init(gen, (e, d_ff, d_model), dtype, lead=lead),
    }


def _local_moe(x, wr, w1, w3, w2, *, n_experts: int, top_k: int,
               capacity: int, e_loc: Optional[int] = None, e_first: int = 0,
               model_axis: Optional[str] = None,
               fsdp_axis: Optional[str] = None, dp_axes: tuple = (),
               weight_mode: str = "gather") -> tuple:
    """Per-shard MoE.  x: (T_loc, d) local tokens; wr (d, E) fp32; expert
    weights the local slices (E_loc, d[/fsdp], f) for "gather", (E_loc, d,
    f/fsdp) for "stationary"; the collectives name axes of the bound mesh
    (``shardmap_compat``).  Without axes it is the one-device MoE, over
    experts [e_first, e_first + e_loc) (by default all of them).
    Returns (y (T_loc, d) in x.dtype, aux loss fp32 scalar)."""
    e_loc = n_experts if e_loc is None else e_loc
    stationary = weight_mode == "stationary" and fsdp_axis is not None
    t_loc = x.shape[0]
    if stationary:
        # weights stay put; the token batch is replicated over the fsdp
        # axis instead, partial f-slices psum'd back at the end
        x = smc.all_gather(x, fsdp_axis, axis=0, tiled=True)
    elif fsdp_axis is not None:
        w1 = smc.all_gather(w1, fsdp_axis, axis=1, tiled=True)
        w3 = smc.all_gather(w3, fsdp_axis, axis=1, tiled=True)
        w2 = smc.all_gather(w2, fsdp_axis, axis=2, tiled=True)
    T, d = x.shape
    # router in fp32: softmax, top-k, gates renormalised
    probs = torch.softmax(x.float() @ wr, dim=-1)            # (T, E)
    gates, eidx = torch.topk(probs, top_k, dim=-1)           # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux loss: E * sum_e importance_e * load_e (every expert)
    load = F.one_hot(eidx.reshape(-1), n_experts).sum(0).float() / (
        T * top_k)
    aux = n_experts * torch.sum(probs.mean(dim=0) * load)

    # this shard's experts; the others' slots go to the dump row
    e0 = smc.axis_index(model_axis) * e_loc if model_axis is not None \
        else e_first
    le = eidx.reshape(-1) - e0                                # (T*k,)
    mine = (le >= 0) & (le < e_loc)
    le = torch.where(mine, le, torch.full_like(le, e_loc))
    # slot within its expert: the running count per expert over the
    # token-major flattened assignments (t0k0, t0k1, ..., t1k0, ...),
    # scanned along the last dimension of the transposed one-hot (a scan
    # over the leading dimension of the tall (T*k, E) tensor runs one CUDA
    # thread per column: 73 of the 94 ms of granite-moe's prefill on an
    # H100)
    onehot = F.one_hot(le, e_loc + 1)[:, :e_loc]              # (T*k, E_loc)
    counts = onehot.t().contiguous().cumsum(dim=1).t()
    pos = ((counts - onehot) * onehot).sum(1)
    keep = mine & (pos < capacity)
    if scope.recording():
        _count(mine, keep, counts, capacity)
    slot = torch.where(keep, le * capacity + pos,
                       torch.full_like(pos, e_loc * capacity))  # dump row

    buf = x.new_zeros((e_loc * capacity + 1, d))
    buf[slot] = x.repeat_interleave(top_k, dim=0)
    expert_in = buf[:-1].reshape(e_loc, capacity, d)
    g = F.silu(torch.bmm(expert_in, w1))
    u = torch.bmm(expert_in, w3)
    eo = torch.bmm(g * u, w2)                                 # (E_loc, C, d)

    # gated combine in fp32, each token's expert slots in order; the dump
    # row adds nothing (one kernel each way on the card)
    y = ops.moe_combine(eo.reshape(e_loc * capacity, d), slot,
                        gates * keep.reshape(T, top_k))
    if stationary:
        # partial f-slices (fsdp) and partial experts (model) merged in
        # one reduction, then this shard's tokens sliced back out
        axes = (fsdp_axis,) + ((model_axis,) if model_axis else ())
        y = smc.psum(y, axes)
        idx = smc.axis_index(fsdp_axis) * t_loc
        y = y[idx:idx + t_loc]
        aux = smc.pmean(aux, tuple(dp_axes) + (
            (model_axis,) if model_axis else ()))
    elif model_axis is not None:
        y = smc.psum(y, model_axis)
        aux = smc.pmean(aux, tuple(dp_axes) + (model_axis,))
    return y.to(x.dtype), aux


def _mesh_layout(mesh_args: MoEMeshArgs, B: int, S: int, d: int, d_ff: int,
                 n_experts: int, top_k: int, capacity_factor: float):
    """The kwargs of ``_local_moe`` on the mesh path, as the reference's
    ``moe_ffn`` sets them up."""
    mesh = mesh_args.mesh
    n_dp = mesh.axis_size(mesh_args.dp_axes)
    n_model = mesh.shape[mesh_args.model_axis]
    t_loc = (B * S) // n_dp
    e_loc = n_experts // n_model
    fsdp = mesh_args.fsdp_axis
    mode = mesh_args.weight_mode
    if mode == "stationary":
        if fsdp is not None and d_ff % mesh.shape[fsdp] != 0:
            fsdp = None     # f not divisible: weights replicate anyway
        n_gather = mesh.shape[fsdp] if fsdp is not None else 1
        cap = max(top_k, int(t_loc * n_gather * top_k / n_experts
                             * capacity_factor))
    else:
        if fsdp is not None and d % mesh.shape[fsdp] != 0:
            fsdp = None  # replicate d when not divisible
        cap = max(top_k, int(t_loc * top_k / n_experts * capacity_factor))
    return dict(n_experts=n_experts, top_k=top_k, capacity=cap, e_loc=e_loc,
                model_axis=mesh_args.model_axis, fsdp_axis=fsdp,
                dp_axes=tuple(mesh_args.dp_axes), weight_mode=mode)


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float, mesh_args=None,
            d_ff: Optional[int] = None,
            experts: Optional[tuple] = None) -> tuple:
    """MoE FFN.  x: (B, S, d).  Returns (y (B, S, d), aux scalar).

    ``experts`` (one device only): (first, held), the experts whose
    weights ``params`` hold (``w1`` etc. of ``held`` experts); the router
    keeps every expert's column, and the result is those experts' part
    (the module docstring).  None: every expert.

    With ``mesh_args`` (a mesh): expert parallelism, the per-shard body of
    the reference's ``shard_map``, on local blocks inside a bound mesh
    region (``distributed.shardmap_compat.shard_map``; the sharded steps
    of ``launch.steps`` are one): x is this rank's rows (B the local
    batch), the weights this rank's blocks in the plan's layout, and
    ``d_ff``, the global ffn width, sets the stationary layout (a local
    weight shows only its slice)."""
    if mesh_args is None or getattr(mesh_args, "mesh", None) is None:
        B, S, d = x.shape
        cap = max(top_k, int(B * S * top_k / n_experts * capacity_factor))
        first, held = experts if experts is not None else (0, n_experts)
        y, aux = _local_moe(x.reshape(B * S, d), params["router"],
                            params["w1"], params["w3"], params["w2"],
                            n_experts=n_experts, top_k=top_k, capacity=cap,
                            e_loc=held, e_first=first)
        return y.reshape(B, S, d), aux
    if experts is not None:
        raise ValueError("moe_ffn: an expert share is for one device; a "
                         "mesh splits the experts itself")
    n_dp = mesh_args.mesh.axis_size(mesh_args.dp_axes)
    b, S, d = x.shape
    if d_ff is None:
        raise ValueError("moe_ffn: local blocks need the global d_ff")
    kw = _mesh_layout(mesh_args, b * n_dp, S, d, d_ff, n_experts, top_k,
                      capacity_factor)
    y, aux = _local_moe(x.reshape(b * S, d), params["router"],
                        params["w1"], params["w3"], params["w2"], **kw)
    return y.reshape(b, S, d), aux
