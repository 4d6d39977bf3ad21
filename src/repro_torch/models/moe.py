"""Mixture-of-Experts FFN, the local (one-device) path: softmax top-k
routing, capacity-bounded dispatch, per-expert SwiGLU and a gated
combine, as the JAX package's ``_local_moe`` computes it without a mesh.

Tokens routed beyond an expert's capacity C = max(top_k, T * top_k / E *
cf) are dropped (Switch/GShard semantics); slots are assigned in
token-major order over the flattened (T * top_k) assignments, so the same
tokens are dropped as in the reference.  The aux load-balance loss is the
Switch one.  The expert products are plain batched matmuls: the reference
computes them outside any Pallas kernel.

The expert-parallel path (``shard_map`` over a ``model`` mesh axis) comes
with the multi-device slice; ``moe_ffn`` with a mesh raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype: torch.dtype, *,
                    lead: tuple = ()) -> dict:
    """Router (float32 whatever ``dtype`` is, as in the JAX package) and
    the experts' stacked SwiGLU weights, drawn from ``gen``; ``lead``
    stacks them (the period axis)."""
    return {
        "router": dense_init(gen, (d_model, n_experts), torch.float32,
                             lead=lead),
        "w1": dense_init(gen, (n_experts, d_model, d_ff), dtype, lead=lead),
        "w3": dense_init(gen, (n_experts, d_model, d_ff), dtype, lead=lead),
        "w2": dense_init(gen, (n_experts, d_ff, d_model), dtype, lead=lead),
    }


def _local_moe(x, wr, w1, w3, w2, *, n_experts: int, top_k: int,
               capacity: int) -> tuple:
    """x: (T, d) tokens; wr (d, E) fp32; w1/w3 (E, d, f); w2 (E, f, d).
    Returns (y (T, d) in x.dtype, aux loss fp32 scalar)."""
    T, d = x.shape
    # router in fp32: softmax, top-k, gates renormalised
    probs = torch.softmax(x.float() @ wr, dim=-1)            # (T, E)
    gates, eidx = torch.topk(probs, top_k, dim=-1)           # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot within its expert: the running count per expert over the
    # token-major flattened assignments (t0k0, t0k1, ..., t1k0, ...),
    # scanned along the last dimension of the transposed one-hot (a scan
    # over the leading dimension of the tall (T*k, E) tensor runs one CUDA
    # thread per column: 73 of the 94 ms of granite-moe's prefill on an
    # H100)
    e_flat = eidx.reshape(-1)                                 # (T*k,)
    onehot = F.one_hot(e_flat, n_experts)                     # (T*k, E)
    counts = onehot.t().contiguous().cumsum(dim=1).t()
    pos = ((counts - onehot) * onehot).sum(1)
    keep = pos < capacity
    slot = torch.where(keep, e_flat * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))  # dump row

    # Switch aux loss: E * sum_e importance_e * load_e
    load = onehot.sum(0).float() / (T * top_k)
    aux = n_experts * torch.sum(probs.mean(dim=0) * load)

    buf = x.new_zeros((n_experts * capacity + 1, d))
    buf[slot] = x.repeat_interleave(top_k, dim=0)
    expert_in = buf[:-1].reshape(n_experts, capacity, d)
    g = F.silu(torch.bmm(expert_in, w1))
    u = torch.bmm(expert_in, w3)
    eo = torch.bmm(g * u, w2)                                 # (E, C, d)
    out_flat = torch.cat([eo.reshape(n_experts * capacity, d),
                          eo.new_zeros((1, d))], dim=0)

    # gated combine in fp32, one expert slot of each token at a time
    contrib = out_flat[slot].float().reshape(T, top_k, d)
    w = gates * keep.reshape(T, top_k)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(top_k):
        y = y + contrib[:, j] * w[:, j, None]
    return y.to(x.dtype), aux


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float, mesh_args=None) -> tuple:
    """MoE FFN.  x: (B, S, d).  Returns (y (B, S, d), aux scalar).  Only
    the local path is ported: ``mesh_args`` with a mesh raises."""
    if mesh_args is not None and getattr(mesh_args, "mesh", None) is not None:
        raise NotImplementedError(
            "moe_ffn: the expert-parallel path comes with the multi-device "
            "slice; pass mesh_args=None")
    B, S, d = x.shape
    cap = max(top_k, int(B * S * top_k / n_experts * capacity_factor))
    y, aux = _local_moe(x.reshape(B * S, d), params["router"], params["w1"],
                        params["w3"], params["w2"], n_experts=n_experts,
                        top_k=top_k, capacity=cap)
    return y.reshape(B, S, d), aux
