"""Parameters and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter tree with every leaf
already converted to numpy (``jax.tree.map(np.asarray, params)``), so this
module needs no jax.  The tree layout is shared, so keys map one to one.
``opt_state_from_jax`` does the same for the AdamW state, so a state
resumed in both packages matches.  With a sharding plan each rank keeps
its block of every leaf as a DTensor of the plan's layout
(``distributed.sharding.param_shardings``; the moments mirror the
parameters, the step stays whole), so both packages compute from the
same weights on the same mesh shape.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        # torch.from_numpy rejects ml_dtypes.bfloat16: go through float32,
        # which holds every bf16 value exactly
        a = a.astype(np.float32)
    # .copy(): JAX buffers are read-only, torch wants a writable array
    t = torch.from_numpy(np.array(a, copy=True))
    if bf16:
        t = t.to(torch.bfloat16)
    return t.to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def _shard(tree, device, plan):
    """``tree`` (numpy) as this rank's DTensors under ``plan``: each leaf
    sliced on the host before it goes to ``device``."""
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.distributed import shardmap_compat as smc
    from repro_torch.tree import map_with_paths
    shardings = shard_mod.param_shardings(tree, None, plan)

    def one(path, a):
        s = shardings
        for k in path:
            s = s[k]
        a = np.asarray(a)
        block = _leaf(a[smc.local_slices(a.shape, s.spec, plan.mesh)],
                      device)
        return smc.wrap(block, s.spec, plan.mesh)
    return map_with_paths(one, tree)


def params_from_jax(tree, device="cuda", plan=None):
    """numpy tree of the JAX package's params -> the port's params on
    ``device``, each leaf in the dtype of the JAX leaf it comes from (a
    bf16 model keeps its float32 leaves, such as the mamba mixer's
    ``dt_bias``, ``A_log`` and ``D`` and the hybrid mix ``beta``).  With
    ``plan`` (on a mesh) a tree of DTensors of the plan's layout."""
    if plan is not None and plan.mesh is not None:
        return _shard(tree, device, plan)
    return _tree(tree, device)


def opt_state_from_jax(state, device="cuda", plan=None):
    """numpy copy of the JAX package's ``AdamState`` (``jax.tree.map(
    np.asarray, opt_state)``: step, mu, nu) -> the port's
    ``optim.adamw.AdamState`` on ``device`` (int32 step, fp32 moments);
    with ``plan`` the moments are DTensors in their parameters' layout
    (``opt_shardings`` without ZeRO-1) and the step a whole tensor."""
    from repro_torch.optim.adamw import AdamState
    step, mu, nu = state
    return AdamState(step=_leaf(step, device),
                     mu=params_from_jax(mu, device, plan),
                     nu=params_from_jax(nu, device, plan))
