"""Parameters and optimizer state from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter tree with every leaf
already converted to numpy (``jax.tree.map(np.asarray, params)``), so this
module needs no jax.  The tree layout is shared, so keys map one to one.
``opt_state_from_jax`` does the same for the AdamW state, so a state
resumed in both packages matches.
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


def params_from_jax(tree, device="cuda"):
    """numpy tree of the JAX package's params -> the port's params on
    ``device``, each leaf in the dtype of the JAX leaf it comes from (a
    bf16 model keeps its float32 leaves, such as the mamba mixer's
    ``dt_bias``, ``A_log`` and ``D`` and the hybrid mix ``beta``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def opt_state_from_jax(state, device="cuda"):
    """numpy copy of the JAX package's ``AdamState`` (``jax.tree.map(
    np.asarray, opt_state)``: step, mu, nu) -> the port's
    ``optim.adamw.AdamState`` on ``device`` (int32 step, fp32 moments)."""
    from repro_torch.optim.adamw import AdamState
    step, mu, nu = state
    return AdamState(step=_leaf(step, device),
                     mu=params_from_jax(mu, device),
                     nu=params_from_jax(nu, device))
