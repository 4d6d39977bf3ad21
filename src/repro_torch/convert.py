"""Parameters from the JAX package into the port.

``params_from_jax`` takes the JAX package's parameter tree with every leaf
already converted to numpy (``jax.tree.map(np.asarray, params)``), so this
module needs no jax.  The tree layout is shared, so keys map one to one.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes.bfloat16: go through float32
        a = a.astype(np.float32)
    # .copy(): JAX buffers are read-only, torch wants a writable array
    t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device="cuda", dtype=torch.float32):
    """numpy tree of the JAX package's params -> the port's params, every
    floating leaf cast to ``dtype`` on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)
