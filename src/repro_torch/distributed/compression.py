"""Gradient compression with error feedback, the JAX package's
``repro/distributed/compression.py`` over torch tensors.

int8 block quantization: each gradient leaf is quantized per 256-element
block to int8 with an fp32 scale (about 4x less on the wire than bf16, 8x
than fp32).  ``ef_compress_tree`` applies quantize -> dequantize, so the
optimizer sees exactly the values the wire would deliver;
``ef_compress`` also returns the quantization residual, for error
feedback carried into the next step's gradient.

``compressed_psum`` reduces in the compressed domain over a mesh axis; it
needs the multi-device slice of the port (``ROADMAP.md``, queue 1) and
raises until then.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 blocks (nb, BLOCK), fp32 scales (nb,)).
    Rounds half to even, as ``jnp.round``."""
    blocks = _pad_to_block(x.float()).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)[:, None])
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)


def ef_compress(x: torch.Tensor, err: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize with error feedback.  Returns (compressed value
    in x.dtype, new fp32 error residual)."""
    xf = x.float()
    if err is not None:
        xf = xf + err
    q, s = quantize(xf)
    out = dequantize(q, s, x.shape, torch.float32)
    return out.to(x.dtype), xf - out


def ef_compress_tree(grads: Any) -> Any:
    """Stateless quantize-dequantize over a nested dict of gradients (the
    wire fidelity model); leaves smaller than a block travel
    uncompressed."""
    if isinstance(grads, dict):
        return {k: ef_compress_tree(v) for k, v in grads.items()}
    if grads.numel() < BLOCK:
        return grads
    return ef_compress(grads)[0]


def compressed_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """A psum in the compressed domain over a mesh axis: needs the port's
    multi-device slice (torch.distributed over a device mesh)."""
    raise NotImplementedError(
        "compressed_psum needs a collective over a mesh axis; it comes with "
        "the multi-device slice of the port (ROADMAP.md, queue 1)")


def wire_bytes(x: torch.Tensor) -> int:
    """Bytes on the wire for the compressed representation."""
    nb = (x.numel() + BLOCK - 1) // BLOCK
    return nb * BLOCK + nb * 4
