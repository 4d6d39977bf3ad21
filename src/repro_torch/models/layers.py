"""Shared model building blocks: norms, rotary embeddings, gated MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * w


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables for rotary embedding.  positions: (...,S) integer."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv  # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch & heads
        cos_ = cos[None, :, None, :]
        sin_ = sin[None, :, None, :]
    else:               # (B, S, half)
        cos_ = cos[:, :, None, :]
        sin_ = sin[:, :, None, :]
    cos_ = cos_.to(x.dtype)
    sin_ = sin_.to(x.dtype)
    return torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """Gated MLP: silu(x@w1) * (x@w3) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float = 1.0, *, lead: tuple = ()) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) weights of ``lead + shape`` drawn from
    ``gen`` on its device.  ``lead`` are stacking dimensions (the period
    axis of ``transformer.init_params``); the fan-in is taken from
    ``shape`` alone, as the JAX package's per-period ``vmap`` sees it.

    Each slice of ``shape`` is drawn in turn (in row-major order of the
    lead indices) in fp32, scaled in place and copied into the ``dtype``
    output, so the result equals ``torch.stack`` of successive draws of
    ``shape`` and the fp32 transient is one slice, not the whole stack
    (qwen3-32b's stacked ``w1`` is 16.8 GB in bf16, 33.6 GB in fp32).  On
    the meta device nothing is drawn (``launch.specs``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / (fan_in ** 0.5)
    shape, lead = tuple(shape), tuple(lead)
    out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    for part in out.view((-1,) + shape):
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(w.mul_(std))
    return out
