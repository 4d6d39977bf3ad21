"""Plain-torch oracle for the attention kernels.

Deliberately naive (full materialized softmax): the ground truth the
kernels' plain versions and the model paths are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full materialized-softmax GQA attention.

    q: (B, S, H, D); k/v: (B, Sk, Hkv, D); H % Hkv == 0.  Rows align
    bottom-right when Sk != S (``kpos <= qpos + (Sk - S)``).
    Returns (B, S, H, D) in q.dtype.
    """
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * (D ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos + (Sk - S)
    if window:
        mask &= kpos > qpos + (Sk - S) - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
