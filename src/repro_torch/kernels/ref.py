"""Plain-torch oracles for the kernels.

Deliberately naive (full materialized softmax; per-timestep sequential
SSM scan): the ground truth the kernels' plain versions and the model
paths are held against.
"""
from __future__ import annotations

from typing import Optional

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


def ssm_scan_ref(xv: torch.Tensor, logdecay: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> tuple:
    """Sequential (per-timestep) selective-SSM scan, SSD convention.

    xv:       (B, S, nh, hd)   values (dt folded in)
    logdecay: (B, S, nh)       log decay per step (<= 0)
    Bmat:     (B, S, st)       input projection (shared across heads)
    Cmat:     (B, S, st)       output projection
    h0:       (B, nh, hd, st)  initial state or None

    h[t] = exp(logdecay[t]) * h[t-1] + outer(xv[t], B[t])
    y[t] = h[t] @ C[t]
    Returns (y (B,S,nh,hd) in xv.dtype, h_final (B,nh,hd,st) fp32).
    """
    B, S, nh, hd = xv.shape
    st = Bmat.shape[-1]
    if h0 is None:
        h = torch.zeros((B, nh, hd, st), dtype=torch.float32,
                        device=xv.device)
    else:
        h = h0.float()
    ys = []
    for t in range(S):
        h = h * torch.exp(logdecay[:, t].float())[:, :, None, None]
        h = h + torch.einsum("bhd,bs->bhds", xv[:, t].float(),
                             Bmat[:, t].float())
        ys.append(torch.einsum("bhds,bs->bhd", h, Cmat[:, t].float()))
    return torch.stack(ys, dim=1).to(xv.dtype), h


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ig: torch.Tensor, fg: torch.Tensor, state=None) -> tuple:
    """Sequential mLSTM oracle (normaliser-augmented state), matching
    ``models.xlstm`` semantics: ``mlstm_decode`` step by step.
    q/k: (B,S,nh,dqk); v: (B,S,nh,dv); ig/fg: (B,S,nh) raw gate
    pre-activations; state (H (B,nh,dqk,dv+1), m (B,nh)) or None.
    Returns (h (B,S,nh,dv) in q.dtype, (H, m))."""
    from repro_torch.models.xlstm import mlstm_decode
    B, S, nh, dqk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = (torch.zeros((B, nh, dqk, dv + 1), dtype=torch.float32,
                             device=q.device),
                 torch.full((B, nh), float("-inf"), dtype=torch.float32,
                            device=q.device))
    hs = []
    for t in range(S):
        h, state = mlstm_decode(q[:, t], k[:, t], v[:, t], ig[:, t],
                                fg[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state
