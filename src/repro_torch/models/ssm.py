"""Selective SSM (Mamba-2 / SSD style): chunkwise-parallel training and
prefill, through the SSD-scan kernel or its plain version, and the
O(1)-state recurrent decode step.

Scalar-per-head decay (SSD formulation), so the chunkwise form is a masked
linear-attention product.  ``ssd_chunked`` with ``use_kernel`` is
``kernels.ops.ssm_scan``, which launches the Hopper kernel on CUDA tensors
and runs its plain version on the CPU (differentiable either way, by a
recompute backward); without it, ``ssm_scan_plain`` directly, as the JAX
package's ``use_kernel`` routing.

State convention: h[t] = exp(dt[t]*A) * h[t-1] + dt[t] * outer(x[t], B[t]);
y[t] = h[t] @ C[t] + D * x[t], per head, with B/C shared across heads
(ngroups=1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_scan_plain
from repro_torch.models.layers import dense_init

CONV_W = 4  # depthwise causal conv width


def init_ssm_params(gen: torch.Generator, d_model: int, n_heads: int,
                    head_dim: int, state: int, dtype: torch.dtype, *,
                    lead: tuple = ()) -> dict:
    """Mamba mixer weights drawn from ``gen``; ``dt_bias``, ``A_log`` and
    ``D`` are float32 whatever ``dtype`` is, as in the JAX package.
    ``lead`` stacks them (the period axis)."""
    inner = n_heads * head_dim
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "in_proj": dense_init(gen, (d_model, 2 * inner), dtype, lead=lead),
        "conv": dense_init(gen, (CONV_W, inner), dtype, scale=1.0,
                           lead=lead),
        "wBC": dense_init(gen, (inner, 2 * state), dtype, lead=lead),
        "wdt": dense_init(gen, (inner, n_heads), dtype, lead=lead),
        "dt_bias": torch.zeros(lead + (n_heads,), **f32),
        "A_log": torch.zeros(lead + (n_heads,), **f32),
        "D": torch.ones(lead + (n_heads,), **f32),
        "out_proj": dense_init(gen, (inner, d_model), dtype, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv.  x: (B,S,inner), w: (CONV_W, inner).
    carry: (B, CONV_W-1, inner) previous inputs (decode).  Returns
    (silu(conv), new carry: the last CONV_W-1 inputs)."""
    if carry is None:
        pad = x.new_zeros((x.shape[0], CONV_W - 1, x.shape[2]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out), xp[:, -(CONV_W - 1):]


def ssd_chunked(xv, logdecay, Bmat, Cmat, *, chunk: int,
                h0: Optional[torch.Tensor] = None,
                use_kernel: bool = True) -> tuple:
    """Chunkwise-parallel scan: the SSD-scan kernel through
    ``ops.ssm_scan`` with ``use_kernel``, else its plain version, which
    is for CPU tensors only: on the card the scan is the kernel.  xv
    (B,S,nh,hd) with dt folded in, logdecay (B,S,nh) (<= 0), Bmat/Cmat
    (B,S,st), h0 (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd), h_final
    fp32); the result does not depend on ``chunk``, up to rounding."""
    if use_kernel:
        return ops.ssm_scan(xv, logdecay, Bmat, Cmat, h0, chunk)
    if xv.is_cuda:
        raise ValueError("ssd_chunked: use_kernel=False runs the plain "
                         "scan, which is for CPU tensors; on the card the "
                         "scan is the SSD kernel")
    return ssm_scan_plain(xv, logdecay, Bmat, Cmat, h0, chunk=chunk)


def mamba_forward(params, x, *, n_heads: int, head_dim: int, state: int,
                  chunk: int = 256, ssm_state=None, conv_state=None,
                  use_kernel: bool = True) -> tuple:
    """Full mamba mixer.  x: (B,S,d).  Returns (y, (ssm_state,
    conv_state)).

    For decode (S == 1) pass both states: the step is the O(1) recurrence
    in plain torch.  For prefill and training leave them None: the scan
    runs through ``ssd_chunked`` (the kernel with ``use_kernel``).
    """
    B, S, d = x.shape
    inner = n_heads * head_dim
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xin, new_conv = _causal_conv(xin, params["conv"], conv_state)
    Bmat, Cmat = (xin @ params["wBC"]).chunk(2, dim=-1)
    dt = F.softplus((xin @ params["wdt"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                    # (nh,) negative
    logdecay = dt * a                                  # (B,S,nh) fp32
    xh = xin.reshape(B, S, n_heads, head_dim)
    xv = xh * dt[..., None].to(xh.dtype)

    if S == 1 and ssm_state is not None:
        # recurrent decode step
        h = ssm_state * torch.exp(logdecay)[:, 0, :, None, None]
        h = h + torch.einsum("bhd,bs->bhds", xv[:, 0].float(),
                             Bmat[:, 0].float())
        y = torch.einsum("bhds,bs->bhd", h, Cmat[:, 0].float())
        y = y[:, None].to(x.dtype)                     # (B,1,nh,hd)
        h_fin = h
    else:
        y, h_fin = ssd_chunked(xv, logdecay, Bmat, Cmat, chunk=chunk,
                               h0=ssm_state, use_kernel=use_kernel)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, S, inner) * F.silu(z)
    return y @ params["out_proj"], (h_fin, new_conv)
