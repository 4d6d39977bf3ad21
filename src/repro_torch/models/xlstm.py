"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, sequential recurrence).  Training
differentiates both with autograd, as the JAX package differentiates its
own (no custom gradient for either); under remat the sLSTM's time loop
runs again in the backward.

mLSTM cell:  C_t = f_t C_{t-1} + i_t v_t k_t^T ;  n_t = f_t n_{t-1} + i_t k_t
             h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
with exponential input gate i = exp(i~), forget gate f = sigmoid(f~) and
the max-state m_t stabiliser.  The normaliser n rides as an extra "value"
column of the matrix state (state shape (dqk, dv+1)), so the chunkwise
form is one masked linear-attention computation.  The JAX package has no
Pallas kernel for it (``mlstm_forward`` takes ``use_kernel`` and ignores
it), so neither has the port: every product here is a plain torch op.

sLSTM is sequential (h_{t-1} feeds the gate pre-activations through the
recurrent matrix R): a Python loop over time steps, which ``torch.export``
unrolls.

Stabilisers: ``mlstm_chunked`` starts from m = -inf, while the serving
caches (``transformer.init_cache``) and the sLSTM state start at -1e30;
the ``isfinite`` guards are the reference's, one for one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, pick_chunk, rms_norm


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                      dqk: int, dtype: torch.dtype, *,
                      lead: tuple = ()) -> dict:
    """xLSTM block: up-projection x2 (factor 2), conv-less, per-head qkv.
    ``b_if`` is float32 whatever ``dtype`` is, as in the JAX package."""
    inner = 2 * d_model
    dv = inner // n_heads
    dev = gen.device
    return {
        "up_proj": dense_init(gen, (d_model, 2 * inner), dtype, lead=lead),
        "wq": dense_init(gen, (inner, n_heads, dqk), dtype, lead=lead),
        "wk": dense_init(gen, (inner, n_heads, dqk), dtype, lead=lead),
        "wv": dense_init(gen, (inner, n_heads, dv), dtype, lead=lead),
        "wif": dense_init(gen, (inner, n_heads, 2), dtype, lead=lead),
        "b_if": torch.zeros(lead + (n_heads, 2), dtype=torch.float32,
                            device=dev),
        "out_norm": torch.ones(lead + (inner,), dtype=dtype, device=dev),
        "down_proj": dense_init(gen, (inner, d_model), dtype, lead=lead),
    }


def mlstm_chunked(q, k, v, ig, fg, *, chunk: int,
                  state: Optional[Tuple] = None) -> tuple:
    """Chunkwise-parallel mLSTM.

    q,k: (B,S,nh,dqk); v: (B,S,nh,dv); ig/fg: (B,S,nh) raw gate
    pre-activations.  state: (H (B,nh,dqk,dv+1), m (B,nh)) or None.
    Returns (h (B,S,nh,dv) in q.dtype, (H, m) fp32).
    """
    B, S, nh, dqk = q.shape
    dv = v.shape[-1]
    c = pick_chunk(S, chunk)
    n = S // c
    scale = dqk ** -0.5
    f32 = torch.float32
    # normaliser tracked as an extra all-ones value column
    v1 = torch.cat([v.float(), v.new_ones((B, S, nh, 1), dtype=f32)], -1)

    qc = q.reshape(B, n, c, nh, dqk).float() * scale
    kc = k.reshape(B, n, c, nh, dqk).float()
    vc = v1.reshape(B, n, c, nh, dv + 1)
    lf = F.logsigmoid(fg.float()).reshape(B, n, c, nh)
    li = ig.float().reshape(B, n, c, nh)

    cum = torch.cumsum(lf, dim=2)                   # (B,n,c,nh) cumulative logf
    total = cum[:, :, -1]                           # (B,n,nh)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=q.device)

    if state is None:
        H = q.new_zeros((B, nh, dqk, dv + 1), dtype=f32)
        m = torch.full((B, nh), float("-inf"), dtype=f32, device=q.device)
    else:
        H, m = state
        m = torch.where(torch.isfinite(m), m, neg_inf)

    hs, mts = [], []
    for i in range(n):
        q_i, k_i, v_i = qc[:, i], kc[:, i], vc[:, i]
        cum_i, total_i, li_i = cum[:, i], total[:, i], li[:, i]
        # intra-chunk log weights w[t,tau] = cum_t - cum_tau + li_tau
        # (tau <= t)
        dec_i = (cum_i[:, :, None, :] - cum_i[:, None, :, :]
                 + li_i[:, None, :, :])                        # (B,c,c,nh)
        dec_i = torch.where(tri[None, :, :, None], dec_i, neg_inf)
        m_intra = dec_i.amax(dim=2)                            # (B,c,nh)
        # combined stabiliser per row t
        m_inter = cum_i + m[:, None, :]                        # (B,c,nh)
        m_t = torch.maximum(m_intra, m_inter)
        m_t = torch.where(torch.isfinite(m_t), m_t, torch.zeros_like(m_t))
        p = torch.exp(dec_i - m_t[:, :, None, :])              # (B,c,c,nh)
        s = torch.einsum("bthq,bkhq->btkh", q_i, k_i)          # (B,c,c,nh)
        h_intra = torch.einsum("btkh,bkhd->bthd", s * p, v_i)
        w_inter = torch.exp(m_inter - m_t)                     # (B,c,nh)
        h_inter = torch.einsum("bthq,bhqd,bth->bthd", q_i, H, w_inter)
        hs.append(h_intra + h_inter)                           # (B,c,nh,dv+1)
        mts.append(m_t)
        # state update
        m_new = torch.maximum(
            total_i + m, (total_i[:, None, :] - cum_i + li_i).amax(dim=1))
        Hc = torch.einsum("bkhq,bkhd,bkh->bhqd", k_i, v_i, torch.exp(
            total_i[:, None, :] - cum_i + li_i - m_new[:, None, :]))
        H = H * torch.exp(total_i + m - m_new)[:, :, None, None] + Hc
        m = m_new

    h = torch.stack(hs, dim=1).reshape(B, S, nh, dv + 1)
    m_t = torch.stack(mts, dim=1).reshape(B, S, nh)
    num = h[..., :dv]
    den = torch.maximum(h[..., dv].abs(), torch.exp(-m_t))
    return (num / den[..., None]).to(q.dtype), (H, m)


def mlstm_decode(q, k, v, ig, fg, state) -> tuple:
    """One-step recurrent mLSTM.  q/k: (B,nh,dqk); v: (B,nh,dv);
    ig/fg: (B,nh).  state: (H (B,nh,dqk,dv+1), m (B,nh))."""
    H, m = state
    dqk = q.shape[-1]
    lf = F.logsigmoid(fg.float())
    li = ig.float()
    m_new = torch.maximum(lf + m, li)
    m_new = torch.where(torch.isfinite(m_new), m_new, li)
    f_ = torch.exp(lf + m - m_new)
    f_ = torch.where(torch.isfinite(m), f_, torch.zeros_like(f_))
    i_ = torch.exp(li - m_new)
    v1 = torch.cat([v.float(), v.new_ones(v.shape[:-1] + (1,),
                                          dtype=torch.float32)], -1)
    H_new = H * f_[..., None, None] + i_[..., None, None] * torch.einsum(
        "bhq,bhd->bhqd", k.float(), v1)
    hq = torch.einsum("bhqd,bhq->bhd", H_new, q.float() * dqk ** -0.5)
    dv = v.shape[-1]
    num, den = hq[..., :dv], hq[..., dv]
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (H_new, m_new)


def mlstm_forward(params, x, *, n_heads: int, dqk: int, chunk: int = 256,
                  state=None, use_kernel: bool = False) -> tuple:
    """mLSTM block mixer.  x: (B,S,d).  Returns (y, state).  A decode step
    (S == 1 with a state) runs the recurrence, anything else the chunkwise
    form.  ``use_kernel`` is accepted and ignored, as in the JAX package,
    which has no mLSTM kernel."""
    del use_kernel
    B, S, d = x.shape
    inner = 2 * d
    u, gate = (x @ params["up_proj"]).chunk(2, dim=-1)
    q = torch.einsum("bse,ehq->bshq", u, params["wq"])
    k = torch.einsum("bse,ehq->bshq", u, params["wk"])
    v = torch.einsum("bse,ehd->bshd", u, params["wv"])
    if_ = torch.einsum("bse,ehg->bshg", u, params["wif"]).float() \
        + params["b_if"]
    ig, fg = if_[..., 0], if_[..., 1]
    if S == 1 and state is not None:
        h, new_state = mlstm_decode(q[:, 0], k[:, 0], v[:, 0],
                                    ig[:, 0], fg[:, 0], state)
        h = h[:, None]
    else:
        h, new_state = mlstm_chunked(q, k, v, ig, fg, chunk=chunk,
                                     state=state)
    h = h.reshape(B, S, inner)
    h = rms_norm(h, params["out_norm"]) * F.silu(gate)
    return h @ params["down_proj"], new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                      dtype: torch.dtype, *, lead: tuple = ()) -> dict:
    """sLSTM block: input projection, per-head block-diagonal recurrent
    matrix, a gated up/down FFN.  ``b`` is float32 whatever ``dtype`` is,
    as in the JAX package."""
    dh = d_model // n_heads
    # ~4/3 projection factor, rounded up to 64
    f_up = -(-int(d_model * 4 / 3) // 64) * 64
    dev = gen.device
    return {
        "wx": dense_init(gen, (d_model, 4 * d_model), dtype, lead=lead),
        # recurrent block-diagonal per head: (nh, dh, 4*dh)
        "r": dense_init(gen, (n_heads, dh, 4 * dh), dtype, lead=lead),
        "b": torch.zeros(lead + (4 * d_model,), dtype=torch.float32,
                         device=dev),
        "out_norm": torch.ones(lead + (d_model,), dtype=dtype, device=dev),
        "up1": dense_init(gen, (d_model, f_up), dtype, lead=lead),
        "up2": dense_init(gen, (d_model, f_up), dtype, lead=lead),
        "down": dense_init(gen, (f_up, d_model), dtype, lead=lead),
    }


def _slstm_cell(params, xt, state, n_heads: int) -> dict:
    """One sLSTM step.  xt: (B, 4d) pre-activation from W x.
    state: dict(c, n, h, m) each (B, d) fp32."""
    B = xt.shape[0]
    d = xt.shape[-1] // 4
    dh = d // n_heads
    h_heads = state["h"].reshape(B, n_heads, dh)
    rec = torch.einsum("bhe,hef->bhf", h_heads.to(params["r"].dtype),
                       params["r"]).reshape(B, 4 * d)
    pre = (xt + rec).float() + params["b"]
    z, i, f, o = pre.chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    lf = F.logsigmoid(f)
    m_new = torch.maximum(lf + state["m"], i)
    i_ = torch.exp(i - m_new)
    f_ = torch.exp(lf + state["m"] - m_new)
    c_new = f_ * state["c"] + i_ * z
    n_new = f_ * state["n"] + i_
    h_new = o * c_new / n_new.clamp_min(1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_forward(params, x, *, n_heads: int, state=None,
                  time_block: int = 16) -> tuple:
    """sLSTM block mixer (sequential).  x: (B,S,d).  Returns (y, state).

    ``time_block`` is the JAX package's timesteps per scan iteration,
    halved until it divides S; the steps run in the same order in blocks
    of that size (here the blocking changes no result)."""
    B, S, d = x.shape
    if state is None:
        z = x.new_zeros((B, d), dtype=torch.float32)
        state = {"c": z, "n": z, "h": z,
                 "m": torch.full((B, d), -1e30, dtype=torch.float32,
                                 device=x.device)}
    xp = x @ params["wx"]                                     # (B,S,4d)
    k = time_block
    while S % k:
        k //= 2
    hs = []
    for blk in range(S // k):
        for t in range(blk * k, (blk + 1) * k):
            state = _slstm_cell(params, xp[:, t], state, n_heads)
            hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)                    # (B,S,d)
    h = rms_norm(h, params["out_norm"])
    u = F.gelu(h @ params["up1"], approximate="tanh")
    g = h @ params["up2"]
    return (u * g) @ params["down"], state
