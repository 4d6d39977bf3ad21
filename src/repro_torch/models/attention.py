"""GQA attention: chunked (flash-style) prefill and single-token decode
against a KV cache, full or sliding-window (a ring of ``window`` slots),
forward only.

The serving path reaches the Hopper kernels through ``kernels.ops``:
prefill attention in ``transformer._attention`` (causal, with the layer's
window if it has one) and decode attention in ``attention_block``.
``chunked_attention`` is the dense online-softmax schedule of the JAX
package's ``_attn_core`` in plain torch; here it serves prefill against an
existing full cache (``q_offset > 0``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import \
    flash_decode_plain as decode_attention  # noqa: F401  (re-export)
from repro_torch.models.layers import (apply_rope, dense_init, pick_chunk,
                                       rms_norm, rope_freqs)

NEG_INF = -1e30


def init_attn_params(gen: torch.Generator, cfg, dtype: torch.dtype, *,
                     lead: tuple = ()) -> dict:
    """Attention weights drawn from ``gen``; ``lead`` stacks them (the
    period axis)."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, dh), dtype, lead=lead),
        "wk": dense_init(gen, (d, hkv, dh), dtype, lead=lead),
        "wv": dense_init(gen, (d, hkv, dh), dtype, lead=lead),
        "wo": dense_init(gen, (h, dh, d), dtype, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h, dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (hkv, dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (hkv, dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (dh,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(lead + (dh,), dtype=dtype, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def project_qkv(params, x, cfg, positions):
    """x: (B,S,d) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh) with rope applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    cos, sin = rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def o_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matmul."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _block_attn(q_blk, k_blk, v_blk, mask, m, l, o):
    """One online-softmax update.  q_blk: (B,cq,Hkv,G,D); k/v:
    (B,ck,Hkv,D); mask: (cq,ck) boolean (True = allowed)."""
    scale = q_blk.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.float(), k_blk.float()) \
        * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.float())
    return m_new, l_new, o * alpha[..., None] + pv


def _attn_core(q, k, v, q_chunk, kv_chunk, q_offset, window):
    """Online-softmax attention, dense schedule: every (q-chunk, kv-chunk)
    pair is computed and masked.  Returns (B,S,H,D) in q.dtype."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    cq = pick_chunk(S, q_chunk)
    ck = pick_chunk(Sk, kv_chunk)
    qr = q.reshape(B, S // cq, cq, Hkv, G, D)
    kr = k.reshape(B, Sk // ck, ck, Hkv, D)
    vr = v.reshape(B, Sk // ck, ck, Hkv, D)
    qpos = q_offset + torch.arange(S, device=q.device).reshape(-1, cq)
    kpos = torch.arange(Sk, device=q.device).reshape(-1, ck)
    outs = []
    for qi in range(S // cq):
        qp = qpos[qi]
        m = torch.full((B, Hkv, G, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, cq), device=q.device)
        o = torch.zeros((B, Hkv, G, cq, D), device=q.device)
        for kj in range(Sk // ck):
            kp = kpos[kj]
            mask = kp[None, :] <= qp[:, None]
            if window:
                mask &= kp[None, :] > qp[:, None] - window
            m, l, o = _block_attn(qr[:, qi], kr[:, kj], vr[:, kj], mask,
                                  m, l, o)
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    # (nq, B, Hkv, G, cq, D) -> (B, S, H, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, D)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, q_chunk: int, kv_chunk: int,
                      q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """Causal flash-style attention, forward only, dense schedule (the
    JAX package's ``binary`` schedule is not ported).

    q: (B,S,H,D), k/v: (B,Sk,Hkv,D).  ``q_offset`` is the absolute position
    of q[0] relative to k[0] (used when a prefix of KV comes from a cache).
    Returns (B,S,H,D).
    """
    return _attn_core(q, k, v, q_chunk, kv_chunk, int(q_offset), window)


def attention_block(params, x, positions, cfg, *, layer_window: int = 0,
                    kv_cache: Optional[Tuple] = None,
                    cache_pos: Optional[int] = None, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """Attention sub-block against a KV cache.  Returns (y, new_kv_cache).

    kv_cache: (k_cache, v_cache) of shape (B, Smax, Hkv, D); cache_pos: the
    absolute position of x[0], a Python int.  Unlike the functional JAX
    version, decode writes the new k/v into the given cache tensors in
    place (no copy of the cache per step) and returns those tensors.
    Decode (S == 1) runs ``ops.flash_decode`` with ``length = cache_pos +
    1``.  With ``layer_window`` the cache is a ring of Smax slots: decode
    writes slot ``cache_pos % Smax`` and attends ``length = min(cache_pos
    + 1, Smax)`` slots (order does not matter to attention), and prefill
    keeps the last Smax keys as new tensors, as the JAX version does.
    """
    if kv_cache is None:
        raise NotImplementedError("training attention comes with the "
                                  "training slice")
    S = x.shape[1]
    cache_pos = int(cache_pos)
    q, k, v = project_qkv(params, x, cfg, positions)
    k_cache, v_cache = kv_cache
    smax = k_cache.shape[1]
    if layer_window:
        if S == 1:  # decode: one slot of the ring
            slot = cache_pos % smax
            k_cache[:, slot:slot + 1] = k.to(k_cache.dtype)
            v_cache[:, slot:slot + 1] = v.to(v_cache.dtype)
            out = ops.flash_decode(q[:, 0], k_cache, v_cache,
                                   min(cache_pos + 1, smax))[:, None]
        else:       # prefill: the ring holds the last smax keys
            k_cache = k[:, -smax:].to(k_cache.dtype)
            v_cache = v[:, -smax:].to(v_cache.dtype)
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=layer_window)
        return o_proj(out, params["wo"]), (k_cache, v_cache)
    k_cache[:, cache_pos:cache_pos + S] = k.to(k_cache.dtype)
    v_cache[:, cache_pos:cache_pos + S] = v.to(v_cache.dtype)
    if S == 1:  # decode
        out = ops.flash_decode(q[:, 0], k_cache, v_cache,
                               cache_pos + 1)[:, None]
    else:       # prefill against the cache
        out = chunked_attention(q, k_cache, v_cache, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, q_offset=cache_pos)
    return o_proj(out, params["wo"]), (k_cache, v_cache)
