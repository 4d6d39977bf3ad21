"""GQA attention: chunked (flash-style) training and prefill, and
single-token decode against a KV cache, full or sliding-window (a ring of
``window`` slots).

The model reaches the Hopper kernels through ``kernels.ops``: prefill
attention in ``transformer._attention`` (causal, with the layer's window
if it has one), decode attention in ``attention_block``, and training
attention in ``attention_block`` with ``use_kernel`` (the flash kernel
forward, its recompute backward).  ``chunked_attention`` is the online-
softmax schedule of the JAX package's ``_attn_core`` in plain torch: it
serves prefill against an existing full cache (``q_offset > 0``),
training without the kernel (on the CPU only), and the kernel's
backward recompute.  Two
causal schedules, as in the reference:

- ``dense``: every (q-chunk, kv-chunk) pair is computed and masked;
- ``binary``: the exact triangle by balanced binary decomposition, the
  strictly-lower triangle of the chunk grid covered by log2(n) levels of
  unmasked squares (level l has 2^l squares of side n/2^(l+1) chunks)
  plus n masked diagonal blocks; it applies when S == Sk, q_offset 0, no
  window, equal chunks and a power-of-two chunk count, and falls back to
  ``dense`` otherwise.

Differentiating the plain schedules is left to autograd (the reference
gives them an O(S)-memory custom VJP; the gradient is the same).
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


def _block_scores(q_blk, k_blk):
    """q_blk: (..., q, Hkv, G, D); k_blk: (..., k, Hkv, D) ->
    (..., Hkv, G, q, k) fp32 scaled scores."""
    scale = q_blk.shape[-1] ** -0.5
    return torch.einsum("...qhgd,...khd->...hgqk", q_blk.float(),
                        k_blk.float()) * scale


def _block_attn(q_blk, k_blk, v_blk, mask, m, l, o):
    """One online-softmax update.  q_blk: (B,cq,Hkv,G,D); k/v:
    (B,ck,Hkv,D); mask: (cq,ck) boolean (True = allowed)."""
    s = _block_scores(q_blk, k_blk)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.float())
    return m_new, l_new, o * alpha[..., None] + pv


def _attn_core(q, k, v, q_chunk, kv_chunk, q_offset, window,
               schedule="dense"):
    """Online-softmax attention.  Returns (B,S,H,D) in q.dtype."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    cq = pick_chunk(S, q_chunk)
    ck = pick_chunk(Sk, kv_chunk)
    nq = S // cq
    if (schedule == "binary" and S == Sk and cq == ck and nq & (nq - 1) == 0
            and q_offset == 0 and not window):
        return _binary_causal(q, k, v, nq, cq)
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


def _merge_stats(m1, l1, o1, m2, l2, o2):
    """Combine two online-softmax stat sets over the same q rows."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _binary_causal(q, k, v, n: int, c: int):
    """Exact causal attention by balanced binary decomposition of the n x n
    chunk grid (chunk size c, n a power of two): n diagonal blocks,
    causal-masked, then for each level l in [0, log2 n) 2^l unmasked
    squares of side m = n / 2^(l+1) chunks, square j covering q-chunks
    [2jm + m, 2jm + 2m) x kv-chunks [2jm, 2jm + m).  The squares of a
    level touch disjoint q rows, so a level is one batched product and a
    merge into the running stats of those rows."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, n, c, Hkv, G, D)
    kr = k.reshape(B, n, c, Hkv, D)
    vr = v.reshape(B, n, c, Hkv, D)
    # the diagonal blocks
    dmask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    s = _block_scores(qr, kr)                       # (B,n,Hkv,G,c,c)
    s = torch.where(dmask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                              # (B,n,Hkv,G,c)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bnhgqk,bnkhd->bnhgqd", p, vr.float())
    half = n // 2
    while half >= 1:
        mm, ns = half, n // (2 * half)
        # chunks grouped (ns, 2, mm): [:, 0] the kv side, [:, 1] the q side
        qg = qr.reshape(B, ns, 2, mm * c, Hkv, G, D)[:, :, 1]
        kg = kr.reshape(B, ns, 2, mm * c, Hkv, D)[:, :, 0]
        vg = vr.reshape(B, ns, 2, mm * c, Hkv, D)[:, :, 0]
        s = _block_scores(qg, kg)                   # (B,ns,Hkv,G,Q,K)
        m2 = s.amax(dim=-1)
        p = torch.exp(s - m2[..., None])
        l2 = p.sum(dim=-1)
        o2 = torch.einsum("bnhgqk,bnkhd->bnhgqd", p, vg.float())
        # running stats, rows chunk-major: (B,n,Hkv,G,c) -> (B,ns,2,Hkv,G,Q)
        mr = (m.permute(0, 1, 4, 2, 3).reshape(B, ns, 2, mm * c, Hkv, G)
              .permute(0, 1, 2, 4, 5, 3))
        lr = (l.permute(0, 1, 4, 2, 3).reshape(B, ns, 2, mm * c, Hkv, G)
              .permute(0, 1, 2, 4, 5, 3))
        orr = (o.permute(0, 1, 4, 2, 3, 5)
               .reshape(B, ns, 2, mm * c, Hkv, G, D)
               .permute(0, 1, 2, 4, 5, 3, 6))
        mu, lu, ou = _merge_stats(mr[:, :, 1], lr[:, :, 1], orr[:, :, 1],
                                  m2, l2, o2)
        mr = torch.stack([mr[:, :, 0], mu], dim=2)
        lr = torch.stack([lr[:, :, 0], lu], dim=2)
        orr = torch.stack([orr[:, :, 0], ou], dim=2)
        m = (mr.permute(0, 1, 2, 5, 3, 4).reshape(B, n, c, Hkv, G)
             .permute(0, 1, 3, 4, 2))
        l = (lr.permute(0, 1, 2, 5, 3, 4).reshape(B, n, c, Hkv, G)
             .permute(0, 1, 3, 4, 2))
        o = (orr.permute(0, 1, 2, 5, 3, 4, 6).reshape(B, n, c, Hkv, G, D)
             .permute(0, 1, 3, 4, 2, 5))
        half //= 2
    o = o / torch.clamp(l, min=1e-30)[..., None]
    out = o.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, D)
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, q_chunk: int, kv_chunk: int,
                      q_offset: int = 0, window: int = 0,
                      schedule: str = "dense") -> torch.Tensor:
    """Causal flash-style attention in plain torch, ``dense`` or ``binary``
    schedule (see the module docstring); differentiable.

    q: (B,S,H,D), k/v: (B,Sk,Hkv,D).  ``q_offset`` is the absolute position
    of q[0] relative to k[0] (used when a prefix of KV comes from a cache).
    Returns (B,S,H,D).
    """
    return _attn_core(q, k, v, q_chunk, kv_chunk, int(q_offset), window,
                      schedule)


def attention_block(params, x, positions, cfg, *, layer_window: int = 0,
                    kv_cache: Optional[Tuple] = None,
                    cache_pos: Optional[int] = None, q_chunk: int = 512,
                    kv_chunk: int = 512, schedule: str = "dense",
                    use_kernel: bool = True):
    """Attention sub-block.  Returns (y, new_kv_cache).

    Training (``kv_cache`` None, the new cache None): causal attention with
    the layer's window, through ``ops.flash_attention`` with
    ``use_kernel`` and through ``chunked_attention`` (``schedule``)
    otherwise, as the JAX package's training branch; the plain route is
    for CPU tensors only (a CUDA tensor raises).

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
    q, k, v = project_qkv(params, x, cfg, positions)
    if kv_cache is None:
        if use_kernel:
            out = ops.flash_attention(q, k, v, causal=True,
                                      window=layer_window)
        elif q.is_cuda:
            raise ValueError("attention_block: use_kernel=False runs the "
                             "plain attention, which is for CPU tensors; "
                             "on the card training attention is the flash "
                             "kernel")
        else:
            out = chunked_attention(q, k, v, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, window=layer_window,
                                    schedule=schedule)
        return o_proj(out, params["wo"]), None
    S = x.shape[1]
    cache_pos = int(cache_pos)
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
                                kv_chunk=kv_chunk, q_offset=cache_pos,
                                schedule=schedule)
    return o_proj(out, params["wo"]), (k_cache, v_cache)
