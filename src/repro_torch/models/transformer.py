"""Model assembly for serving (prefill and decode): embedding, a stack of
blocks, final norm and unembedding.  Ported block kinds: ATTN (full causal
GQA attention), SWA (sliding-window attention over a ring cache), HYBRID
(Hymba: sliding-window attention and a mamba mixer in parallel on the
same input, mixed by ``beta``), each followed by a dense SwiGLU or (ATTN
and SWA with ``use_moe``) a mixture-of-experts FFN, and the xLSTM blocks
MLSTM and SLSTM, which carry their own projections.

Layers are grouped into *periods* (one repetition of the block pattern)
and parameters are stacked over periods, keeping the JAX package's
parameter tree (``{"embed", "unembed", "final_norm", "layers": {"e0":
...}}``) so JAX-initialised weights load by key.  Where JAX scans over
periods, this runs a Python loop.  MAMBA blocks, the expert-parallel MoE
path and the training mode raise ``NotImplementedError`` until their
slices land.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import (ATTN, HYBRID, MLSTM, SLSTM, SWA,
                                      ModelConfig)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import dense_init, rms_norm, swiglu


class EntrySpec(NamedTuple):
    kind: str
    use_moe: bool


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Build-time knobs: the attention and SSD-scan (and mLSTM) chunk
    sizes, and the sLSTM's timesteps per block."""
    q_chunk: int = 512
    kv_chunk: int = 512
    ssm_chunk: int = 256
    slstm_block: int = 16


def layer_plan(cfg: ModelConfig) -> Tuple[Tuple[EntrySpec, ...], int]:
    """Returns (period entries, n_periods)."""
    period = len(cfg.block_pattern)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.moe_every)
    assert cfg.n_layers % period == 0, (cfg.name, cfg.n_layers, period)
    moe_layers = set(cfg.moe_layers())
    entries = tuple(
        EntrySpec(cfg.blocks[i], i in moe_layers) for i in range(period))
    return entries, cfg.n_layers // period


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_entry(spec: EntrySpec) -> None:
    if spec.kind not in (ATTN, SWA, HYBRID, MLSTM, SLSTM):
        raise NotImplementedError(
            f"block kind {spec.kind!r}: only ATTN, SWA, HYBRID, MLSTM and "
            f"SLSTM blocks are ported")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _init_ffn(gen, cfg: ModelConfig, dtype, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": dense_init(gen, (d, f), dtype, lead=(n,)),
            "w3": dense_init(gen, (d, f), dtype, lead=(n,)),
            "w2": dense_init(gen, (f, d), dtype, lead=(n,))}


def _init_entry(gen, spec: EntrySpec, cfg: ModelConfig, dtype, n: int):
    _check_entry(spec)
    d = cfg.d_model
    ones = dict(dtype=dtype, device=gen.device)
    p: Dict[str, Any] = {"ln1": torch.ones((n, d), **ones)}
    if spec.kind == MLSTM:
        p["mlstm"] = xlstm_mod.init_mlstm_params(
            gen, d, cfg.n_heads, cfg.head_dim, dtype, lead=(n,))
        return p
    if spec.kind == SLSTM:
        p["slstm"] = xlstm_mod.init_slstm_params(gen, d, cfg.n_heads, dtype,
                                                 lead=(n,))
        return p
    p["attn"] = attn_mod.init_attn_params(gen, cfg, dtype, lead=(n,))
    if spec.kind == HYBRID:
        p["mamba"] = ssm_mod.init_ssm_params(
            gen, d, cfg.n_heads, cfg.head_dim, cfg.ssm_state, dtype,
            lead=(n,))
        p["beta"] = torch.ones((n, 2), dtype=torch.float32,
                               device=gen.device)
    p["ln2"] = torch.ones((n, d), **ones)
    if spec.use_moe and spec.kind != HYBRID:
        p["moe"] = moe_mod.init_moe_params(gen, d, cfg.d_ff,
                                           cfg.moe.n_experts, dtype,
                                           lead=(n,))
        if cfg.moe.shared_expert:
            p["shared"] = _init_ffn(gen, cfg, dtype, n)
    elif cfg.d_ff:
        p["ffn"] = _init_ffn(gen, cfg, dtype, n)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Seeded parameters on ``gen``'s device, every draw from ``gen``."""
    dtype = model_dtype(cfg)
    entries, n_periods = layer_plan(cfg)
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), dtype,
                            scale=cfg.d_model ** 0.5),  # ~N(0,1) rows
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab), dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                 device=gen.device),
        "layers": {},
    }
    for i, spec in enumerate(entries):
        params["layers"][f"e{i}"] = _init_entry(gen, spec, cfg, dtype,
                                                n_periods)
    return params


# ---------------------------------------------------------------------------
# Caches (serving state per entry)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda"):
    """Zero cache tree, stacked over periods: {'e0': {...}, ...}.
    Attention layers hold ``k``/``v``; window layers (SWA, HYBRID) a ring
    of min(window, max_len) slots.  HYBRID adds the mamba state ``ssm``
    (fp32) and the conv carry ``conv`` (model dtype); MLSTM the matrix
    state ``H`` (fp32, the normaliser as its last value column) and the
    stabiliser ``m`` at -1e30; SLSTM ``c``, ``n``, ``h`` (fp32 zeros) and
    ``m`` at -1e30, as in the JAX package."""
    dtype = model_dtype(cfg)
    entries, n_periods = layer_plan(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    cache = {}
    for i, spec in enumerate(entries):
        _check_entry(spec)
        c = {}
        if spec.kind in (ATTN, SWA, HYBRID):
            smax = min(cfg.window, max_len) if spec.kind in (SWA, HYBRID) \
                and cfg.window else max_len
            k = torch.zeros((n_periods, batch, smax, cfg.n_kv_heads,
                             cfg.head_dim), dtype=dtype, device=device)
            c.update(k=k, v=torch.zeros_like(k))
        if spec.kind == HYBRID:
            c["ssm"] = torch.zeros((n_periods, batch, cfg.n_heads,
                                    cfg.head_dim, cfg.ssm_state), **f32)
            c["conv"] = torch.zeros((n_periods, batch, ssm_mod.CONV_W - 1,
                                     cfg.n_heads * cfg.head_dim),
                                    dtype=dtype, device=device)
        if spec.kind == MLSTM:
            dv = 2 * d // cfg.n_heads
            c["H"] = torch.zeros((n_periods, batch, cfg.n_heads,
                                  cfg.head_dim, dv + 1), **f32)
            c["m"] = torch.full((n_periods, batch, cfg.n_heads), -1e30,
                                **f32)
        if spec.kind == SLSTM:
            for name in ("c", "n", "h"):
                c[name] = torch.zeros((n_periods, batch, d), **f32)
            c["m"] = torch.full((n_periods, batch, d), -1e30, **f32)
        cache[f"e{i}"] = c
    return cache


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_ffn(p, x, cfg):
    """Dense or MoE FFN sub-block.  Returns (y, aux): the MoE aux loss,
    zero for a dense FFN (serving leaves it unused)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        y, aux = moe_mod.moe_ffn(
            p["moe"], x, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor)
        if "shared" in p:
            y = y + swiglu(x, p["shared"]["w1"], p["shared"]["w3"],
                           p["shared"]["w2"])
        return y, aux
    if "ffn" not in p:
        return torch.zeros_like(x), aux
    return swiglu(x, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"]), aux


def _write_states(cache, new: dict):
    """Decode: write a block's new states into its cache slices in place
    (the caller returns ``cache``)."""
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def _apply_entry(p, spec: EntrySpec, x, positions, cfg, opts, mode: str,
                 cache=None, cache_pos=None):
    """One block.  Returns (x, new_cache).  In decode every state (k/v,
    ``ssm``/``conv``, the xLSTM states) is written into ``cache`` in
    place."""
    _check_entry(spec)
    h = rms_norm(x, p["ln1"])
    decode = mode == "decode"
    if spec.kind == MLSTM:
        y, (H, m) = xlstm_mod.mlstm_forward(
            p["mlstm"], h, n_heads=cfg.n_heads, dqk=cfg.head_dim,
            chunk=opts.ssm_chunk,
            state=(cache["H"], cache["m"]) if decode else None)
        new = {"H": H, "m": m}
        return x + y, _write_states(cache, new) if decode else new
    if spec.kind == SLSTM:
        y, new = xlstm_mod.slstm_forward(
            p["slstm"], h, n_heads=cfg.n_heads,
            state={k: cache[k] for k in ("c", "n", "h", "m")}
            if decode else None, time_block=opts.slstm_block)
        return x + y, _write_states(cache, new) if decode else new
    window = cfg.window if spec.kind in (SWA, HYBRID) else 0
    y, new_cache = _attention(p["attn"], h, positions, cfg, window, opts,
                              mode, cache, cache_pos)
    if spec.kind == HYBRID:
        ssm_state = conv_state = None
        if decode:
            ssm_state, conv_state = cache["ssm"], cache["conv"]
        ym, (st, cv) = ssm_mod.mamba_forward(
            p["mamba"], h, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
            state=cfg.ssm_state, chunk=opts.ssm_chunk, ssm_state=ssm_state,
            conv_state=conv_state)
        if decode:
            _write_states(cache, {"ssm": st, "conv": cv})
        else:
            new_cache.update(ssm=st, conv=cv)
        beta = p["beta"].to(x.dtype)
        y = 0.5 * (beta[0] * y + beta[1] * ym)
    x = x + y
    y2, _ = _apply_ffn(p, rms_norm(x, p["ln2"]), cfg)
    return x + y2, new_cache


def _attention(ap, h, positions, cfg, window, opts, mode, cache, cache_pos):
    """Attention sub-block, prefill or decode.  Returns (y, cache)."""
    if mode == "prefill":
        # build the cache from scratch; attention runs the flash kernel
        # (causal, q_offset 0, S == Sk, the layer's window)
        q, k, v = attn_mod.project_qkv(ap, h, cfg, positions)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        if window:
            # ring cache: slot i must hold absolute position p with
            # p % w == i, so the kept tail is rolled by S % w
            S = h.shape[1]
            w = min(window, S)
            k = torch.roll(k[:, -w:], S % w, dims=1)
            v = torch.roll(v[:, -w:], S % w, dims=1)
        dtype = model_dtype(cfg)
        return attn_mod.o_proj(out, ap["wo"]), {"k": k.to(dtype),
                                                "v": v.to(dtype)}
    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r}")
    y, kv = attn_mod.attention_block(
        ap, h, positions, cfg, layer_window=window,
        kv_cache=(cache["k"], cache["v"]), cache_pos=cache_pos,
        q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    return y, {"k": kv[0], "v": kv[1]}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def _index(tree, i: int):
    """The i-th period's slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def embed_inputs(params, cfg: ModelConfig, tokens, embeds):
    """tokens: (B, S_text) integer or None; embeds: (B, S_front, d) or
    None."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(model_dtype(cfg)))
    if tokens is not None:
        parts.append(params["embed"][tokens])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _stack_forward(params, x, cfg, opts, mode, cache=None, cache_pos=None,
                   positions=None):
    """Runs the periods in order.  Returns (x, new_cache).  In decode the
    new states (k/v, ssm, conv) are written into ``cache`` in place and
    ``cache`` itself is returned; prefill returns freshly stacked
    caches."""
    entries, n_periods = layer_plan(cfg)
    built: Dict[str, list] = {f"e{i}": [] for i in range(len(entries))}
    for p in range(n_periods):
        layer_p = _index(params["layers"], p)
        for i, spec in enumerate(entries):
            ename = f"e{i}"
            c = _index(cache[ename], p) if cache is not None else None
            x, nc = _apply_entry(layer_p[ename], spec, x, positions, cfg,
                                 opts, mode, cache=c, cache_pos=cache_pos)
            built[ename].append(nc)
    if mode == "decode":
        return x, cache
    new_cache = {e: {key: torch.stack([nc[key] for nc in ncs])
                     for key in ncs[0]}
                 for e, ncs in built.items()}
    return x, new_cache


def _unembed_last(params, x):
    h = rms_norm(x[:, -1:], params["final_norm"])
    return (h @ params["unembed"])[:, 0].float()


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None, *,
            opts: ModelOptions = ModelOptions()):
    """Serving prefill.  Returns (last_logits (B,V) fp32, cache)."""
    x = embed_inputs(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = _stack_forward(params, x, cfg, opts, "prefill",
                              positions=positions)
    return _unembed_last(params, x), cache


def decode_step(params, cfg: ModelConfig, cache, token=None, embed=None,
                pos: Optional[int] = None, *,
                opts: ModelOptions = ModelOptions()):
    """One serving step: one new token against the cache.

    token: (B,) integer (or embed: (B,1,d)).  pos: the absolute position
    of this token, a Python int.  Returns (logits (B,V) fp32, cache), with
    the cache updated in place.
    """
    if embed is None:
        x = params["embed"][token[:, None]]
    else:
        x = embed.to(model_dtype(cfg))
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, cache = _stack_forward(params, x, cfg, opts, "decode", cache=cache,
                              cache_pos=pos, positions=positions)
    return _unembed_last(params, x), cache
