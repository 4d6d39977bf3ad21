"""Model assembly for serving (prefill and decode): embedding, a stack of
blocks, final norm and unembedding.  Ported block kinds: ATTN (full causal
GQA attention), SWA (sliding-window attention over a ring cache) and
HYBRID (Hymba: sliding-window attention and a mamba mixer in parallel on
the same input, mixed by ``beta``), each followed by a dense SwiGLU FFN.

Layers are grouped into *periods* (one repetition of the block pattern)
and parameters are stacked over periods, keeping the JAX package's
parameter tree (``{"embed", "unembed", "final_norm", "layers": {"e0":
...}}``) so JAX-initialised weights load by key.  Where JAX scans over
periods, this runs a Python loop.  MAMBA, MLSTM and SLSTM blocks, MoE and
the training mode raise ``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN, HYBRID, SWA, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, rms_norm, swiglu


class EntrySpec(NamedTuple):
    kind: str
    use_moe: bool


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Build-time knobs: the attention and SSD-scan chunk sizes."""
    q_chunk: int = 512
    kv_chunk: int = 512
    ssm_chunk: int = 256


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
    if spec.kind not in (ATTN, SWA, HYBRID) or spec.use_moe:
        raise NotImplementedError(
            f"block kind {spec.kind!r} (moe={spec.use_moe}): only ATTN, SWA "
            f"and HYBRID blocks with dense FFNs are ported")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _init_entry(gen, spec: EntrySpec, cfg: ModelConfig, dtype, n: int):
    _check_entry(spec)
    d, f = cfg.d_model, cfg.d_ff
    ones = dict(dtype=dtype, device=gen.device)
    p: Dict[str, Any] = {"ln1": torch.ones((n, d), **ones)}
    p["attn"] = attn_mod.init_attn_params(gen, cfg, dtype, lead=(n,))
    if spec.kind == HYBRID:
        p["mamba"] = ssm_mod.init_ssm_params(
            gen, d, cfg.n_heads, cfg.head_dim, cfg.ssm_state, dtype,
            lead=(n,))
        p["beta"] = torch.ones((n, 2), dtype=torch.float32,
                               device=gen.device)
    p["ln2"] = torch.ones((n, d), **ones)
    if f:
        p["ffn"] = {"w1": dense_init(gen, (d, f), dtype, lead=(n,)),
                    "w3": dense_init(gen, (d, f), dtype, lead=(n,)),
                    "w2": dense_init(gen, (f, d), dtype, lead=(n,))}
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
    """Zero cache tree, stacked over periods: {'e0': {'k', 'v'}, ...}.
    Window layers (SWA, HYBRID) hold a ring of min(window, max_len)
    slots; HYBRID adds the mamba state ``ssm`` (fp32) and the conv carry
    ``conv`` (model dtype)."""
    dtype = model_dtype(cfg)
    entries, n_periods = layer_plan(cfg)
    cache = {}
    for i, spec in enumerate(entries):
        _check_entry(spec)
        smax = min(cfg.window, max_len) if spec.kind in (SWA, HYBRID) \
            and cfg.window else max_len
        k = torch.zeros((n_periods, batch, smax, cfg.n_kv_heads,
                         cfg.head_dim), dtype=dtype, device=device)
        c = {"k": k, "v": torch.zeros_like(k)}
        if spec.kind == HYBRID:
            c["ssm"] = torch.zeros((n_periods, batch, cfg.n_heads,
                                    cfg.head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=device)
            c["conv"] = torch.zeros((n_periods, batch, ssm_mod.CONV_W - 1,
                                     cfg.n_heads * cfg.head_dim),
                                    dtype=dtype, device=device)
        cache[f"e{i}"] = c
    return cache


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_ffn(p, x):
    """Dense FFN sub-block."""
    if "ffn" not in p:
        return torch.zeros_like(x)
    return swiglu(x, p["ffn"]["w1"], p["ffn"]["w3"], p["ffn"]["w2"])


def _apply_entry(p, spec: EntrySpec, x, positions, cfg, opts, mode: str,
                 cache=None, cache_pos=None):
    """One ATTN, SWA or HYBRID block.  Returns (x, new_cache).  In decode
    every state (k/v, and for HYBRID ``ssm``/``conv``) is written into
    ``cache`` in place."""
    _check_entry(spec)
    h = rms_norm(x, p["ln1"])
    window = cfg.window if spec.kind in (SWA, HYBRID) else 0
    y, new_cache = _attention(p["attn"], h, positions, cfg, window, opts,
                              mode, cache, cache_pos)
    if spec.kind == HYBRID:
        ssm_state = conv_state = None
        if mode == "decode":
            ssm_state, conv_state = cache["ssm"], cache["conv"]
        ym, (st, cv) = ssm_mod.mamba_forward(
            p["mamba"], h, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
            state=cfg.ssm_state, chunk=opts.ssm_chunk, ssm_state=ssm_state,
            conv_state=conv_state)
        if mode == "decode":
            ssm_state.copy_(st)
            conv_state.copy_(cv)
        else:
            new_cache.update(ssm=st, conv=cv)
        beta = p["beta"].to(x.dtype)
        y = 0.5 * (beta[0] * y + beta[1] * ym)
    x = x + y
    x = x + _apply_ffn(p, rms_norm(x, p["ln2"]))
    return x, new_cache


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
