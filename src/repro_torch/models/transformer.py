"""Model assembly for training (``forward``, ``lm_loss``, ``loss_fn``) and
serving (``prefill``, ``decode_step``): embedding, a stack of blocks,
final norm and unembedding.  Block kinds, every one of the JAX
package's: ATTN (full causal GQA attention), SWA (sliding-window
attention over a ring cache), HYBRID (Hymba: sliding-window attention
and a mamba mixer in parallel on the same input, mixed by ``beta``),
each followed by a dense SwiGLU or (ATTN and SWA with ``use_moe``) a
mixture-of-experts FFN; MAMBA (the mamba mixer alone) and the xLSTM
blocks MLSTM and SLSTM, which carry their own projections and no FFN.

A ``HybridMoEConfig`` (granite-4.0-h, the port's own) changes MAMBA and
ATTN blocks: a MAMBA block is the Mamba-2 mixer (``ssm.mamba2_forward``)
followed, as every attention block, by the MoE over the device's held
experts (``experts_held``) plus a shared expert of width ``shared_ff``;
residual branches are scaled by ``residual_multiplier``, the embedding
by ``embedding_multiplier``, scores by ``attention_multiplier`` (folded
into q), attention runs with no rope where ``use_rope`` is off, norms
take ``norm_eps``, the head is the embedding's transpose and the logits
are divided by ``logits_scaling``.  Its cache holds the k/v of the
attention layers and the ``ssm``/``conv`` states of the mixers side by
side, the latter sized by the Mamba-2 widths.

Layers are grouped into *periods* (one repetition of the block pattern)
and parameters are stacked over periods, keeping the JAX package's
parameter tree (``{"embed", "unembed", "final_norm", "layers": {"e0":
...}}``) so JAX-initialised weights load by key.  Where JAX scans over
periods, this runs a Python loop.  In training each period is one
``torch.utils.checkpoint`` region (``ModelOptions.remat``), as the JAX
package's remat of the scan body.

On a device mesh (``mesh_args``, a ``MeshCtx``: the sharded steps of
``launch.steps`` build it) every function here runs on one rank's local
blocks inside the step's ``shard_map`` region, with the reference's
global semantics.  Each period's weights are gathered from their storage
layout (the plan's ``param_shardings``) just in time, inside the period's
checkpoint region, so the backward gathers them again and the gather's
transpose (a reduce-scatter) sums their gradients: the attention and
dense FFN weights over every axis but ``model`` (megatron tensor
parallelism: q/k/v column-parallel over heads, ``wo`` and ``w2``
row-parallel, one psum over ``model`` after each), the MoE weights not at
all (``moe.moe_ffn``'s expert-parallel path gathers its own), every other
leaf (the embed, the unembed, the xLSTM and mamba weights) over every
axis.  The residual stream is a rank's batch rows, replicated over
``model``: the reference's batch-sharding constraint on it holds by
construction.

While torch.profiler records, the embedding, each block's attention and
FFN or MoE, the head and the loss are spans (``core.scope.span``:
``rt.embed``, ``rt.attn``, ``rt.ffn`` / ``rt.moe``, ``rt.head``,
``rt.loss``), and so are a Mamba-2 mixer (``rt.mamba``) and a shared
expert beside a MoE (``rt.shared``, inside ``rt.moe``); Hymba's MAMBA and
the xLSTM blocks have none.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, HYBRID, MAMBA, MLSTM, SLSTM,
                                      SWA, ModelConfig)
from repro_torch.core import scope
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (dense_init, pick_chunk, rms_norm,
                                      swiglu)


class EntrySpec(NamedTuple):
    kind: str
    use_moe: bool


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Build-time knobs, the JAX package's: remat of each period in
    training and its policy, the attention and SSD-scan (and mLSTM) chunk
    sizes, the sLSTM's timesteps per block, the attention schedule of the
    plain path, the kernel routing and the loss's sequence chunk."""
    remat: bool = True
    remat_policy: str = "dots_no_batch"   # dots_no_batch | nothing | everything
    q_chunk: int = 512
    kv_chunk: int = 512
    ssm_chunk: int = 256
    slstm_block: int = 16         # sLSTM timesteps per block
    attn_schedule: str = "dense"          # dense | binary
    # the hand-written kernels in training attention and in the mamba
    # mixer: on the card they are the port's main path (the JAX package
    # defaults to False: its Pallas kernels are for the TPU); on the CPU
    # the ops run their plain versions.  False routes around the ops to
    # the plain schedules (``attn_schedule``), on the CPU only: on CUDA
    # tensors it raises
    use_flash_kernel: bool = True
    loss_chunk: int = 512


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


class MeshCtx(NamedTuple):
    """What a sharded step's region knows of the mesh: the plan
    (``distributed.sharding.ShardingPlan``), the storage spec of every
    parameter leaf (a tree like the params, of ``shardmap_compat.P``) and,
    in decode, of every cache leaf (``cache_specs``: a k/v cache split
    over its sequence is attended by ``attention.split_decode``)."""
    plan: Any
    specs: Any
    cache_specs: Any = None

    @property
    def mesh(self):
        return self.plan.mesh

    @property
    def tp_axis(self) -> Optional[str]:
        """The tensor-parallel axis, if the strategy has one."""
        return self.plan.model_axis if self.plan.strategy == "tp" else None

    def n_batch(self) -> int:
        """How many ways the batch is split."""
        return self.mesh.axis_size(self.plan.batch_axes())

    def redundancy(self) -> int:
        """How many ranks compute each batch shard."""
        return self.mesh.size // self.n_batch()


class TP(NamedTuple):
    """An attention or FFN weight set's tensor parallelism: the axis, and
    whether the q heads (and ``wo``, ``w1``/``w3``/``w2``) and the kv
    heads are split over it."""
    axis: str
    q: bool
    kv: bool


def _materialize(tree, specs, keep: tuple = ()):
    """(tree, specs) of a params subtree gathered by
    ``shardmap_compat.gather_spec``."""
    if isinstance(tree, dict):
        pairs = {k: _materialize(v, specs[k], keep) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    return smc.gather_spec(tree, specs, keep)


def _period_params(layer_p, layer_specs, ctx: "MeshCtx"):
    """One period's weights in their compute layout (see the module
    docstring) and the specs they keep."""
    keep = (ctx.tp_axis,) if ctx.tp_axis else ()
    out, specs = {}, {}
    for ename, p in layer_p.items():
        out[ename], specs[ename] = {}, {}
        for k, v in p.items():
            if k == "moe" and ctx.plan.moe_args() is not None:
                out[ename][k], specs[ename][k] = v, layer_specs[ename][k]
                continue
            kk = keep if k in ("attn", "ffn", "shared") else ()
            out[ename][k], specs[ename][k] = _materialize(
                v, layer_specs[ename][k], kk)
    return out, specs


def _tp(specs, ctx, q_key: str, kv_key: Optional[str] = None):
    """The TP of a weight set from its specs after ``_period_params``."""
    if ctx is None or ctx.tp_axis is None:
        return None
    q = ctx.tp_axis in smc.spec_axes(specs[q_key])
    kv = ctx.tp_axis in smc.spec_axes(specs[kv_key]) if kv_key else q
    return TP(ctx.tp_axis, q, kv) if q or kv else None


def _unstack(specs):
    """The specs of one period's slice of stacked leaves."""
    if isinstance(specs, dict):
        return {k: _unstack(v) for k, v in specs.items()}
    return smc.P(*specs[1:])


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_mamba(gen, cfg: ModelConfig, dtype, n: int) -> dict:
    if cfg.mamba2:
        return ssm_mod.init_mamba2_params(
            gen, cfg.d_model, cfg.mamba_heads, cfg.mamba_head_dim,
            cfg.ssm_state, dtype, lead=(n,))
    return ssm_mod.init_ssm_params(gen, cfg.d_model, cfg.n_heads,
                                   cfg.head_dim, cfg.ssm_state, dtype,
                                   lead=(n,))


def _norm(x, w, cfg: ModelConfig):
    return rms_norm(x, w, cfg.norm_eps)


def _residual(x, y, cfg: ModelConfig):
    """x + y, the branch scaled by the configuration's residual
    multiplier where it has one."""
    m = cfg.residual_multiplier
    return x + y if m == 1.0 else x + y * m


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def _init_ffn(gen, cfg: ModelConfig, dtype, n: int, f: int = 0) -> dict:
    d, f = cfg.d_model, f or cfg.d_ff
    return {"w1": dense_init(gen, (d, f), dtype, lead=(n,)),
            "w3": dense_init(gen, (d, f), dtype, lead=(n,)),
            "w2": dense_init(gen, (f, d), dtype, lead=(n,))}


def _init_entry(gen, spec: EntrySpec, cfg: ModelConfig, dtype, n: int):
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
    if spec.kind == MAMBA:
        # Hymba's mixer alone: no FFN, even where ``use_moe`` marks the
        # layer; a Mamba-2 mixer is followed by the MoE as attention is
        p["mamba"] = _init_mamba(gen, cfg, dtype, n)
        if not cfg.mamba2:
            return p
    elif spec.kind not in (ATTN, SWA, HYBRID):
        raise ValueError(spec.kind)
    else:
        p["attn"] = attn_mod.init_attn_params(gen, cfg, dtype, lead=(n,))
    if spec.kind == HYBRID:
        p["mamba"] = _init_mamba(gen, cfg, dtype, n)
        p["beta"] = torch.ones((n, 2), dtype=torch.float32,
                               device=gen.device)
    p["ln2"] = torch.ones((n, d), **ones)
    if spec.use_moe and spec.kind != HYBRID:
        p["moe"] = moe_mod.init_moe_params(
            gen, d, cfg.d_ff, cfg.moe.n_experts, dtype, lead=(n,),
            held=cfg.experts_held or None)
        if cfg.moe.shared_expert:
            p["shared"] = _init_ffn(gen, cfg, dtype, n, cfg.shared_ff)
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
    if cfg.tie_embeddings:      # the head is the embedding's transpose
        del params["unembed"]
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
    of min(window, max_len) slots.  HYBRID and MAMBA hold the mamba state
    ``ssm`` (fp32) and the conv carry ``conv`` (model dtype; a Mamba-2
    mixer's over xBC, at its own heads and widths); MLSTM the
    matrix state ``H`` (fp32, the normaliser as its last value column) and
    the stabiliser ``m`` at -1e30; SLSTM ``c``, ``n``, ``h`` (fp32 zeros) and
    ``m`` at -1e30, as in the JAX package."""
    dtype = model_dtype(cfg)
    entries, n_periods = layer_plan(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    cache = {}
    for i, spec in enumerate(entries):
        c = {}
        if spec.kind in (ATTN, SWA, HYBRID):
            smax = min(cfg.window, max_len) if spec.kind in (SWA, HYBRID) \
                and cfg.window else max_len
            k = torch.zeros((n_periods, batch, smax, cfg.n_kv_heads,
                             cfg.head_dim), dtype=dtype, device=device)
            c.update(k=k, v=torch.zeros_like(k))
        if spec.kind in (HYBRID, MAMBA):
            nh, hd = (cfg.mamba_heads, cfg.mamba_head_dim) if cfg.mamba2 \
                else (cfg.n_heads, cfg.head_dim)
            # a Mamba-2 mixer's conv runs over xBC
            width = nh * hd + (2 * cfg.ssm_state if cfg.mamba2 else 0)
            c["ssm"] = torch.zeros((n_periods, batch, nh, hd,
                                    cfg.ssm_state), **f32)
            c["conv"] = torch.zeros((n_periods, batch, ssm_mod.CONV_W - 1,
                                     width), dtype=dtype, device=device)
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
def _swiglu(w, x, tp: Optional[TP]):
    """Dense SwiGLU; row-parallel (a psum over the TP axis) when its
    hidden dim is split."""
    y = swiglu(x, w["w1"], w["w3"], w["w2"])
    return smc.psum(y, tp.axis) if tp is not None and tp.q else y


def _moe(p, x, cfg, ctx):
    """The MoE FFN: expert-parallel under a plan with a model axis; on a
    mesh without one (``fsdp``, ``dp_only``) the reference runs the
    one-device MoE over the global batch, so the tokens are gathered, the
    MoE run on all of them and this rank's rows kept."""
    kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
              capacity_factor=cfg.moe.capacity_factor)
    if ctx is None:
        share = (0, cfg.experts_held) if cfg.experts_held else None
        return moe_mod.moe_ffn(p["moe"], x, experts=share, **kw)
    args = ctx.plan.moe_args()
    if args is not None:
        return moe_mod.moe_ffn(p["moe"], x, mesh_args=args, d_ff=cfg.d_ff,
                               **kw)
    axes = ctx.plan.batch_axes()
    if ctx.n_batch() == 1:
        return moe_mod.moe_ffn(p["moe"], x, **kw)
    b = x.shape[0]
    y, aux = moe_mod.moe_ffn(p["moe"], smc.all_gather(x, axes, axis=0), **kw)
    i = smc.axis_index(axes)
    return y[i * b:(i + 1) * b], aux


def _apply_ffn(p, x, cfg, ctx=None, specs=None):
    """Dense or MoE FFN sub-block.  Returns (y, aux): the MoE aux loss,
    zero for a dense FFN (serving leaves it unused)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        y, aux = _moe(p, x, cfg, ctx)
        if "shared" in p:
            with scope.span(scope.SHARED):
                y = y + _swiglu(p["shared"], x,
                                _tp(specs["shared"], ctx, "w1") if specs
                                else None)
        return y, aux
    if "ffn" not in p:
        return torch.zeros_like(x), aux
    return _swiglu(p["ffn"], x, _tp(specs["ffn"], ctx, "w1") if specs
                   else None), aux


def _write_states(cache, new: dict):
    """Decode: write a block's new states into its cache slices in place
    (the caller returns ``cache``)."""
    for name, value in new.items():
        cache[name].copy_(value)
    return cache


def _apply_entry(p, spec: EntrySpec, x, positions, cfg, opts, mode: str,
                 cache=None, cache_pos=None, ctx=None, specs=None, seq=None):
    """One block.  Returns (x, new_cache, aux): aux is the MoE aux loss
    (zero elsewhere: 0.0 for the MAMBA and xLSTM blocks, which have no
    FFN); in training new_cache is None.  In decode every state (k/v,
    ``ssm``/``conv``, the xLSTM states) is written into ``cache`` in
    place.  On a mesh ``p`` is the period's weights in their compute
    layout and ``specs`` their specs (``_period_params``); ``seq``: the
    decode cache's k/v are this rank's slots of a split sequence."""
    h = _norm(x, p["ln1"], cfg)
    decode = mode == "decode"
    train = mode == "train"
    if spec.kind == MLSTM:
        y, (H, m) = xlstm_mod.mlstm_forward(
            p["mlstm"], h, n_heads=cfg.n_heads, dqk=cfg.head_dim,
            chunk=opts.ssm_chunk,
            state=(cache["H"], cache["m"]) if decode else None)
        new = None if train else {"H": H, "m": m}
        return x + y, _write_states(cache, new) if decode else new, 0.0
    if spec.kind == SLSTM:
        y, new = xlstm_mod.slstm_forward(
            p["slstm"], h, n_heads=cfg.n_heads,
            state={k: cache[k] for k in ("c", "n", "h", "m")}
            if decode else None, time_block=opts.slstm_block)
        if train:
            new = None
        return x + y, _write_states(cache, new) if decode else new, 0.0
    if spec.kind == MAMBA and not cfg.mamba2:
        y, new = _mamba(p["mamba"], h, cfg, opts, cache if decode else None)
        if train:
            new = None
        return x + y, _write_states(cache, new) if decode else new, 0.0
    window = cfg.window if spec.kind in (SWA, HYBRID) else 0
    tp = _tp(specs["attn"], ctx, "wq", "wk") if specs else None
    if spec.kind == MAMBA:      # Mamba-2, then the FFN below
        with scope.span(scope.MAMBA):
            y, new_cache = _mamba(p["mamba"], h, cfg, opts,
                                  cache if decode else None)
            if decode:
                new_cache = _write_states(cache, new_cache)
            elif train:
                new_cache = None
            x = _residual(x, y, cfg)
    else:
        with scope.span(scope.ATTN):
            y, new_cache = _attention(p["attn"], h, positions, cfg, window,
                                      opts, mode, cache, cache_pos, tp, seq)
            if spec.kind == HYBRID:
                ym, new = _mamba(p["mamba"], h, cfg, opts,
                                 cache if decode else None)
                if decode:
                    _write_states(cache, new)
                elif not train:
                    new_cache.update(new)
                beta = p["beta"].to(x.dtype)
                y = 0.5 * (beta[0] * y + beta[1] * ym)
            x = _residual(x, y, cfg)
    with scope.span(scope.MOE if "moe" in p else scope.FFN):
        y2, aux = _apply_ffn(p, _norm(x, p["ln2"], cfg), cfg, ctx, specs)
        x = _residual(x, y2, cfg)
    return x, new_cache, aux


def _mamba(mp, h, cfg, opts, cache=None):
    """The mamba mixer of a HYBRID or MAMBA block: the SSD scan (the
    kernel, ``opts.use_flash_kernel``) from zero states in prefill and
    training, the O(1) recurrence from the cache's ``ssm``/``conv`` in
    decode.  Returns (y, {"ssm", "conv"}: the new states)."""
    ssm_state = conv_state = None
    if cache is not None:
        ssm_state, conv_state = cache["ssm"], cache["conv"]
    if cfg.mamba2:
        y, (st, cv) = ssm_mod.mamba2_forward(
            mp, h, n_heads=cfg.mamba_heads, head_dim=cfg.mamba_head_dim,
            state=cfg.ssm_state, eps=cfg.norm_eps,
            chunk=opts.ssm_chunk, ssm_state=ssm_state,
            conv_state=conv_state, use_kernel=opts.use_flash_kernel)
        return y, {"ssm": st, "conv": cv}
    y, (st, cv) = ssm_mod.mamba_forward(
        mp, h, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        state=cfg.ssm_state, chunk=opts.ssm_chunk, ssm_state=ssm_state,
        conv_state=conv_state, use_kernel=opts.use_flash_kernel)
    return y, {"ssm": st, "conv": cv}


def _attention(ap, h, positions, cfg, window, opts, mode, cache, cache_pos,
               tp=None, seq=None):
    """Attention sub-block across the three modes.  Returns (y, cache);
    training returns no cache.  ``tp``: the heads split over a mesh axis
    (``attention.attention_block``)."""
    if mode == "train":
        y, _ = attn_mod.attention_block(
            ap, h, positions, cfg, layer_window=window, q_chunk=opts.q_chunk,
            kv_chunk=opts.kv_chunk, schedule=opts.attn_schedule,
            use_kernel=opts.use_flash_kernel, tp=tp)
        return y, None
    if mode == "prefill":
        # build the cache from scratch; attention runs the flash kernel
        # (causal, q_offset 0, S == Sk, the layer's window)
        q, k, v = attn_mod.project_qkv(ap, h, cfg, positions)
        out = attn_mod.tp_core(
            lambda q_: ops.flash_attention(q_, k, v, causal=True,
                                           window=window), q, tp)
        if window:
            # ring cache: slot i must hold absolute position p with
            # p % w == i, so the kept tail is rolled by S % w
            S = h.shape[1]
            w = min(window, S)
            k = torch.roll(k[:, -w:], S % w, dims=1)
            v = torch.roll(v[:, -w:], S % w, dims=1)
        dtype = model_dtype(cfg)
        return attn_mod.tp_o_proj(out, ap["wo"], tp), {"k": k.to(dtype),
                                                       "v": v.to(dtype)}
    if mode != "decode":
        raise NotImplementedError(f"mode {mode!r}")
    y, kv = attn_mod.attention_block(
        ap, h, positions, cfg, layer_window=window,
        kv_cache=(cache["k"], cache["v"]), cache_pos=cache_pos,
        q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk,
        schedule=opts.attn_schedule, tp=tp, seq=seq)
    return y, {"k": kv[0], "v": kv[1]}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def _index(tree, i: int):
    """The i-th period's slice of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _top(params, name: str, ctx):
    """A top-level leaf (embed, unembed, final_norm) whole: gathered over
    every axis on a mesh."""
    if ctx is None:
        return params[name]
    return smc.gather_spec(params[name], ctx.specs[name])[0]


def _head(params, cfg: ModelConfig, ctx):
    """The unembedding (d, V): the embedding's transpose where the head is
    tied."""
    if cfg.tie_embeddings:
        return _top(params, "embed", ctx).t()
    return _top(params, "unembed", ctx)


def _embed_scaled(x, cfg: ModelConfig):
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def embed_inputs(params, cfg: ModelConfig, tokens, embeds, ctx=None):
    """tokens: (B, S_text) integer or None; embeds: (B, S_front, d) or
    None."""
    parts = []
    with scope.span(scope.EMBED):
        if embeds is not None:
            parts.append(embeds.to(model_dtype(cfg)))
        if tokens is not None:
            parts.append(_top(params, "embed", ctx)[tokens])
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        return _embed_scaled(x, cfg)


def _seq_splits(ctx, cache) -> dict:
    """entry -> ``attention.SeqSplit`` of every decode cache whose k/v
    (period, B, S, Hkv, D) the mesh splits over their sequence."""
    if ctx is None or ctx.cache_specs is None:
        return {}
    out = {}
    for e, specs in ctx.cache_specs.items():
        spec = specs.get("k", ())
        axes = smc.entry_axes(spec[2]) if len(spec) > 2 else ()
        if axes:
            n = cache[e]["k"].shape[2]
            out[e] = attn_mod.SeqSplit(axes, ctx.mesh.axis_index(axes) * n,
                                       n * ctx.mesh.axis_size(axes))
    return out


def _stack_forward(params, x, cfg, opts, mode, cache=None, cache_pos=None,
                   positions=None, ctx=None):
    """Runs the periods in order.  Returns (x, new_cache).  In decode the
    new states (k/v, ssm, conv) are written into ``cache`` in place and
    ``cache`` itself is returned; prefill returns freshly stacked
    caches."""
    entries, n_periods = layer_plan(cfg)
    built: Dict[str, list] = {f"e{i}": [] for i in range(len(entries))}
    seqs = _seq_splits(ctx, cache) if mode == "decode" else {}
    for p in range(n_periods):
        layer_p = _index(params["layers"], p)
        specs = None
        if ctx is not None:
            layer_p, specs = _period_params(
                layer_p, _unstack(ctx.specs["layers"]), ctx)
        for i, spec in enumerate(entries):
            ename = f"e{i}"
            c = _index(cache[ename], p) if cache is not None else None
            x, nc, _ = _apply_entry(layer_p[ename], spec, x, positions,
                                    cfg, opts, mode, cache=c,
                                    cache_pos=cache_pos, ctx=ctx,
                                    specs=specs and specs[ename],
                                    seq=seqs.get(ename))
            built[ename].append(nc)
    if mode == "decode":
        return x, cache
    new_cache = {e: {key: torch.stack([nc[key] for nc in ncs])
                     for key in ncs[0]}
                 for e, ncs in built.items()}
    return x, new_cache


# the products saved by the ``dots_no_batch`` policy: matmuls with no
# batch dimension (``x @ W`` reaches aten as ``mm``), the counterpart of
# jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims; every other
# op of a period, the kernels included, is recomputed in the backward
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _period(layer_p, x, positions, cfg, opts, entries, ctx=None):
    """One period of the stack in training.  Returns (x, aux).  On a
    mesh the period's weights are gathered here, inside its checkpoint
    region (the backward gathers them again)."""
    specs = None
    if ctx is not None:
        layer_p, specs = _period_params(
            layer_p, _unstack(ctx.specs["layers"]), ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(entries):
        x, _, a = _apply_entry(layer_p[f"e{i}"], spec, x, positions, cfg,
                               opts, "train", ctx=ctx,
                               specs=specs and specs[f"e{i}"])
        aux = aux + a
    return x, aux


def _train_stack(params, x, cfg, opts, positions, ctx=None):
    """The periods in order, each one checkpointed with ``opts.remat``:
    ``nothing`` saves only the period's inputs, ``dots_no_batch`` also
    the outputs of its matmuls, ``everything`` saves all (no recompute,
    as without remat).  Returns (x, aux summed over layers)."""
    entries, n_periods = layer_plan(cfg)
    kw = None
    if opts.remat and opts.remat_policy != "everything":
        kw = dict(use_reentrant=False)
        if opts.remat_policy == "dots_no_batch":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_dots)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_periods):
        args = (_index(params["layers"], p), x, positions, cfg, opts,
                entries, ctx)
        x, a = (checkpoint(_period, *args, **kw) if kw is not None
                else _period(*args))
        aux = aux + a
    return x, aux


def forward(params, cfg: ModelConfig, tokens=None, embeds=None, *,
            opts: ModelOptions = ModelOptions(), mesh_args=None):
    """Training forward.  Returns (hidden (B,S,d) after the final norm,
    aux: the MoE aux loss summed over layers, fp32).  ``mesh_args``: a
    ``MeshCtx`` (the rank's blocks; B is its batch rows)."""
    x = embed_inputs(params, cfg, tokens, embeds, mesh_args)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _train_stack(params, x, cfg, opts, positions, mesh_args)
    with scope.span(scope.HEAD):
        return _norm(x, _top(params, "final_norm", mesh_args), cfg), aux


def _chunk_loss(h, lab, unembed, z_loss: float, scaling: float = 1.0):
    """(sum of nll + z-loss, label count) of one sequence chunk; the
    logits divided by ``scaling``."""
    logits = (h @ unembed).float()
    if scaling != 1.0:
        logits = logits / scaling
    lse = torch.logsumexp(logits, dim=-1)
    # gather the label's logit (no one-hot product: no second (B, c, V)
    # fp32 temporary)
    lab_logit = torch.gather(logits, -1,
                             lab.clamp(min=0).long()[..., None])[..., 0]
    mask = (lab >= 0).float()
    nll = (lse - lab_logit) * mask
    zl = z_loss * lse.square() * mask
    return (nll + zl).sum(), mask.sum()


def lm_loss(params, cfg: ModelConfig, hidden, labels, *,
            opts: ModelOptions = ModelOptions(), z_loss: float = 1e-4,
            mesh_args=None):
    """Chunked cross-entropy over the unembedding.  labels: (B,S) integer,
    positions with label < 0 are masked.  Each chunk of ``loss_chunk``
    positions is a checkpoint region, so its (B, chunk, V) fp32 logits
    are recomputed in the backward, not kept.  Returns (loss summed over
    the tokens, n_tokens), fp32."""
    S = hidden.shape[1]
    c = pick_chunk(S, opts.loss_chunk)
    unembed = _head(params, cfg, mesh_args)
    loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ntok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // c):
        l_i, n_i = checkpoint(_chunk_loss, hidden[:, i * c:(i + 1) * c],
                              labels[:, i * c:(i + 1) * c],
                              unembed, z_loss, cfg.logits_scaling,
                              use_reentrant=False)
        loss = loss + l_i
        ntok = ntok + n_i
    return loss, ntok


def loss_fn(params, cfg: ModelConfig, batch, *,
            opts: ModelOptions = ModelOptions(), mesh_args=None):
    """Scalar mean LM loss + 0.01 x the MoE aux.  batch: dict(tokens?,
    embeds?, labels).  Returns (total, {"nll", "aux", "ntok"}).

    On a mesh (``mesh_args``) the batch is this rank's rows, and the
    first value is this rank's share of the global loss, the shares of
    all ranks summing to it: the label count is psum'd over the batch
    axes, and each term is divided by the number of ranks that compute
    it alike (a batch shard's loss by the ranks replicating that shard,
    the aux, the same on every rank, by all of them).  The gradients of
    the shares, summed over the ranks, are the global loss's (the
    convention of ``jax.grad`` through ``shard_map``).  The metrics are
    global: {"nll", "aux", "ntok", "loss"}."""
    hidden, aux = forward(params, cfg, batch.get("tokens"),
                          batch.get("embeds"), opts=opts, mesh_args=mesh_args)
    with scope.span(scope.LOSS):
        loss, ntok = lm_loss(params, cfg, hidden, batch["labels"],
                             opts=opts, mesh_args=mesh_args)
    if mesh_args is None:
        nll = loss / torch.clamp(ntok, min=1.0)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux, "ntok": ntok}
    axes = mesh_args.plan.batch_axes()
    with torch.no_grad():
        ntok = smc.psum(ntok.detach(), axes)
        nll = smc.psum(loss.detach(), axes) / torch.clamp(ntok, min=1.0)
    share = (loss / torch.clamp(ntok, min=1.0) / mesh_args.redundancy()
             + 0.01 * aux / mesh_args.mesh.size)
    return share, {"nll": nll, "aux": aux.detach(), "ntok": ntok,
                   "loss": nll + 0.01 * aux.detach()}


def _unembed_last(params, x, cfg: ModelConfig, ctx=None):
    with scope.span(scope.HEAD):
        h = _norm(x[:, -1:], _top(params, "final_norm", ctx), cfg)
        logits = (h @ _head(params, cfg, ctx))[:, 0].float()
        s = cfg.logits_scaling
        return logits if s == 1.0 else logits / s


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None, *,
            opts: ModelOptions = ModelOptions(), mesh_args=None):
    """Serving prefill.  Returns (last_logits (B,V) fp32, cache)."""
    x = embed_inputs(params, cfg, tokens, embeds, mesh_args)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = _stack_forward(params, x, cfg, opts, "prefill",
                              positions=positions, ctx=mesh_args)
    return _unembed_last(params, x, cfg, mesh_args), cache


def decode_step(params, cfg: ModelConfig, cache, token=None, embed=None,
                pos: Optional[int] = None, *,
                opts: ModelOptions = ModelOptions(), mesh_args=None):
    """One serving step: one new token against the cache.

    token: (B,) integer (or embed: (B,1,d)).  pos: the absolute position
    of this token, a Python int.  Returns (logits (B,V) fp32, cache), with
    the cache updated in place.
    """
    with scope.span(scope.EMBED):
        if embed is None:
            x = _embed_scaled(_top(params, "embed", mesh_args)
                              [token[:, None]], cfg)
        else:
            x = embed.to(model_dtype(cfg))
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    x, cache = _stack_forward(params, x, cfg, opts, "decode", cache=cache,
                              cache_pos=pos, positions=positions,
                              ctx=mesh_args)
    return _unembed_last(params, x, cfg, mesh_args), cache
