"""Shape-and-dtype stand-ins for every model input, on the meta device:
the single-device half of the JAX package's ``repro/launch/specs.py``.

A stand-in is a tensor on ``torch.device("meta")``: it has the shape and
dtype of the real input and no storage, so a model's parameters, caches
and batches are reckoned (bytes, shapes) before anything is allocated,
as the reference reckons them with ``jax.eval_shape`` and
``ShapeDtypeStruct``.  The frontends' batch layout lives here
(``batch_struct``): an audio model takes frame embeddings in place of
tokens, a vlm model a prefix of patch embeddings before its text.
With a sharding plan ``input_specs`` gives each input's sharding beside
it (``distributed.sharding``): the stand-ins stay global, as a
``ShapeDtypeStruct`` with a sharding is.
"""
from __future__ import annotations

import types
from typing import Dict

import torch

from repro_torch.configs.base import ATTN, ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves, leaves_with_paths

META = torch.device("meta")
# init_params reads only ``gen.device``; on the meta device dense_init
# draws nothing, so this stands in for a generator
_META_GEN = types.SimpleNamespace(device=META)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract training/prefill batch for one architecture x shape."""
    B, S = shape.global_batch, shape.seq_len
    batch: Dict = {}
    if cfg.frontend == "audio":
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    elif cfg.frontend == "vlm" and cfg.frontend_tokens:
        F = min(cfg.frontend_tokens, S // 2)
        batch["embeds"] = _meta((B, F, cfg.d_model), torch.bfloat16)
        batch["tokens"] = _meta((B, S - F), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    return batch


def decode_struct(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract decode-step inputs: one new token (or frame embedding)
    and a cache of ``seq_len`` slots."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict = {"cache": T.init_cache(cfg, B, S, device=META),
                 "pos": _meta((), torch.int32)}
    if cfg.frontend == "audio":
        out["embed"] = _meta((B, 1, cfg.d_model), torch.bfloat16)
    else:
        out["token"] = _meta((B,), torch.int32)
    return out


def params_struct(cfg: ModelConfig):
    """The parameter tree of ``transformer.init_params``, on the meta
    device."""
    return T.init_params(_META_GEN, cfg)


def opt_struct(params):
    return adamw.init(params)


def nbytes(tree) -> int:
    """Bytes of a tree's leaves (real or meta)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, plan=None,
                kv_seq_axis=None) -> Dict:
    """Abstract inputs for the step function this shape runs:

    train  -> {params, opt_state, batch}
    prefill-> {params, batch}
    decode -> {params, cache, token/embed, pos}

    With a ``plan`` on a mesh (a real or an abstract one,
    ``launch.mesh.abstract_mesh``) the result also holds ``shardings``:
    the same keys, each a tree of ``sharding.Sharding`` (spec and DTensor
    placements) beside its stand-ins, as the reference's structs carry
    theirs; ``kv_seq_axis`` as ``sharding.cache_shardings``."""
    from repro_torch.distributed import sharding as shard_mod
    out: Dict = {"params": params_struct(cfg)}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_struct(cfg, shape)
        if shape.kind == "train":
            out["opt_state"] = opt_struct(out["params"])
    else:
        out.update(decode_struct(cfg, shape))
    if plan is None or plan.mesh is None:
        return out
    p_sh = shard_mod.param_shardings(out["params"], cfg, plan)
    sh: Dict = {"params": p_sh}
    if "batch" in out:
        sh["batch"] = shard_mod.batch_shardings(out["batch"], plan)
    if "opt_state" in out:
        sh["opt_state"] = shard_mod.opt_shardings(out["opt_state"], p_sh)
    if "cache" in out:
        sh["cache"] = shard_mod.cache_shardings(out["cache"], cfg, plan,
                                                kv_seq_axis=kv_seq_axis)
    out["shardings"] = sh
    return out


def train_memory(cfg: ModelConfig, batch: int, seq: int,
                 opts: T.ModelOptions = T.ModelOptions()) -> Dict:
    """The bytes a donated train step (``launch.train.train``) holds on
    one device, part by part, and the peak they reckon: the largest of
    three phases of the step.

    - ``weights``, ``grads`` (each leaf's dtype), ``moments`` (two fp32
      copies): ``params_struct``'s leaves;
    - ``activations``: what the remat policy ``dots_no_batch`` saves for
      the backward, bf16: each period's input and the outputs of its
      matmuls (q, k, v, the output projection, w1, w3, w2: per token 3d +
      H·D + 2·Hkv·D + 2·ff), and the final norm's saved values (its fp32
      input, its output and the loss's input: 8 bytes a model value);
    - ``loss_chunk``: one chunk's backward, 18 bytes a logit of
      ``loss_chunk`` positions: the recomputed fp32 logits, the fp32
      exponentials of the log-sum-exp, the fp32 scatter of the label
      gradient, the fp32 gradient of the logits and its bf16 cast (on an
      H100, qwen2-1.5b's 4 x 512 step peaked in this phase at 26.90 GB,
      where 10 bytes a logit reckoned 24.19);
    - ``select_transient``: the largest stacked leaf's full-size gradient
      that one layer's ``tree[i]`` (SelectBackward) makes before it is
      added to the leaf's gradient;
    - ``recompute``: one period's backward: the flash kernel's plain
      recompute backward (four fp32 (B, H, S, S) score-sized tensors) and
      the period's recomputed fp32 norms and FFN values;
    - ``update``: three fp32 copies of the largest piece the update takes
      at a time (``adamw.slices``: a period's slice of a stacked leaf, or
      the embed or unembed whole).

    The phases: the loss's backward (weights, moments, the unembed's
    gradient, activations, the loss chunk); the layers' backward
    (weights, moments, every gradient but the embed's, activations, one
    SelectBackward transient, one period's recompute); the update
    (weights, gradients, moments, the update's temporaries).  Modelled
    for stacks of attention layers with a dense FFN (the configurations
    that train on one card); raises on others."""
    if any(k != ATTN for k in cfg.blocks) or cfg.moe is not None:
        raise NotImplementedError(f"train_memory: {cfg.name}'s blocks "
                                  f"{sorted(set(cfg.blocks))} are not "
                                  f"modelled")
    params = params_struct(cfg)
    weights = nbytes(params)
    n = sum(t.numel() for t in leaves(params))
    d, ff = cfg.d_model, cfg.d_ff
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tokens = batch * seq
    per_token = 3 * d + H * D + 2 * Hkv * D + 2 * ff
    parts = dict(
        weights=weights, grads=weights, moments=8 * n,
        activations=2 * tokens * per_token * cfg.n_layers + 8 * tokens * d,
        loss_chunk=18 * batch * min(seq, opts.loss_chunk) * cfg.vocab,
        select_transient=max(t.numel() * t.element_size()
                             for path, t in leaves_with_paths(params)
                             if path[0] == "layers"),
        recompute=16 * batch * H * seq * seq + 4 * tokens * (2 * d + ff),
        update=12 * max(x.numel() for path, t in leaves_with_paths(params)
                        for x in adamw.slices(path, t)))
    embed = params["embed"]
    phases = dict(
        loss_backward=parts["weights"] + parts["moments"]
        + nbytes(params["unembed"]) + parts["activations"]
        + parts["loss_chunk"],
        layers_backward=parts["weights"] + parts["moments"]
        + parts["grads"] - embed.numel() * embed.element_size()
        + parts["activations"] + parts["select_transient"]
        + parts["recompute"],
        update=parts["weights"] + parts["grads"] + parts["moments"]
        + parts["update"])
    return dict(parts=parts, phases=phases, peak=max(phases.values()),
                batch=batch, seq=seq)
