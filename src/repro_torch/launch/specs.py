"""Shape-and-dtype stand-ins for every model input, on the meta device:
the single-device half of the JAX package's ``repro/launch/specs.py``.

A stand-in is a tensor on ``torch.device("meta")``: it has the shape and
dtype of the real input and no storage, so a model's parameters, caches
and batches are reckoned (bytes, shapes) before anything is allocated,
as the reference reckons them with ``jax.eval_shape`` and
``ShapeDtypeStruct``.  The frontends' batch layout lives here
(``batch_struct``): an audio model takes frame embeddings in place of
tokens, a vlm model a prefix of patch embeddings before its text.
Sharding plans are the multi-device slice: ``input_specs`` raises on
one.
"""
from __future__ import annotations

import types
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves

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

    ``plan`` and ``kv_seq_axis`` (the reference's sharding) raise:
    sharding waits for the multi-device slice."""
    if plan is not None or kv_seq_axis is not None:
        raise NotImplementedError("input_specs: sharding plans are not "
                                  "ported (multi-device)")
    out: Dict = {"params": params_struct(cfg)}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_struct(cfg, shape)
        if shape.kind == "train":
            out["opt_state"] = opt_struct(out["params"])
    else:
        out.update(decode_struct(cfg, shape))
    return out
