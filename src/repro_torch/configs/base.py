"""Config system for repro_torch: the JAX package's ``ModelConfig`` copied
so that the port imports nothing of ``repro``.

Every architecture the port serves is a ``ModelConfig`` registered under
its public id (e.g. ``"qwen2-1.5b"``).  Configs are plain frozen
dataclasses, hashable and trivially serializable.  Registered so far:
dense GQA (qwen2-1.5b), hybrid attention + mamba (hymba-1.5b), MoE
(granite-moe-1b-a400m) and xLSTM (xlstm-125m); each file is a copy of the
JAX package's (``repro_torch.copies``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds — per-layer building blocks a model may stack.
# ---------------------------------------------------------------------------
ATTN = "attn"            # full causal attention (GQA)
SWA = "swa"              # sliding-window causal attention
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
HYBRID = "hybrid"        # parallel attention + mamba heads (Hymba)
MAMBA = "mamba"          # selective SSM block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert
    moe_every: int = 1           # every Nth layer is MoE (llama4: 2)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    # --- block structure -----------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)   # tiled over n_layers
    window: int = 0             # sliding window size for SWA blocks
    # --- attention details ----------------------------------------------
    qk_norm: bool = False       # qwen3
    qkv_bias: bool = False      # qwen2
    rope_theta: float = 10_000.0
    # --- MoE --------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- SSM / recurrent ---------------------------------------------------
    ssm_state: int = 0          # mamba state size (hymba) / mlstm uses head_dim
    # --- modality frontend (stub): extra embedded inputs ------------------
    frontend: str = "none"      # none | vlm | audio
    frontend_tokens: int = 0    # number of stub embedding positions prepended
    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    # --- citation ----------------------------------------------------------
    source: str = ""

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, tiling block_pattern over n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True if no block requires full quadratic attention."""
        return all(b != ATTN for b in self.blocks)

    @property
    def has_kv_cache(self) -> bool:
        return any(b in (ATTN, SWA, HYBRID) for b in self.blocks)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        qd = self.n_heads * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        total = v * d * 2  # embed + unembed (untied)
        for i, b in enumerate(self.blocks):
            if b in (ATTN, SWA):
                total += d * (qd + 2 * kvd) + qd * d          # qkv + o
                total += self._ffn_params(i)
            elif b == MLSTM:
                # up-proj 2x, qkv over inner dim, gates, down-proj
                inner = 2 * d
                total += d * inner * 2 + inner * d + 3 * inner * self.head_dim
            elif b == SLSTM:
                inner = d
                total += 4 * d * inner + inner * d + d * (4 * d) // 3
            elif b == MAMBA:
                inner = 2 * d
                total += d * inner * 2 + inner * d + inner * (2 * self.ssm_state + 2)
            elif b == HYBRID:
                total += d * (qd + 2 * kvd) + qd * d
                inner = qd  # mamba path sized like attention path
                total += d * inner * 2 + inner * d + inner * (2 * self.ssm_state + 2)
                total += self._ffn_params(i)
            total += 2 * d  # norms
        return total

    def moe_layers(self) -> Tuple[int, ...]:
        """Layer indices whose FFN is MoE."""
        if self.moe is None:
            return ()
        ev = self.moe.moe_every
        return tuple(i for i in range(self.n_layers)
                     if i % ev == ev - 1 and self.blocks[i] in (ATTN, SWA))

    def _ffn_params(self, layer: int = 0) -> int:
        d, f = self.d_model, self.d_ff
        if self.moe is not None and layer in self.moe_layers():
            e = self.moe.n_experts
            p = e * 3 * d * f + d * e  # experts (gated mlp) + router
            if self.moe.shared_expert:
                p += 3 * d * f
            return p
        if f == 0:
            return 0
        return 3 * d * f  # gated (swiglu) mlp

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        e, k = self.moe.n_experts, self.moe.top_k
        d, f = self.d_model, self.d_ff
        inactive = len(self.moe_layers()) * (e - k) * 3 * d * f
        return full - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(4, self.moe.n_experts),
                top_k=min(2, self.moe.top_k))
        return dataclasses.replace(
            self,
            n_layers=min(2, self.n_layers) if len(self.block_pattern) <= 2
            else len(self.block_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(2, self.n_kv_heads) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16,
            window=min(self.window, 64) if self.window else 0,
            frontend_tokens=min(self.frontend_tokens, 8),
            moe=moe,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (the JAX package's ``ShapeConfig`` and ``SHAPES``): train_*
# is a train step's batch; prefill_* and decode_*/long_* a serving step's.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def _load_all() -> None:
    # import side effect registers each config
    from repro_torch.configs import (  # noqa: F401
        granite_moe_1b_a400m, hymba_1_5b, qwen2_1_5b, xlstm_125m)
