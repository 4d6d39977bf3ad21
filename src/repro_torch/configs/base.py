"""Config system for repro_torch: the JAX package's ``ModelConfig`` copied
so that the port imports nothing of ``repro``.

Every architecture of the JAX package is a ``ModelConfig`` registered
under its public id (e.g. ``"qwen3-32b"``).  Configs are plain frozen
dataclasses, hashable and trivially serializable.  All ten are
registered, each file a copy of the JAX package's (``repro_torch.copies``):
dense GQA (qwen2-1.5b, qwen3-32b with qk-norm, yi-6b, starcoder2-15b),
hybrid attention + mamba (hymba-1.5b), MoE (granite-moe-1b-a400m,
llama4-maverick-400b-a17b with a shared expert every second layer),
xLSTM (xlstm-125m) and the two stub frontends: vlm patch embeddings
before text (llava-next-mistral-7b) and audio frame embeddings in place
of tokens (musicgen-large).

One more is the port's own, with no counterpart in the JAX package:
granite-4.0-h-small, a ``HybridMoEConfig`` (Mamba-2 mixers beside NoPE
GQA, each followed by a MoE and a shared expert, with granite's muP
scalars and a tied head).  Its knobs are fields of that subclass only;
``ModelConfig`` holds them as class constants at their off values, so
``dataclasses.asdict`` of the ten shared configurations stays the JAX
package's.
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

    # --- the port's own knobs, off: class constants, not fields (see the
    # module docstring); ``HybridMoEConfig`` makes them fields ------------
    mamba_heads = 0             # Mamba-2 heads (0: the mixer is Hymba's)
    mamba_head_dim = 0
    shared_ff = 0               # the shared expert's width (0: d_ff)
    embedding_multiplier = 1.0
    residual_multiplier = 1.0
    attention_multiplier = 0.0  # the scores' scale (0: head_dim ** -0.5)
    logits_scaling = 1.0        # logits are divided by it
    use_rope = True
    tie_embeddings = False
    norm_eps = 1e-6
    experts_held = 0            # experts this device holds (0: all)

    @property
    def mamba2(self) -> bool:
        """A MAMBA entry is a Mamba-2 mixer with heads of its own,
        followed by the FFN; otherwise Hymba's mixer alone."""
        return self.mamba_heads > 0

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


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A port-only hybrid (granite-4.0-h): Mamba-2 mixers (``mamba_heads``
    of ``mamba_head_dim``, one B/C group, state ``ssm_state``, inner width
    ``mamba_heads * mamba_head_dim``) and
    attention layers, each layer followed by the MoE (every layer:
    ``moe_every`` 1) plus a shared expert of width ``shared_ff``; the muP
    scalars (embedding times ``embedding_multiplier``, every residual
    branch times ``residual_multiplier``, scores times
    ``attention_multiplier``, logits over ``logits_scaling``), rope or
    none (``use_rope``), a tied head, RMS eps ``norm_eps``.  The device
    holds the first ``experts_held`` experts of every MoE layer (0: all
    of them; the shares of a four-card split are alike, so one card
    stands for each) and routes over all ``moe.n_experts``."""
    mamba_heads: int = 0
    mamba_head_dim: int = 0
    shared_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0
    use_rope: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    experts_held: int = 0

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def held(self) -> int:
        """Experts this device holds."""
        return self.experts_held or self.moe.n_experts

    def moe_layers(self) -> Tuple[int, ...]:
        """Every layer, mixer or attention, is followed by the MoE."""
        return tuple(range(self.n_layers))

    def mamba_params(self) -> int:
        """One Mamba-2 mixer: in_proj to [z, xBC, dt], the conv over xBC
        with its bias, dt_bias, A_log, D, the gated norm, out_proj."""
        d, inner, nh = self.d_model, self.mamba_inner, self.mamba_heads
        conv = inner + 2 * self.ssm_state
        return (d * (inner + conv + nh) + conv * 5 + 3 * nh + inner
                + inner * d)

    def _moe_params(self, experts: float) -> float:
        d, f = self.d_model, self.d_ff
        return (experts * 3 * d * f + d * self.moe.n_experts
                + 3 * d * (self.shared_ff or f))

    def _count(self, experts: float) -> int:
        d = self.d_model
        qd, kvd = self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2) + d
        for b in self.blocks:
            total += (self.mamba_params() if b == MAMBA
                      else d * (qd + 2 * kvd) + qd * d)
            total += self._moe_params(experts) + 2 * d
        return int(round(total))

    def n_params(self) -> int:
        """The parameters this device holds: its experts of each layer
        and everything else whole."""
        return self._count(self.held)

    def n_active_params(self) -> int:
        """Parameters a token passes through here: top_k of the
        n_experts routed experts, so top_k * held / n_experts of this
        device's on average (top_k with every expert held)."""
        return self._count(self.moe.top_k * self.held / self.moe.n_experts)

    def reduced(self) -> "HybridMoEConfig":
        """One period at tiny widths, every expert held, in fp32."""
        r = super().reduced()
        return dataclasses.replace(
            r, n_layers=len(self.block_pattern), mamba_heads=4,
            mamba_head_dim=16, ssm_state=16, shared_ff=48, experts_held=0)


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


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k requires sub-quadratic sequence mixing."""
    if shape.name == "long_500k":
        quad = [b for b in set(model.blocks) if b == ATTN]
        if quad:
            return False, ("SKIP: pure full-attention blocks are quadratic/"
                           "O(S) KV at 512k; per DESIGN.md only sub-quadratic "
                           "archs run long_500k")
    return True, ""


_REGISTRY: dict = {}
# registered configurations with no counterpart in the JAX package
PORT_ONLY = ("granite-4.0-h-small",)


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
        xlstm_125m, yi_6b, qwen2_1_5b, starcoder2_15b, qwen3_32b,
        llava_next_mistral_7b, llama4_maverick_400b_a17b,
        granite_moe_1b_a400m, musicgen_large, hymba_1_5b,
        granite_4_0_h_small)
