"""The yardstick's frozen arithmetic: the card's peaks, the flash kernel's
work and a step's model FLOPs.

Copies, kept here so that a later change to the program cannot move
them: ``PEAK_FLOPS`` and ``HBM_BW`` are NVIDIA's data-sheet rates of one
H100 SXM (dense bf16, HBM3), as ``repro_torch/core/sampling.py`` has them;
``flash_work`` is ``repro_torch/kernels/flash_attention.py::work``; the
model FLOPs correct ``repro_torch/core/roofline.py::model_flops``, which
leaves out attention's causal pairs and counts the head at every prefill
position although prefill makes logits only at the last one.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s, one card, dense
HBM_BW = 3.35e12             # HBM3 bytes/s, one card


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs a causal row set of length S attends to."""
    w = window or S
    if w >= S:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def flash_work(B: int, S: int, H: int, Hkv: int, D: int, window: int = 0
               ) -> tuple:
    """(FLOPs, bytes) of one flash-attention call: QK^T and PV over the
    causal (and window) pairs; q, k, v read once and the output written
    once, bf16."""
    return (4.0 * B * H * causal_pairs(S, window) * D,
            2.0 * (2 * B * S * H * D + 2 * B * S * Hkv * D))


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def layer_matmul_params(m: dict) -> int:
    """Weights of the matmuls one token passes through in one decoder
    layer of the model description ``m`` (``configs/*.json``'s
    ``model``): the q/k/v/o projections, then the gated MLP, or the
    router and its ``top_k`` gated experts."""
    d, H, Hkv, D = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * (H + 2 * Hkv) * D + H * D * d
    moe = m.get("moe")
    if moe:
        ffn = d * moe["n_experts"] + moe["top_k"] * 3 * d * m["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def prefill_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of B prompts of S tokens: 2 per weight
    a token passes through, the head at the last position only, and 4 a
    (query, key) pair a head for attention."""
    L = m["n_layers"]
    dense = 2.0 * B * S * L * layer_matmul_params(m)
    head = 2.0 * B * m["d_model"] * m["vocab"]
    attn = L * 4.0 * B * causal_pairs(S) * m["n_heads"] * m["head_dim"]
    return dense + head + attn


def train_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of one train step on B rows of S tokens: 6 per weight
    a token passes through (the head at every position), and three times
    the forward attention."""
    L = m["n_layers"]
    dense = 6.0 * B * S * (L * layer_matmul_params(m)
                           + m["d_model"] * m["vocab"])
    attn = 3 * L * 4.0 * B * causal_pairs(S) * m["n_heads"] * m["head_dim"]
    return dense + attn
