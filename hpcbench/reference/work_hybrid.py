"""The yardstick's frozen arithmetic for the Mamba-2 hybrid
(``reference/granite_hybrid.py``'s model description): a prefill's model
FLOPs and the SSD scan's work.  Kept here so that a later change to the
program cannot move them; the card's peaks are ``work.py``'s."""
from __future__ import annotations

from hpcbench.reference.work import causal_pairs


def layer_matmul_params(m: dict, kind: str) -> float:
    """Weights of the matmuls one token passes through in one layer: the
    mixer's in_proj and out_proj or attention's q/k/v/o, then the
    router, ``top_k * held / n_experts`` of this card's routed experts
    (the expected share of a token's top_k that lands here) and the shared
    expert."""
    d = m["d_model"]
    if kind == "mamba":
        inner = m["mamba_heads"] * m["mamba_head_dim"]
        width = 2 * inner + 2 * m["mamba_groups"] * m["ssm_state"] \
            + m["mamba_heads"]
        mixer = d * width + inner * d
    else:
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        mixer = d * (H + 2 * Hkv) * D + H * D * d
    moe = m["moe"]
    routed = moe["top_k"] * moe["held"] / moe["n_experts"]
    ffn = d * moe["n_experts"] + routed * 3 * d * m["d_ff"] \
        + 3 * d * m["shared_ff"]
    return mixer + ffn


def prefill_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of one prefill of B prompts of S tokens: 2 a weight a
    token passes through, the head at the last position only, 4 a
    (query, key) pair a head in attention, and the scan as its
    recurrence, 4 hd st a head a token (the state update and the output
    product), whatever the chunk."""
    period = m["block_pattern"]
    kinds = [period[i % len(period)] for i in range(m["n_layers"])]
    dense = sum(2.0 * B * S * layer_matmul_params(m, k) for k in kinds)
    n_attn = sum(k != "mamba" for k in kinds)
    attn = n_attn * 4.0 * B * causal_pairs(S) * m["n_heads"] \
        * m["head_dim"]
    scan = (len(kinds) - n_attn) * 4.0 * B * S * m["mamba_heads"] \
        * m["mamba_head_dim"] * m["ssm_state"]
    head = 2.0 * B * m["d_model"] * m["vocab"]
    return dense + attn + scan + head


def ssd_work(B: int, S: int, nh: int, hd: int, st: int) -> tuple:
    """(FLOPs, bytes) of one SSD scan call: the recurrence's 4 hd st a
    head a token; xv and y (bf16), logdecay (fp32), B and C (bf16) and
    the final state (fp32), each byte once."""
    flops = 4.0 * B * S * nh * hd * st
    nbytes = (2 * B * S * nh * hd * 2 + B * S * nh * 4 + 2 * B * S * st * 2
              + B * nh * hd * st * 4)
    return flops, float(nbytes)
