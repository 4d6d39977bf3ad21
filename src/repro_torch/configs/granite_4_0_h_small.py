"""Granite-4.0-H-Small (32B-A9B), port-only: 40 layers at d 4096, 36
Mamba-2 mixers (128 heads of 64, state 128, one B/C group, conv 4 with
bias, expand 2) and NoPE GQA at layers 5, 15, 25 and 35 (32 q / 8 kv
heads of 128); after every layer a MoE of 72 SwiGLU experts of width 768
(top-10) and a shared SwiGLU expert of width 1536; muP scalars, a tied
head, vocabulary 100352, RMS eps 1e-5
[hf:ibm-granite/granite-4.0-h-small, config.json, model_type
granitemoehybrid].

Every expert is held here (32.2B parameters, 8.8B active a token); the
benchmark's cell holds one card's share of a four-card expert split
(``experts_held`` 18).
"""
from repro_torch.configs.base import (ATTN, MAMBA, HybridMoEConfig,
                                      MoEConfig, register)

M, A = MAMBA, ATTN

CONFIG = register(HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100_352,
    head_dim=128,
    block_pattern=(M, M, M, M, M, A, M, M, M, M),
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=72, top_k=10, capacity_factor=1.25,
                  shared_expert=True),
    ssm_state=128,
    mamba_heads=128,
    mamba_head_dim=64,
    shared_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    use_rope=False,
    tie_embeddings=True,
    norm_eps=1e-5,
    source="hf:ibm-granite/granite-4.0-h-small",
))
