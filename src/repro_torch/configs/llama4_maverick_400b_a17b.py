"""Llama-4 Maverick 400B-A17B: MoE 128 experts top-1 + shared expert,
early-fusion multimodal [hf:meta-llama/Llama-4-Scout-17B-16E family].

Early-fusion frontend is a STUB (precomputed patch embeddings via
``input_specs()``).  Every layer's FFN is MoE (128 routed top-1 + 1 shared).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  shared_expert=True, moe_every=2),
    frontend="vlm",
    frontend_tokens=0,  # early fusion: image tokens share the text stream
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
))
