"""Granite-3.0 1B-A400M: MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    head_dim=64,
    block_pattern=(ATTN,),
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
