"""Qwen3-32B: dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25_600,
    vocab=151_936,
    head_dim=128,
    block_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
))
