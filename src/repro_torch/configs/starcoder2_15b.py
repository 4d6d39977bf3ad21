"""StarCoder2-15B: dense GQA with RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab=49_152,
    head_dim=128,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=100_000.0,
    source="arXiv:2402.19173; hf",
))
