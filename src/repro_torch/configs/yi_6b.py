"""Yi-6B: llama-architecture dense transformer with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab=64_000,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
))
