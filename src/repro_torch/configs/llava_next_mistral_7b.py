"""LLaVA-NeXT (Mistral-7B backbone): VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision frontend is a STUB per spec: ``input_specs()`` supplies
precomputed patch embeddings (anyres => up to 2880 patch positions) that the
backbone consumes alongside text tokens.
"""
from repro_torch.configs.base import ModelConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=32_000,
    head_dim=128,
    block_pattern=(ATTN,),
    rope_theta=1_000_000.0,
    frontend="vlm",
    frontend_tokens=2880,  # anyres: 5 tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
))
