"""MusicGen-large: decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

The EnCodec frontend is a STUB per spec: ``input_specs()`` supplies
precomputed frame embeddings; the backbone is a plain decoder-only
transformer (kv=32 => full MHA) over vocab=2048 codebook entries.
"""
from repro_torch.configs.base import ModelConfig, ATTN, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    block_pattern=(ATTN,),
    frontend="audio",
    frontend_tokens=0,  # frame embeddings replace token embeddings
    source="arXiv:2306.05284; hf",
))
