"""Hymba-1.5B: hybrid-head — parallel attention + mamba heads in every layer
[arXiv:2411.13676].

Attention path uses sliding-window attention (Hymba uses SWA in all but 3
layers; the SWA majority is modelled).  ssm_state=16 for the mamba path.
25 q heads, GQA kv=5, head_dim=64.
"""
from repro_torch.configs.base import ModelConfig, HYBRID, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    head_dim=64,
    block_pattern=(HYBRID,),
    window=1024,
    ssm_state=16,
    source="arXiv:2411.13676; hf",
))
