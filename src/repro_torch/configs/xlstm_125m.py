"""xLSTM-125M: sLSTM + mLSTM blocks [arXiv:2405.04517].

12 layers, d_model=768, 4 heads, no FFN (xLSTM blocks carry their own
projections).  xLSTM[x:1]-style mix: every 6th layer is sLSTM (layers 5, 11),
the rest mLSTM.  GQA kv=4 applies to the mLSTM q/k/v heads.
Sub-quadratic (recurrent) => long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, MLSTM, SLSTM, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    head_dim=192,
    block_pattern=(MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, SLSTM),
    source="arXiv:2405.04517; unverified",
))
