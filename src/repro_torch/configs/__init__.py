from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, ShapeConfig, SHAPES, get_config, list_configs,
    shape_applicable,
    ATTN, SWA, MLSTM, SLSTM, HYBRID, MAMBA,
)
