from repro_torch.configs.base import (  # noqa: F401
    HybridMoEConfig, ModelConfig, MoEConfig, PORT_ONLY, ShapeConfig, SHAPES,
    get_config, list_configs, shape_applicable,
    ATTN, SWA, MLSTM, SLSTM, HYBRID, MAMBA,
)
