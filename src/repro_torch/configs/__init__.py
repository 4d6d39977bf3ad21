from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, get_config, list_configs,
    ATTN, SWA, MLSTM, SLSTM, HYBRID, MAMBA,
)
