from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, AdamState, init, update, update_, schedule, global_norm)
