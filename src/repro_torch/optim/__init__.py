from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig, AdamState, init, update, schedule, global_norm)
