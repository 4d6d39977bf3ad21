"""Step functions executed by the serving driver."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, opts: T.ModelOptions):
    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch.get("tokens"),
                         batch.get("embeds"), opts=opts)

    return prefill_step


def make_decode_step(cfg: ModelConfig, opts: T.ModelOptions):
    @torch.no_grad()
    def decode_step(params, cache, pos, token=None, embed=None):
        return T.decode_step(params, cfg, cache, token=token, embed=embed,
                             pos=pos, opts=opts)

    return decode_step
