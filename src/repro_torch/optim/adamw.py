"""AdamW + cosine schedule + global-norm clipping over trees of tensors,
the JAX package's ``repro/optim/adamw.py`` (the usual (init, update) pair,
no optimizer library).

A tree is a nested dict of tensors (the model's parameter tree).
``update`` is functional, as the reference's: it returns new parameters
and a new state and changes nothing it is given, so a train step can be
traced whole (``core.export.trace_train_step``).  The moments are fp32
whatever the parameter's dtype; a parameter is updated in fp32 and cast
back to its own dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_frac`` of it at ``total_steps``; fp32 scalar."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params) -> AdamState:
    """Step 0 and fp32 zero moments on each parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = leaves(params)[0]
    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=leaf.device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in leaves(tree)))


def update(cfg: OptConfig, grads, state: AdamState, params):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, grads, state.mu, state.nu, params)
    new_p, new_m, new_v = (tree_map(lambda o: o[i], out) for i in range(3))
    return new_p, AdamState(step, new_m, new_v), {"grad_norm": gnorm,
                                                  "lr": lr}
