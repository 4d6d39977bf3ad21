"""AdamW + cosine schedule + global-norm clipping over trees of tensors,
the JAX package's ``repro/optim/adamw.py`` (the usual (init, update) pair,
no optimizer library).

A tree is a nested dict of tensors (the model's parameter tree).
``update`` is functional, as the reference's: it returns new parameters
and a new state and changes nothing it is given.  ``update_`` is the
same update with the parameters and the state donated, the counterpart
of ``jax.jit(..., donate_argnums=(0, 1))`` around the reference's step
(``repro/launch/train.py``): it writes the new values into the tensors
it is given.  ``update`` is ``update_`` on copies, so the two agree
bitwise.  The moments are fp32 whatever the parameter's dtype; a
parameter is updated in fp32 and cast back to its own dtype.

The update and the gradient norm walk a leaf one slice at a time: a
leaf under ``"layers"`` (stacked over the periods of the model) by its
leading axis, any other leaf whole.  So no fp32 temporary exceeds one
period's slice of a stacked leaf or one unstacked leaf (the embed, the
unembed): yi-6b's stacked ``w1`` is 2.9 GB in bf16, and whole-leaf fp32
temporaries of it would not fit beside its moments on one 80 GB card.

On a mesh the trees are DTensors (``init`` gives the moments the
parameters' placements) and a sharded step (``launch.steps``) hands
``update_`` their local blocks with the parameters' specs: the update is
elementwise, so it runs on the blocks as they are, and the clip reads
the norm of the global gradient, each leaf's sum of squares psum'd over
the axes its blocks are split over (a replicated leaf is counted once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distributed import shardmap_compat as smc
from repro_torch.tree import leaves, leaves_with_paths, tree_map


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
    """Step 0 and fp32 zero moments on each parameter's device; a DTensor
    parameter's moments are DTensors of its placements (each rank's zeros
    the size of its block)."""
    def zeros(p):
        if isinstance(p, smc.DTensor):
            return smc.like(p, torch.zeros(smc.local(p).shape,
                                           dtype=torch.float32,
                                           device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = leaves(params)[0]
    return AdamState(step=torch.zeros((), dtype=torch.int32,
                                      device=leaf.device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def slices(path: tuple, x: torch.Tensor) -> list:
    """The pieces the update and the norm take one at a time: a
    period-stacked leaf (under ``"layers"``) by its leading axis, any
    other leaf whole.  Views, no copies."""
    return list(x.unbind(0)) if path[:1] == ("layers",) and x.dim() \
        else [x]


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, summed one
    slice (``slices``) at a time in leaf order.  With ``specs`` (a tree of
    ``shardmap_compat.P`` like ``tree``, whose leaves are local blocks, in
    a bound mesh region) the sums of the leaves split over the same axes
    are psum'd over them together: the norm of the global tree."""
    dev = leaves_with_paths(tree)[0][1].device
    spec_of = dict(leaves_with_paths(specs)) if specs is not None else {}
    totals: dict = {}
    for path, x in leaves_with_paths(tree):
        axes = smc.spec_axes(spec_of.get(path, ()))
        total = totals.get(axes)
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=dev)
        for s in slices(path, x):
            total = total + s.float().square().sum()
        totals[axes] = total
    total = None
    for axes, t in totals.items():
        t = smc.psum(t, axes) if axes else t
        total = t if total is None else total + t
    return torch.sqrt(total)


def update_(cfg: OptConfig, grads, state: AdamState, params,
            specs=None) -> dict:
    """The AdamW step with ``params`` and ``state`` donated: the new
    parameters, moments and step are written into the tensors given, one
    slice at a time, and ``grads`` is left as it is.  Returns the metrics
    {"grad_norm", "lr"}.  Callers run it under ``torch.no_grad()``.
    ``specs``: the trees are a rank's local blocks of sharded ones under
    these specs (``global_norm``)."""
    gnorm = global_norm(grads, specs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    state.step.add_(1)
    lr = schedule(cfg, state.step)
    b1c = 1 - cfg.b1 ** state.step.float()
    b2c = 1 - cfg.b2 ** state.step.float()
    flat = zip(leaves_with_paths(grads), leaves_with_paths(state.mu),
               leaves_with_paths(state.nu), leaves_with_paths(params))
    for (path, g), (_, m), (_, v), (_, p) in flat:
        decay = p.dim() >= 2  # decoupled weight decay on matrices only
        for gs, ms, vs, ps in zip(*(slices(path, x) for x in (g, m, v, p))):
            # the functional form's expressions, in place: m = b1 m + (1 -
            # b1) g; v = b2 v + (1 - b2) g^2; delta = (m / b1c) / (sqrt(v /
            # b2c) + eps) (+ wd p); p = p - lr delta
            t = gs.float() * scale
            ms.mul_(cfg.b1).add_((1 - cfg.b1) * t)
            vs.mul_(cfg.b2).add_(t.square_().mul_(1 - cfg.b2))
            torch.div(vs, b2c, out=t).sqrt_().add_(cfg.eps)
            delta = torch.div(ms, b1c).div_(t)
            if decay:
                delta.add_(t.copy_(ps).mul_(cfg.weight_decay))
            ps.copy_(t.copy_(ps).sub_(delta.mul_(lr)))
    return {"grad_norm": gnorm, "lr": lr}


def update(cfg: OptConfig, grads, state: AdamState, params):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}):
    ``update_`` on copies of ``params`` and ``state``, which it leaves as
    they are."""
    new_p = tree_map(torch.clone, params)
    new_s = tree_map(torch.clone, state)
    return new_p, new_s, update_(cfg, grads, new_s, new_p)
