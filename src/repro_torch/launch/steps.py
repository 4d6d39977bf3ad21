"""Step functions that the training and serving entry points run."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import compression as comp_mod
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map


def _value_and_grad(cfg: ModelConfig, opts: T.ModelOptions, params, batch):
    """(loss, metrics, grads tree) of ``loss_fn`` at ``params``: every
    parameter is taken as a fresh leaf that requires grad (a view of the
    same storage) and ``torch.autograd.grad`` gives the gradients.  This
    is plain autograd, not ``torch.func.grad_and_value``: the func
    transforms do not take the saved-tensor hooks of the remat
    checkpoints."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = T.loss_fn(p, cfg, batch, opts=opts)
        flat = leaves(p)
        grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: grads[id(t)], p))


def make_train_step(cfg: ModelConfig, opts: T.ModelOptions,
                    opt_cfg: adamw.OptConfig, *,
                    grad_compression: bool = False,
                    n_microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (new params, new opt
    state, metrics)``: loss and gradients, optionally the int8 wire model
    of the gradients (``grad_compression``), then the AdamW update.  With
    ``n_microbatches`` > 1 the batch is split along its first axis and the
    gradients are accumulated in fp32 over the microbatches (activations
    scale with B / n_microbatches); loss and metrics are their means,
    ``ntok`` their sum."""

    def finish(params, opt_state, loss, metrics, grads):
        if grad_compression:
            grads = comp_mod.ef_compress_tree(grads)
        with torch.no_grad():
            new_p, new_o, om = adamw.update(opt_cfg, grads, opt_state,
                                            params)
        return new_p, new_o, {"loss": loss, **metrics, **om}

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _value_and_grad(cfg, opts, params, batch)
        return finish(params, opt_state, loss, metrics, grads)

    def train_step_micro(params, opt_state, batch):
        n = n_microbatches
        gsum = loss_sum = aux = None
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics, g = _value_and_grad(cfg, opts, params, mb)
            g = tree_map(lambda x: x.float(), g)
            if gsum is None:
                gsum, loss_sum, aux = g, loss, metrics
            else:
                gsum = tree_map(torch.add, gsum, g)
                loss_sum = loss_sum + loss
                aux = {k: aux[k] + metrics[k] for k in aux}
        grads = tree_map(lambda g: g / n, gsum)
        metrics = {k: v / n for k, v in aux.items()}
        metrics["ntok"] = aux["ntok"]
        return finish(params, opt_state, loss_sum / n, metrics, grads)

    return train_step if n_microbatches <= 1 else train_step_micro


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
