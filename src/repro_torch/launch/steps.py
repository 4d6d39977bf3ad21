"""Step functions that the training and serving entry points run.

With a sharding plan (``plan=``, a ``distributed.sharding.ShardingPlan``
on a mesh) each step takes and gives DTensors laid out by the plan
(``param_shardings``, ``opt_shardings``, ``cache_shardings``; a batch as
the global tensors every rank holds, or DTensors) and runs as one
``shard_map`` region over the ranks' local blocks: the model computes
with ``transformer.MeshCtx``, each gradient is psum'd over the axes its
parameter is replicated on (the axes it is split on were summed by the
gathers' transpose), and AdamW updates the local blocks in place with
the clip on the global norm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scope import named_scope
from repro_torch.distributed import compression as comp_mod
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map


def _value_and_grad(cfg: ModelConfig, opts: T.ModelOptions, params, batch,
                    ctx=None):
    """(loss, metrics, grads tree) of ``loss_fn`` at ``params``: every
    parameter is taken as a fresh leaf that requires grad (a view of the
    same storage) and ``torch.autograd.grad`` gives the gradients.  This
    is plain autograd, not ``torch.func.grad_and_value``: the func
    transforms do not take the saved-tensor hooks of the remat
    checkpoints.  A parameter the loss does not read (the token embedding
    of a model fed frame embeddings) gets a zero gradient, as
    ``jax.grad`` gives it."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = T.loss_fn(p, cfg, batch, opts=opts, mesh_args=ctx)
        flat = leaves(p)
        grads = dict(zip(map(id, flat), torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: grads[id(t)], p))


def _reduce_grads(grads, specs, mesh):
    """Each local gradient psum'd over the mesh axes its parameter is
    replicated on: every rank's share of the global loss holds part of
    its gradient.  (Over the axes it is split on, the gathers' transpose
    summed them already.)"""
    def one(g, spec):
        axes = tuple(a for a in mesh.axis_names
                     if a not in smc.spec_axes(spec))
        return smc.psum(g, axes) if axes else g
    with torch.no_grad():
        return tree_map(one, grads, specs)


def _compress_global(grads, specs, mesh):
    """The int8 wire model on the global gradients (its blocks of 256
    run over a whole flattened leaf): each gradient gathered, compressed
    and this rank's block kept."""
    def one(g, spec):
        full, _ = smc.gather_spec(g, spec)
        out = comp_mod.ef_compress_tree(full)
        return out[smc.local_slices(full.shape, spec, mesh)]
    with torch.no_grad():
        return tree_map(one, grads, specs)


def batch_rows(batch: dict, plan, n: int = 1, i: int = 0) -> dict:
    """This rank's rows of microbatch ``i`` of ``n`` of a global batch (a
    DTensor is gathered first): the microbatch's rows split over the
    plan's batch axes, as the reference's sharding constraint on the
    split lays them out.  A batch the axes do not divide raises."""
    mesh = plan.mesh
    axes = plan.batch_axes()
    k = mesh.axis_size(axes)
    out = {}
    for name, v in batch.items():
        v = smc.gather_full(v, mesh)
        mb = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
        if mb.shape[0] % k:
            raise ValueError(f"batch_rows: {mb.shape[0]} rows of {name!r} "
                             f"over {axes} ({k} ranks)")
        b = mb.shape[0] // k
        j = mesh.axis_index(axes)
        out[name] = mb[j * b:(j + 1) * b]
    return out


def _sharded_train_step(cfg, plan, opts, opt_cfg, grad_compression,
                        n_microbatches, donate):
    mesh = plan.mesh

    def train_step(params, opt_state, batch):
        specs = smc.tree_specs(params)
        ctx = T.MeshCtx(plan, specs)
        if not donate:
            params = tree_map(torch.clone, params)
            opt_state = tree_map(torch.clone, opt_state)
        lp = tree_map(smc.local, params)
        lo = tree_map(smc.local, opt_state)
        n = n_microbatches
        with smc.bind(mesh):
            gsum = loss_sum = aux = None
            for i in range(n):
                mb = batch_rows(batch, plan, n, i)
                with named_scope("fwd_bwd" if n == 1 else "fwd_bwd_micro"):
                    _, metrics, g = _value_and_grad(cfg, opts, lp, mb, ctx)
                if n > 1:
                    g = tree_map(lambda x: x.float(), g)
                loss = metrics.pop("loss")
                if gsum is None:
                    gsum, loss_sum, aux = g, loss, metrics
                else:
                    gsum = tree_map(torch.add, gsum, g)
                    loss_sum = loss_sum + loss
                    aux = {k: aux[k] + metrics[k] for k in aux}
            grads = _reduce_grads(gsum if n == 1 else tree_map(
                lambda g: g / n, gsum), specs, mesh)
            metrics = {k: v / n for k, v in aux.items()}
            metrics["ntok"] = aux["ntok"]
            if grad_compression:
                with named_scope("grad_compression"):
                    grads = _compress_global(grads, specs, mesh)
            with named_scope("optimizer"), torch.no_grad():
                om = adamw.update_(opt_cfg, grads, lo, lp, specs)
        return params, opt_state, {"loss": loss_sum / n, **metrics, **om}

    return train_step


def make_train_step(cfg: ModelConfig, opts: T.ModelOptions,
                    opt_cfg: adamw.OptConfig, *,
                    grad_compression: bool = False,
                    n_microbatches: int = 1, donate: bool = False,
                    plan=None):
    """``train_step(params, opt_state, batch) -> (new params, new opt
    state, metrics)``: loss and gradients, optionally the int8 wire model
    of the gradients (``grad_compression``), then the AdamW update.  The
    step is functional, as the reference's: it changes nothing it is
    given.  With ``donate`` it takes ``params`` and ``opt_state`` over,
    as ``jax.jit(step, donate_argnums=(0, 1))`` does at the reference's
    call site: the update writes them in place (``adamw.update_``) and
    the step returns the same trees, so a step holds one copy of the
    parameters and the moments, not two; the values are the functional
    step's, bitwise.  With
    ``n_microbatches`` > 1 the batch is split along its first axis and the
    gradients are accumulated in fp32 over the microbatches (activations
    scale with B / n_microbatches); loss and metrics are their means,
    ``ntok`` their sum.

    The phases run under the JAX package's named scopes
    (``core.scope``): the loss and its gradients under ``fwd_bwd``
    (``fwd_bwd_micro`` per microbatch; the backward's ops are made inside
    ``torch.autograd.grad``, so they are in it too), the wire model under
    ``grad_compression`` and the update under ``optimizer``.  The split
    into microbatches, the fp32 accumulation and the division by n are
    in none, as in the reference.

    ``plan``: the sharded step (the module docstring): params and AdamW
    state are DTensor trees, the batch global tensors (or DTensors); the
    microbatches are split from the global batch and each split over the
    batch axes.  With ``grad_compression`` each global gradient is
    gathered for the wire model, so its blocks are the reference's."""
    if plan is not None and plan.mesh is not None:
        return _sharded_train_step(cfg, plan, opts, opt_cfg,
                                   grad_compression, n_microbatches, donate)

    def finish(params, opt_state, loss, metrics, grads):
        if grad_compression:
            with named_scope("grad_compression"):
                grads = comp_mod.ef_compress_tree(grads)
        with named_scope("optimizer"), torch.no_grad():
            if donate:
                om = adamw.update_(opt_cfg, grads, opt_state, params)
                new_p, new_o = params, opt_state
            else:
                new_p, new_o, om = adamw.update(opt_cfg, grads, opt_state,
                                                params)
        return new_p, new_o, {"loss": loss, **metrics, **om}

    def train_step(params, opt_state, batch):
        with named_scope("fwd_bwd"):
            loss, metrics, grads = _value_and_grad(cfg, opts, params, batch)
        return finish(params, opt_state, loss, metrics, grads)

    def train_step_micro(params, opt_state, batch):
        n = n_microbatches
        gsum = loss_sum = aux = None
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()}
            with named_scope("fwd_bwd_micro"):
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


def _wrap_cache(cache, cfg, plan, batch: int, kv_seq_axis):
    """A prefill's local cache blocks as DTensors of the plan's
    ``cache_shardings``.  Each block must be what that layout gives this
    rank: the sharded attention keeps a cache's kv heads split as its kv
    weights are and its sequence whole, so a layout that splits the
    sequence (``kv_seq_axis``, or kv heads the model axis does not
    divide) raises."""
    from repro_torch.distributed.sharding import cache_shardings
    smax = next((e["k"].shape[2] for e in cache.values() if "k" in e), 1)
    meta = T.init_cache(cfg, batch, smax, device="meta")
    shardings = cache_shardings(meta, cfg, plan, kv_seq_axis=kv_seq_axis)

    def one(t, s, m):
        want = tuple(x.stop - x.start for x in smc.local_slices(
            m.shape, s.spec, plan.mesh))
        if tuple(t.shape) != want:
            raise NotImplementedError(
                f"prefill on a mesh: a cache leaf is {tuple(t.shape)} "
                f"here, {s.spec} wants {want} (a cache split over its "
                f"sequence is not ported)")
        return smc.wrap(t, s.spec, plan.mesh)
    return tree_map(one, cache, shardings, meta)


def make_prefill_step(cfg: ModelConfig, opts: T.ModelOptions, *,
                      plan=None, kv_seq_axis: Optional[str] = None):
    """``prefill_step(params, batch) -> (last logits (B, V) fp32, cache)``.
    With ``plan``: params DTensors, the batch global (or DTensors); the
    logits come back split over the batch axes and the cache as DTensors
    of ``cache_shardings`` (``kv_seq_axis`` as there)."""
    if plan is None or plan.mesh is None:
        @torch.no_grad()
        def prefill_step(params, batch):
            return T.prefill(params, cfg, batch.get("tokens"),
                             batch.get("embeds"), opts=opts)
        return prefill_step
    mesh = plan.mesh

    @torch.no_grad()
    def sharded_prefill_step(params, batch):
        ctx = T.MeshCtx(plan, smc.tree_specs(params))
        lp = tree_map(smc.local, params)
        with smc.bind(mesh):
            mb = batch_rows(batch, plan)
            logits, cache = T.prefill(lp, cfg, mb.get("tokens"),
                                      mb.get("embeds"), opts=opts,
                                      mesh_args=ctx)
        rows = next(iter(batch.values())).shape[0]
        return (smc.wrap(logits, smc.P(plan.batch_axes(), None), mesh),
                _wrap_cache(cache, cfg, plan, rows, kv_seq_axis))
    return sharded_prefill_step


def make_decode_step(cfg: ModelConfig, opts: T.ModelOptions, *, plan=None):
    """``decode_step(params, cache, pos, token=None, embed=None) ->
    (logits (B, V) fp32, cache)``, the cache updated in place.  With
    ``plan``: params and cache DTensors (the cache's local blocks are
    written), token/embed global (or DTensors); the logits come back
    split over the batch axes."""
    if plan is None or plan.mesh is None:
        @torch.no_grad()
        def decode_step(params, cache, pos, token=None, embed=None):
            return T.decode_step(params, cfg, cache, token=token,
                                 embed=embed, pos=pos, opts=opts)
        return decode_step
    mesh = plan.mesh

    @torch.no_grad()
    def sharded_decode_step(params, cache, pos, token=None, embed=None):
        ctx = T.MeshCtx(plan, smc.tree_specs(params))
        lp = tree_map(smc.local, params)
        lc = tree_map(smc.local, cache)
        inputs = {k: v for k, v in (("token", token), ("embed", embed))
                  if v is not None}
        with smc.bind(mesh):
            mb = batch_rows(inputs, plan)
            logits, _ = T.decode_step(lp, cfg, lc, token=mb.get("token"),
                                      embed=mb.get("embed"), pos=pos,
                                      opts=opts, mesh_args=ctx)
        return (smc.wrap(logits, smc.P(plan.batch_axes(), None), mesh),
                cache)
    return sharded_decode_step
