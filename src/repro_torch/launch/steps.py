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
from repro_torch.core import scope
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


def rows_entry(plan, rows: int):
    """The spec entry of a batch dimension of ``rows`` rows: the plan's
    batch axes, or None (every rank holds the whole batch) where they do
    not divide it, as ``sharding.batch_shardings`` and
    ``cache_shardings`` replicate such a batch."""
    axes = plan.batch_axes()
    return axes if rows % plan.mesh.axis_size(axes) == 0 else None


def batch_rows(batch: dict, plan, n: int = 1, i: int = 0, *,
               strict: bool = True) -> dict:
    """This rank's rows of microbatch ``i`` of ``n`` of a global batch (a
    DTensor is gathered first): the microbatch's rows split over the
    plan's batch axes, as the reference's sharding constraint on the
    split lays them out.  A batch the axes do not divide raises, or, not
    ``strict`` (serving), stays whole on every rank (``rows_entry``)."""
    mesh = plan.mesh
    axes = plan.batch_axes()
    k = mesh.axis_size(axes)
    out = {}
    for name, v in batch.items():
        v = smc.gather_full(v, mesh)
        mb = v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
        if mb.shape[0] % k:
            if not strict:
                out[name] = mb
                continue
            raise ValueError(f"batch_rows: {mb.shape[0]} rows of {name!r} "
                             f"over {axes} ({k} ranks)")
        b = mb.shape[0] // k
        j = mesh.axis_index(axes)
        out[name] = mb[j * b:(j + 1) * b]
    return out


def local_train_step(cfg, plan, opts, opt_cfg, specs, *,
                     grad_compression: bool = False,
                     n_microbatches: int = 1):
    """The sharded train step on one rank's blocks: ``step(lp, lo, mbs)
    -> (lp, lo, metrics)``, ``lp``/``lo`` the local blocks of the params
    and AdamW state (``specs``: the params' storage specs), updated in
    place, ``mbs`` this rank's rows of each microbatch (``batch_rows``).
    The body of ``make_train_step(..., plan=)``; a trace of it
    (``core.export.record_step``) holds the step's collectives."""
    mesh = plan.mesh
    ctx = T.MeshCtx(plan, specs)
    n = n_microbatches

    def step(lp, lo, mbs):
        with smc.bind(mesh):
            gsum = loss_sum = aux = None
            for mb in mbs:
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
        return lp, lo, {"loss": loss_sum / n, **metrics, **om}

    return step


def _sharded_train_step(cfg, plan, opts, opt_cfg, grad_compression,
                        n_microbatches, donate):
    mesh = plan.mesh
    n = n_microbatches

    def local_args(params, opt_state, batch) -> tuple:
        """(``local_train_step``, its arguments: this rank's blocks of
        ``params`` and ``opt_state`` and its microbatch rows)."""
        fn = local_train_step(cfg, plan, opts, opt_cfg,
                              smc.tree_specs(params),
                              grad_compression=grad_compression,
                              n_microbatches=n)
        with smc.bind(mesh):
            mbs = [batch_rows(batch, plan, n, i) for i in range(n)]
        return fn, (tree_map(smc.local, params),
                    tree_map(smc.local, opt_state), mbs)

    def train_step(params, opt_state, batch):
        if not donate:
            params = tree_map(torch.clone, params)
            opt_state = tree_map(torch.clone, opt_state)
        fn, args = local_args(params, opt_state, batch)
        _, _, metrics = fn(*args)
        return params, opt_state, metrics

    train_step.local_args = local_args
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


def compute_cache_specs(cache_specs, specs, plan, rows: int):
    """The layout a sharded step computes each cache leaf in, beside its
    storage layout (``cache_specs``, ``sharding.cache_shardings``): the
    batch over the plan's batch axes (``rows_entry``); k/v with their kv
    heads over the tensor-parallel axis where ``wk`` is split over it
    (``specs``: the params' storage specs), every other dimension whole;
    the other states (mamba, xLSTM) whole, as their weights are gathered
    whole.  ``shardmap_compat.reshard`` moves a leaf between the two."""
    dp = rows_entry(plan, rows)
    tp = plan.model_axis if plan.strategy == "tp" else None
    out = {}
    for e, leaves_ in cache_specs.items():
        wk = specs["layers"].get(e, {}).get("attn", {}).get("wk", ())
        heads = tp if tp is not None and tp in smc.spec_axes(wk) else None
        out[e] = {k: smc.P(None, dp, None, heads, None) if k in ("k", "v")
                  else smc.P(None, dp) for k in leaves_}
    return out


def _reshard_tree(tree, src, dst):
    return {e: {k: smc.reshard(v, src[e][k], dst[e][k])
                for k, v in c.items()} for e, c in tree.items()}


def local_prefill_step(cfg, plan, opts, specs, cache_specs, rows: int):
    """The sharded prefill on one rank's blocks: ``step(lp, mb) ->
    (logits of its rows, its cache blocks)``, the cache moved from the
    layout it is computed in to ``cache_specs``
    (``compute_cache_specs``): a cache split over its sequence keeps this
    rank's slots of every kv head.  ``rows``: the global batch's."""
    mesh = plan.mesh
    ctx = T.MeshCtx(plan, specs)
    compute = compute_cache_specs(cache_specs, specs, plan, rows)

    @torch.no_grad()
    def step(lp, mb):
        with smc.bind(mesh), scope.span(scope.PREFILL):
            logits, cache = T.prefill(lp, cfg, mb.get("tokens"),
                                      mb.get("embeds"), opts=opts,
                                      mesh_args=ctx)
            return logits, _reshard_tree(cache, compute, cache_specs)
    return step


def local_decode_step(cfg, plan, opts, specs, cache_specs, rows: int):
    """The sharded decode on one rank's blocks: ``step(lp, lc, pos,
    token=None, embed=None) -> logits of its rows``, ``lc`` (its cache
    blocks, laid out by ``cache_specs``) updated in place.  The k/v are
    attended where they lie (a split sequence through
    ``attention.split_decode``); every other state is moved to the layout
    it is computed in and its block written back."""
    mesh = plan.mesh
    ctx = T.MeshCtx(plan, specs, cache_specs)
    compute = compute_cache_specs(cache_specs, specs, plan, rows)

    @torch.no_grad()
    def step(lp, lc, pos, token=None, embed=None):
        with smc.bind(mesh), scope.span(scope.DECODE):
            work = {e: {k: v if k in ("k", "v") else smc.reshard(
                v, cache_specs[e][k], compute[e][k]) for k, v in c.items()}
                for e, c in lc.items()}
            logits, _ = T.decode_step(lp, cfg, work, token=token,
                                      embed=embed, pos=pos, opts=opts,
                                      mesh_args=ctx)
            for e, c in work.items():
                for k, v in c.items():
                    if v is not lc[e][k]:
                        lc[e][k].copy_(smc.reshard(v, compute[e][k],
                                                   cache_specs[e][k]))
        return logits
    return step


def make_prefill_step(cfg: ModelConfig, opts: T.ModelOptions, *,
                      plan=None, kv_seq_axis: Optional[str] = None):
    """``prefill_step(params, batch) -> (last logits (B, V) fp32, cache)``.
    With ``plan``: params DTensors, the batch global (or DTensors); the
    logits come back split over the batch axes (``rows_entry``) and the
    cache as DTensors of ``cache_shardings`` (``kv_seq_axis`` as there:
    a cache split over its sequence holds each rank's slots)."""
    if plan is None or plan.mesh is None:
        @torch.no_grad()
        def prefill_step(params, batch):
            with scope.span(scope.PREFILL):
                return T.prefill(params, cfg, batch.get("tokens"),
                                 batch.get("embeds"), opts=opts)
        return prefill_step
    mesh = plan.mesh
    from repro_torch.distributed.sharding import cache_shardings

    def sharded_prefill_step(params, batch):
        rows = next(iter(batch.values())).shape[0]
        seq = sum(v.shape[1] for k, v in batch.items()
                  if k in ("tokens", "embeds"))
        meta = T.init_cache(cfg, rows, seq, device="meta")
        cache_specs = tree_map(lambda s: s.spec, cache_shardings(
            meta, cfg, plan, kv_seq_axis=kv_seq_axis))
        step = local_prefill_step(cfg, plan, opts, smc.tree_specs(params),
                                  cache_specs, rows)
        with smc.bind(mesh):
            mb = batch_rows(batch, plan, strict=False)
        logits, cache = step(tree_map(smc.local, params), mb)
        return (smc.wrap(logits, smc.P(rows_entry(plan, rows), None), mesh),
                tree_map(lambda t, s: smc.wrap(t, s, mesh), cache,
                         cache_specs))
    return sharded_prefill_step


def make_decode_step(cfg: ModelConfig, opts: T.ModelOptions, *, plan=None):
    """``decode_step(params, cache, pos, token=None, embed=None) ->
    (logits (B, V) fp32, cache)``, the cache updated in place.  With
    ``plan``: params and cache DTensors (the cache's local blocks are
    written; a cache split over its sequence is attended slot by slot
    and merged across the ranks), token/embed global (or DTensors); the
    logits come back split over the batch axes."""
    if plan is None or plan.mesh is None:
        @torch.no_grad()
        def decode_step(params, cache, pos, token=None, embed=None):
            with scope.span(scope.DECODE):
                return T.decode_step(params, cfg, cache, token=token,
                                     embed=embed, pos=pos, opts=opts)
        return decode_step
    mesh = plan.mesh

    def sharded_decode_step(params, cache, pos, token=None, embed=None):
        inputs = {k: v for k, v in (("token", token), ("embed", embed))
                  if v is not None}
        rows = next(iter(inputs.values())).shape[0]
        step = local_decode_step(cfg, plan, opts, smc.tree_specs(params),
                                 smc.tree_specs(cache), rows)
        with smc.bind(mesh):
            mb = batch_rows(inputs, plan, strict=False)
        logits = step(tree_map(smc.local, params),
                      tree_map(smc.local, cache), pos, mb.get("token"),
                      mb.get("embed"))
        return (smc.wrap(logits, smc.P(rows_entry(plan, rows), None), mesh),
                cache)
    return sharded_decode_step
