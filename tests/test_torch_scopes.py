"""The train step's named scopes (``repro_torch.core.scope``) against the
JAX package's, on the CPU: the traced train step of reduced qwen2 (cut to
one layer: the scopes do not depend on depth) with the int8 gradient wire
model and with 2 microbatches, and a profiled ``train()`` aggregated to a
database.

The reference puts the loss and its gradients under ``fwd_bwd``
(``fwd_bwd_micro`` per microbatch), the wire model under
``grad_compression`` and the AdamW update under ``optimizer``
(``repro/launch/steps.py``); every op of its compiled train step carries
those names in its ``op_name``.  The port's traced step must carry them in
the same places."""
import collections
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import export, scope
from repro_torch.core.aggregate import aggregate
from repro_torch.distributed import compression
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

NAME, B, S = "qwen2-1.5b", 2, 32
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
STEPS = {"compression": dict(grad_compression=True),
         "microbatches": dict(n_microbatches=2)}
# the ops the microbatch step runs outside any scope, as the reference
# does: the split of the batch, the fp32 accumulation of the gradients
# and the division of the sums by n
UNSCOPED = {"view", "select", "add", "div"}


def inputs():
    cfg = dataclasses.replace(get_config(NAME).reduced(), n_layers=1)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)))
    return cfg, params, {"tokens": toks, "labels": toks.int()}


@functools.lru_cache(maxsize=None)
def traced(kind):
    """The port's traced train step of reduced qwen2 (``kind``'s options)
    as an ``HloModule``."""
    cfg, params, batch = inputs()
    fn = steps.make_train_step(cfg, T.ModelOptions(**CHUNKS),
                               adamw.OptConfig(), **STEPS[kind])
    return export.module_from_graph("train_step", export.trace_train_step(
        fn, (params, adamw.init(params), batch)))


@functools.lru_cache(maxsize=None)
def jax_scopes(kind):
    """The reference's scope names found among the elements of the
    ``op_name``s of its compiled train step at the same configuration
    (lowered from the inputs' shapes alone)."""
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(), n_layers=1)
    jp = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    fn = jax.jit(jsteps.make_train_step(jcfg, None, JT.ModelOptions(**CHUNKS),
                                        jadamw.OptConfig(), **STEPS[kind]))
    hlo = fn.lower(jp, jax.eval_shape(jadamw.init, jp),
                   {"tokens": toks, "labels": toks}).compile().as_text()
    return {el for name in re.findall(r'op_name="([^"]*)"', hlo)
            for el in name.split("/") if el in scope.TRAIN_SCOPES}


def scopes_of(op):
    """The scope names in an op's chain, and its leaf."""
    parts = op.op_name.split("/")
    return [p for p in parts[1:-1] if p in scope.TRAIN_SCOPES], parts[-1]


@pytest.mark.parametrize("kind", STEPS)
def test_every_node_lies_under_its_phase(kind):
    """Every node of the traced step has an ``op_name`` whose chain starts
    with exactly one scope (the 2 flash custom-calls a microbatch
    included: the forward and the remat recompute), except, in the microbatch step, the split, the
    accumulation and the division, which lie under none; the scope names
    are those the reference's compiled step carries."""
    module = traced(kind)
    seen, unscoped = collections.Counter(), collections.Counter()
    for op in module.all_ops():
        if not op.op_name:
            assert op.opcode in ("parameter", "constant", "tuple"), op
            continue
        names, leaf = scopes_of(op)
        if not names:
            unscoped[leaf] += 1
            continue
        assert len(names) == 1 and op.op_name.split("/")[1] == names[0], \
            op.op_name
        seen[names[0]] += 1
    want = {"compression": {"fwd_bwd", "grad_compression", "optimizer"},
            "microbatches": {"fwd_bwd_micro", "optimizer"}}[kind]
    assert set(seen) == want == jax_scopes(kind)
    if kind == "compression":
        assert not unscoped
    else:
        assert unscoped and set(unscoped) <= UNSCOPED, unscoped
    calls = [op for op in module.all_ops() if op.opcode == "custom-call"]
    n = STEPS[kind].get("n_microbatches", 1)
    assert len(calls) == 2 * n
    assert {scopes_of(op)[0][0] for op in calls} == \
        ({"fwd_bwd_micro"} if n > 1 else {"fwd_bwd"})


def leaf_counts(fn, *args):
    """The aten ops of ``fn(*args)`` traced alone, counted by name."""
    with torch.no_grad():
        module = export.module_from_graph("alone",
                                          export.trace_train_step(fn, args))
    return collections.Counter(op.op_name.split("/")[-1]
                               for op in module.all_ops() if op.op_name)


def test_each_phase_holds_its_function_whole():
    """The ops under ``optimizer`` are those of ``adamw.update`` traced
    alone on the same trees, and those under ``grad_compression`` those
    of ``ef_compress_tree``: no op of either phase is left outside its
    scope, and none of another phase is let in.  Neither phase runs model
    code, and neither borrows the model frames of the backward ops that
    made its gradients: their chains hold the scope alone."""
    cfg, params, _ = inputs()
    module = traced("compression")
    got = collections.defaultdict(collections.Counter)
    for op in module.all_ops():
        if op.op_name:
            names, leaf = scopes_of(op)
            got[names[0]][leaf] += 1
            if names[0] != "fwd_bwd":
                assert op.op_name == f"train_step/{names[0]}/{leaf}", \
                    op.op_name
    grads = T.init_params(torch.Generator().manual_seed(1), cfg)
    assert got["grad_compression"] == leaf_counts(
        compression.ef_compress_tree, grads)
    assert got["optimizer"] == leaf_counts(
        lambda g, s, p: adamw.update(adamw.OptConfig(), g, s, p),
        grads, adamw.init(params), params)


def test_scopes_are_profiler_ranges_when_run():
    """Run (not traced), a scope is a torch.profiler range of its name:
    one step on the CPU under torch.profiler records ``fwd_bwd``,
    ``grad_compression`` and ``optimizer`` once each; traced, the
    scopes record no range node into the graph."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, batch = inputs()
    fn = steps.make_train_step(cfg, T.ModelOptions(**CHUNKS),
                               adamw.OptConfig(), grad_compression=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(params, adamw.init(params), batch)
    counts = collections.Counter(e.name for e in prof.events())
    assert all(counts[n] == 1 for n in ("fwd_bwd", "grad_compression",
                                        "optimizer")), counts
    assert not scope.active()
    assert not any("record_function" in op.op_name
                   for op in traced("compression").all_ops())


def test_profiled_train_shows_the_scopes_under_train_step(tmp_path):
    """A profiled ``train()`` with the wire model, aggregated: the
    top-down view under the ``kernel:train_step`` placeholder holds the
    step's frame, and under it the three scopes as its first level; every
    PC sample under the placeholder lies in one of them
    (``scope.shares``)."""
    from repro_torch.core import viewer
    cfg, _, _ = inputs()
    _, hist, paths = train(cfg, ShapeConfig("t", S, B, "train"), n_steps=2,
                           log_every=1, profile_dir=str(tmp_path / "p"),
                           opts=T.ModelOptions(**CHUNKS), device="cpu",
                           grad_compression=True)
    profiles = sorted(v for k, v in paths.items()
                      if k.startswith(("cpu_", "gpu_")) and "trace" not in k)
    db = aggregate(profiles, str(tmp_path / "db"))
    got = scope.shares(db)
    assert got["fwd_bwd_micro"] == 0.0
    assert all(got[n] > 0 for n in ("fwd_bwd", "grad_compression",
                                    "optimizer")), got
    assert sum(got.values()) == pytest.approx(1.0, rel=1e-9)
    col = db.stats["sum"][:, db.metric_id("gpu_inst/samples")]
    kids = collections.defaultdict(list)
    for g, par in enumerate(db.parents):
        if par >= 0:
            kids[int(par)].append(g)
    held = [g for g, fr in enumerate(db.frames) if fr.kind == "placeholder"
            and fr.name == "kernel:train_step" and col[g] > 0]
    assert held
    for g in held:
        (step,) = kids[g]
        assert db.frames[step].name == "train_step"
        assert sorted(db.frames[c].name for c in kids[step]) == [
            "fwd_bwd", "grad_compression", "optimizer"]
    view = viewer.top_down(db, "gpu_inst/samples", max_depth=64)
    shown = view[view.index("<gpu op kernel:train_step>"):].splitlines()
    assert shown[1].split()[-1] == "train_step"
    assert {ln.split()[-1] for ln in shown[2:]} >= {
        "fwd_bwd", "grad_compression", "optimizer"}, view
