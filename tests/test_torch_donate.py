"""The donated train step (``launch.steps.make_train_step(..., donate=True)``,
``optim.adamw.update_``), on the CPU: the counterpart of the JAX package's
``jax.jit(step, donate_argnums=(0, 1))`` (``repro/launch/train.py``).

The donated step must give the functional step's values bitwise (the same
operations in the same order), write them into the tensors it is given,
keep every fp32 temporary of the update and the gradient norm within one
period's slice of a stacked leaf or one unstacked leaf, and still trace
for the profiler without touching the caller's tensors.  ``train()``
donates; reduced musicgen-large trains on audio-frame batches as the JAX
package's ``train()`` does."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.train import train as jax_train
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import export
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.train import to_device, train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves, leaves_with_paths, tree_map

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
SEQ, BATCH = 32, 2


def setup(name, dtype, seed=0, **over):
    """Reduced ``name`` in ``dtype`` (and ``over``): seeded params, the
    pipeline's first three batches and the step options."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype,
                              **over)
    params = T.init_params(torch.Generator().manual_seed(seed), cfg)
    ds = SyntheticLM(cfg, ShapeConfig("t", SEQ, BATCH, "train"))
    batches = [to_device(ds.batch_at(s), "cpu") for s in range(3)]
    return cfg, params, batches, T.ModelOptions(**CHUNKS)


def copy(*trees):
    out = tuple(tree_map(torch.clone, t) for t in trees)
    return out if len(out) > 1 else out[0]


def assert_trees_equal(a, b):
    a, b = (t if isinstance(t, list) else [t] for t in (a, b))
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        pairs = zip(leaves_with_paths(ta), leaves_with_paths(tb))
        for (path, x), (_, y) in pairs:
            assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_donated_step_equals_the_functional_step(name, dtype):
    """Three steps of each form from the same params and state: bitwise
    the same losses, grad norms, params and AdamW state, in fp32 and in
    bf16 (the same operations in the same order; bf16 rounding is the same
    rounding on both sides).  The functional step leaves its inputs as
    they are."""
    cfg, params, batches, opts = setup(name, dtype)
    opt_cfg = adamw.OptConfig(warmup_steps=1, total_steps=3)
    fun = steps.make_train_step(cfg, opts, opt_cfg)
    don = steps.make_train_step(cfg, opts, opt_cfg, donate=True)
    fp, fs = params, adamw.init(params)
    dp, ds = copy(params), adamw.init(params)
    for b in batches:
        given = [fp, fs]
        before = list(copy(fp, fs))
        fp, fs, fm = fun(fp, fs, b)
        assert_trees_equal(given, before)
        dp, ds, dm = don(dp, ds, b)
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(fm[key], dm[key]), key
    assert_trees_equal(fp, dp)
    assert_trees_equal(fs, ds)
    assert int(ds.step) == 3


def test_functional_step_leaves_its_inputs():
    cfg, params, batches, opts = setup("qwen2-1.5b", "float32")
    state = adamw.init(params)
    p0, s0 = copy(params), copy(state)
    steps.make_train_step(cfg, opts, adamw.OptConfig())(params, state,
                                                        batches[0])
    assert_trees_equal(params, p0)
    assert_trees_equal(state, s0)


@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_donated_step_writes_into_the_callers_tensors(n_microbatches):
    """Donation: the step returns the trees it was given, every leaf the
    same storage, now holding the new values (the functional step's);
    the step counter too.  With two microbatches (fp32 accumulation) as
    with one."""
    cfg, params, batches, opts = setup("qwen2-1.5b", "float32")
    opt_cfg = adamw.OptConfig(warmup_steps=1)
    state = adamw.init(params)
    want_p, want_s, _ = steps.make_train_step(
        cfg, opts, opt_cfg, n_microbatches=n_microbatches)(
            params, state, batches[0])
    ptrs = [t.data_ptr() for t in leaves(params) + leaves(state)]
    got_p, got_s, _ = steps.make_train_step(
        cfg, opts, opt_cfg, n_microbatches=n_microbatches, donate=True)(
            params, state, batches[0])
    assert got_p is params and got_s is state
    assert [t.data_ptr() for t in leaves(params) + leaves(state)] == ptrs
    assert_trees_equal(params, want_p)
    assert_trees_equal(state, want_s)


def test_train_donates_the_callers_params():
    """``train()`` updates the params it is given in place and returns
    them; two steps equal two functional steps, bitwise."""
    cfg, params, _, opts = setup("qwen2-1.5b", "float32")
    mine = copy(params)
    got, hist, _ = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                         n_steps=2, log_every=1, opts=opts, device="cpu",
                         params=mine)
    assert got is mine
    fun = steps.make_train_step(cfg, opts, adamw.OptConfig(total_steps=2))
    ds = SyntheticLM(cfg, ShapeConfig("t", SEQ, BATCH, "train"))
    p, s = params, adamw.init(params)
    losses = []
    for step in range(2):
        p, s, m = fun(p, s, to_device(ds.batch_at(step), "cpu"))
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in hist] == losses
    assert_trees_equal(mine, p)


class _Fp32Outputs(TorchDispatchMode):
    """The largest fp32 tensor any op makes (not a view, not written in
    place into an operand)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inplace = func._schema.name.endswith("_") or any(
            a.is_out for a in func._schema.arguments)
        if not inplace and not func.is_view:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_update_temporaries_stay_within_one_slice(name):
    """No fp32 tensor made by the donated update or the gradient norm is
    larger than one period's slice of a stacked leaf or one unstacked
    leaf (bf16 params and grads: every fp32 value is a temporary); the
    functional update makes whole-leaf copies."""
    cfg, params, batches, opts = setup(name, "bfloat16", n_layers=6)
    _, _, grads = steps._value_and_grad(cfg, opts, params, batches[0])
    state = adamw.init(params)
    bound = max(s.numel() for path, t in leaves_with_paths(params)
                for s in adamw.slices(path, t))
    stacked = max(t.numel() for path, t in leaves_with_paths(params)
                  if path[0] == "layers")
    assert stacked > bound
    with torch.no_grad(), _Fp32Outputs() as seen:
        adamw.update_(adamw.OptConfig(), grads, state, params)
    assert 0 < seen.largest <= bound, (seen.largest, bound)
    with _Fp32Outputs() as seen:
        adamw.global_norm(grads)
    assert 0 < seen.largest <= bound
    with torch.no_grad(), _Fp32Outputs() as seen:
        adamw.update(adamw.OptConfig(), grads, state, params)
    assert seen.largest == max(t.numel() for t in leaves(state))


def test_traced_donated_step_mutates_in_place_and_leaves_the_inputs():
    """The donated step traced for the profiler (``make_fx`` on fake
    tensors): the caller's tensors are left as they were, the optimizer
    copies no leaf (no ``clone`` in its scope, where the functional step
    clones every parameter and moment; the update is in-place ops on the
    inputs, each with its out-of-place opcode), and one custom-call per
    forward launch remains, recompute included."""
    cfg, params, batches, opts = setup("qwen2-1.5b", "float32")
    state = adamw.init(params)
    before = list(copy(params, state))
    gm = export.trace_train_step(
        steps.make_train_step(cfg, opts, adamw.OptConfig(), donate=True),
        (params, state, batches[0]))
    assert_trees_equal([params, state], before)
    module = export.module_from_graph("train_step", gm)
    opt = [op for op in module.all_ops()
           if op.op_name.split("/")[1:2] == ["optimizer"]]
    by_leaf = {op.op_name.rsplit("/", 1)[-1]: op.opcode for op in opt}
    assert "clone" not in by_leaf and "copy_" in by_leaf
    assert by_leaf["mul_"] == "multiply" and by_leaf["sqrt_"] == "sqrt"
    assert not [op for op in opt if "unmapped" in op.attrs]
    functional = export.module_from_graph("train_step", export.trace_train_step(
        steps.make_train_step(cfg, opts, adamw.OptConfig()),
        (params, state, batches[0])))
    assert sum(op.op_name == "train_step/optimizer/clone"
               for op in functional.all_ops()) == 3 * len(leaves(params)) + 1
    calls = [op for op in module.all_ops() if op.opcode == "custom-call"]
    assert len(calls) == 2 * cfg.n_layers
    assert ops.flash_attention.launches == 0


def test_unread_params_get_zero_gradients():
    """musicgen fed frame embeddings never reads its token embedding: its
    gradient is zero, as ``jax.grad`` gives it, not an error."""
    cfg, params, batches, opts = setup("musicgen-large", "float32")
    assert "embeds" in batches[0] and "tokens" not in batches[0]
    _, _, grads = steps._value_and_grad(cfg, opts, params, batches[0])
    assert not grads["embed"].any() and grads["unembed"].any()


def test_musicgen_trains_on_audio_frames_as_jax_train():
    """3 steps of ``train()`` on reduced musicgen-large (audio frame
    embeddings in place of tokens, the pipeline's audio batches) from the
    JAX package's seed-0 weights: every loss within 1e-5 relative of the
    JAX package's ``train()`` (f32), as for qwen2."""
    jcfg = jax_get_config("musicgen-large").reduced()
    cfg = get_config("musicgen-large").reduced()
    assert cfg.frontend == jcfg.frontend == "audio"
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    _, jhist, _ = jax_train(jcfg, JShapeConfig("t", SEQ, BATCH, "train"),
                            n_steps=3, log_every=1,
                            opts=JT.ModelOptions(**CHUNKS))
    _, hist, _ = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                       n_steps=3, log_every=1, opts=T.ModelOptions(**CHUNKS),
                       device="cpu", params=params_from_jax(jp, "cpu"))
    assert [h["step"] for h in hist] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)


def test_train_memory_reckons_the_donated_step():
    """``launch.specs.train_memory``: the weights and gradients are
    ``params_struct``'s bytes, the moments two fp32 copies, the peak the
    largest of the three phases, activations and the loss chunk linear in
    the batch; block kinds it does not model raise."""
    from repro_torch.launch import specs
    cfg = get_config("yi-6b")
    one, two = (specs.train_memory(cfg, b, 512) for b in (1, 2))
    weights = specs.nbytes(specs.params_struct(cfg))
    n = sum(t.numel() for t in leaves(specs.params_struct(cfg)))
    assert one["parts"]["weights"] == one["parts"]["grads"] == weights
    assert one["parts"]["moments"] == 8 * n
    assert one["peak"] == max(one["phases"].values())
    assert two["phases"]["update"] == one["phases"]["update"]
    for part in ("activations", "loss_chunk"):
        assert two["parts"][part] == 2 * one["parts"][part]
    for name in ("hymba-1.5b", "granite-moe-1b-a400m", "xlstm-125m"):
        with pytest.raises(NotImplementedError):
            specs.train_memory(get_config(name), 1, 64)
