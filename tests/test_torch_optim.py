"""The port's optimizer, gradient compression, data pipeline and checkpoint
manager against the JAX package's, on the CPU, on the same numpy
inputs."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipe
from repro.distributed import compression as jcomp
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import copies
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compression as comp
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths, tree_map

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)


def tree(seed, scale=1.0):
    """A small parameter-like tree (matrices, a vector, a 3-d leaf) of
    numpy f32 draws."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 16), "b": (16,), "layers": {"e0": {"k": (2, 4, 3)}}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return draw(shapes)


def to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def to_torch(t):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def assert_tree_close(t, j, **kw):
    flat_j = dict(jax.tree_util.tree_flatten_with_path(j)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, j))[0]:
        node = t
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.float().numpy(), np.asarray(
            flat_j[path], np.float32), err_msg=str(path), **kw)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_schedule_matches_jax(step):
    cfg, jcfg = adamw.OptConfig(), jadamw.OptConfig()
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # unclipped, clipped
def test_update_matches_jax_on_identical_grads(grad_scale):
    """Three AdamW updates on identical gradients (a norm under the clip,
    then one far over it): params, moments, step, grad_norm and lr within
    1e-6."""
    cfg = adamw.OptConfig(warmup_steps=2, total_steps=10)
    jcfg = jadamw.OptConfig(warmup_steps=2, total_steps=10)
    p = tree(0)
    tp, jp = to_torch(p), to_jax(p)
    ts, js = adamw.init(tp), jadamw.init(jp)
    for i in range(3):
        g = tree(10 + i, grad_scale)
        tp, ts, tm = adamw.update(cfg, to_torch(g), ts, tp)
        jp, js, jm = jadamw.update(jcfg, to_jax(g), js, jp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    for t, j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        assert_tree_close(t, j, rtol=1e-6, atol=1e-6)
    if grad_scale > 1:
        assert float(tm["grad_norm"]) > cfg.clip_norm


def test_update_keeps_dtypes_and_decays_matrices_only():
    """bf16 params stay bf16 (updated in fp32), the moments are fp32;
    with a zero gradient only matrices move (decoupled weight decay)."""
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
         "b": torch.ones((4,), dtype=torch.bfloat16)}
    g = tree_map(torch.zeros_like, p)
    state = adamw.init(p)
    assert state.mu["w"].dtype == torch.float32
    cfg = adamw.OptConfig(warmup_steps=0, peak_lr=0.5)
    new, state, _ = adamw.update(cfg, g, state, p)
    assert new["w"].dtype == torch.bfloat16 and state.nu["b"].dtype == \
        torch.float32
    assert torch.equal(new["b"], p["b"]) and float(new["w"][0, 0]) < 1.0


def test_global_norm_matches_jax():
    g = tree(3)
    np.testing.assert_allclose(float(adamw.global_norm(to_torch(g))),
                               float(jadamw.global_norm(to_jax(g))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(256,), (1000,), (7, 300), (3, 5)])
def test_quantize_matches_jax(shape):
    """int8 blocks equal and scales equal (ties round to even in both)."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:4] = [0.5, 1.5, -2.5, 127.0]      # ties after scaling
    q, s = comp.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        comp.dequantize(q, s, shape, torch.float32).numpy(),
        np.asarray(jcomp.dequantize(jq, js, shape, jnp.float32)))
    assert comp.wire_bytes(torch.from_numpy(x)) == \
        jcomp.wire_bytes(jnp.asarray(x))


def test_ef_compress_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 400)).astype(np.float32)
    err = (rng.standard_normal((3, 400)) * 1e-3).astype(np.float32)
    for e in (None, err):
        out, new_err = comp.ef_compress(
            torch.from_numpy(x), None if e is None else torch.from_numpy(e))
        jout, jerr = jcomp.ef_compress(jnp.asarray(x),
                                       None if e is None else jnp.asarray(e))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))


def test_ef_compress_tree_matches_jax():
    """Leaves under a block travel as they are; the rest quantized."""
    g = tree(7)
    got = comp.ef_compress_tree(to_torch(g))
    want = jcomp.ef_compress_tree(to_jax(g))
    assert torch.equal(got["b"], to_torch(g)["b"])          # 16 < 256
    assert_tree_close(got, want, rtol=0, atol=0)


def test_compressed_psum_waits_for_multi_device():
    """``compressed_psum`` reduces over a mesh axis inside a mesh region
    (tests/test_torch_mesh.py runs it over 4 ranks); outside one there is
    no axis to sum over, and it says so."""
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        comp.compressed_psum(torch.zeros(4), "pod")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_shapes_are_the_reference_shapes():
    assert SHAPES == {k: ShapeConfig(v.name, v.seq_len, v.global_batch,
                                     v.kind) for k, v in JSHAPES.items()}


def test_pipeline_is_a_registered_copy():
    assert "data/pipeline.py" in copies.COPIES


@pytest.mark.parametrize("name", ["qwen2-1.5b", "hymba-1.5b",
                                  "xlstm-125m"])
@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (4, 3)])
def test_synthetic_batches_are_byte_identical(name, n_hosts, host_id):
    """The batch at (seed, step, host) of the port's copy equals the JAX
    package's byte for byte (dtypes, shapes and values)."""
    shape = ShapeConfig("t", 128, 8, "train")
    got = tpipe.SyntheticLM(get_config(name), shape, seed=3,
                            n_hosts=n_hosts, host_id=host_id)
    want = jpipe.SyntheticLM(jax_get_config(name),
                             JShapeConfig("t", 128, 8, "train"), seed=3,
                             n_hosts=n_hosts, host_id=host_id)
    for step in (0, 1, 17):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_prefetcher_yields_steps_in_order_and_closes():
    ds = tpipe.SyntheticLM(get_config("qwen2-1.5b").reduced(),
                           ShapeConfig("t", 16, 2, "train"), seed=1)
    pf = tpipe.Prefetcher(ds, start_step=5, depth=2)
    try:
        for want in (5, 6, 7):
            step, batch = next(pf)
            assert step == want
            assert batch["tokens"].tobytes() == \
                ds.batch_at(want)["tokens"].tobytes()
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def state_tree(dtype=torch.float32):
    p = {"embed": torch.randn(6, 4, generator=torch.Generator()
                              .manual_seed(0)).to(dtype),
         "layers": {"e0": {"w": torch.arange(12.0).reshape(2, 6).to(dtype),
                           "beta": torch.ones(2)}}}
    return {"params": p, "opt": adamw.init(p)}


def assert_trees_equal(a, b):
    fa, fb = leaves_with_paths(a), leaves_with_paths(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [True, False])
def test_checkpoint_round_trip(tmp_path, dtype, block):
    """Save (blocking or async) and restore: every leaf bitwise equal, in
    its dtype; the leaf names follow the JAX manager's paths."""
    mgr = CheckpointManager(str(tmp_path))
    st = state_tree(dtype)
    st["opt"] = st["opt"]._replace(step=torch.tensor(7, dtype=torch.int32))
    final = mgr.save(3, st, block=block)
    mgr.wait()
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    names = [e["name"] for e in man["leaves"]]
    assert names == ["opt.step", "opt.mu.embed", "opt.mu.layers.e0.beta",
                     "opt.mu.layers.e0.w", "opt.nu.embed",
                     "opt.nu.layers.e0.beta", "opt.nu.layers.e0.w",
                     "params.embed", "params.layers.e0.beta",
                     "params.layers.e0.w"]
    if dtype == torch.bfloat16:
        assert man["leaves"][7]["dtype"] == "bfloat16"
    like = state_tree(dtype)
    step, got = mgr.restore(like)
    assert step == 3 and isinstance(got["opt"], adamw.AdamState)
    assert_trees_equal(got, st)


def test_checkpoint_async_returns_before_the_write(tmp_path):
    """save(block=False) returns while its writer still runs; wait()
    publishes the step."""
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    real = np.save

    def slow_save(*a, **kw):
        gate.wait(10)
        return real(*a, **kw)
    np.save = slow_save
    try:
        mgr.save(1, state_tree(), block=False)
        assert mgr.all_steps() == []
        gate.set()
        mgr.wait()
    finally:
        np.save = real
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_checkpoint_is_atomic(tmp_path):
    """A writer that fails leaves only a .tmp directory, which no listing
    and no restore sees; the error surfaces at wait()."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree())
    real = np.save
    calls = []

    def failing_save(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk full")
        return real(*a, **kw)
    np.save = failing_save
    try:
        mgr.save(2, state_tree(), block=False)
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
    finally:
        np.save = real
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    assert mgr.all_steps() == [1]
    assert mgr.restore(state_tree())[0] == 1


def test_checkpoint_gc_and_a_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        st = state_tree()
        st["params"]["embed"] += s
        mgr.save(s, st)
    assert mgr.all_steps() == [3, 4]
    step, got = mgr.restore(state_tree(), step=3)
    assert step == 3
    assert torch.equal(got["params"]["embed"],
                       state_tree()["params"]["embed"] + 3)
    with pytest.raises(ValueError, match="shape"):
        bad = state_tree()
        bad["params"]["embed"] = torch.zeros(5, 4)
        mgr.restore(bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_a_checkpoint_written_by_the_jax_manager(tmp_path, dtype):
    """The JAX manager saves reduced qwen2's params and an AdamW state
    after one update; the port restores them into its own tree: every
    leaf equal to the JAX leaf (bf16 leaves from their 2-byte records),
    and the f32 leaves' files byte-identical to what the port itself
    writes."""
    import dataclasses
    jcfg = dataclasses.replace(jax_get_config("qwen2-1.5b").reduced(),
                               dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    js = jadamw.init(jp)
    g = jax.tree.map(lambda x: jnp.ones_like(x) * 0.01, jp)
    jp, js, _ = jadamw.update(jadamw.OptConfig(warmup_steps=1), g, js, jp)
    JCheckpointManager(str(tmp_path / "jax")).save(5, {"params": jp,
                                                       "opt": js})
    np_state = jax.tree.map(np.asarray, {"params": jp, "opt": js})
    want = {"params": params_from_jax(np_state["params"], "cpu"),
            "opt": opt_state_from_jax(np_state["opt"], "cpu")}
    like = tree_map(torch.zeros_like, want["params"])
    step, got = CheckpointManager(str(tmp_path / "jax")).restore(
        {"params": like, "opt": adamw.init(like)})
    assert step == 5
    assert_trees_equal(got, want)
    if dtype == "bfloat16":
        assert got["params"]["embed"].dtype == torch.bfloat16
    CheckpointManager(str(tmp_path / "port")).save(5, got)
    d_j = tmp_path / "jax" / "step_00000005"
    d_t = tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(d_j)) == sorted(os.listdir(d_t))
    with open(d_j / "manifest.json") as f:
        man = json.load(f)
    for e in man["leaves"]:
        if e["dtype"] in ("float32", "int32"):
            f = e["shards"][0]["file"]
            assert (d_j / f).read_bytes() == (d_t / f).read_bytes(), f


def test_port_checkpoint_restores_in_the_jax_manager(tmp_path):
    """The reverse for f32 leaves: the JAX manager restores what the port
    wrote."""
    p = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(1))}
    st = {"params": p, "opt": adamw.init(p)}
    CheckpointManager(str(tmp_path)).save(2, st)
    jlike = {"params": {"w": jnp.zeros((3, 4))},
             "opt": jadamw.init({"w": jnp.zeros((3, 4))})}
    step, got = JCheckpointManager(str(tmp_path)).restore(jlike)
    assert step == 2
    np.testing.assert_array_equal(got["params"]["w"], p["w"].numpy())
    assert int(got["opt"].step) == 0
