"""The port's sharded train step and its sharded serving steps against the
JAX package's on the same mesh shapes, on the CPU.

Training: 3 steps of ``train(mesh=..., strategy=...)`` of reduced
granite-moe (a (2, 2) mesh: ``tp`` with the MoE weights gathered, ``tp``
with them stationary, and ``fsdp`` with the int8 gradient wire model), reduced qwen2 on (1, 4) (its two kv heads do not divide over
model = 4: the guard keeps ``wk``/``wv`` whole and the q heads are
gathered before the op), reduced hymba on (2, 2) (the mamba mixer's
leaves gathered whole, its SSD scan through the plain version) and the
same widths with MAMBA blocks alone (``hymba-1.5b+mamba``: the block
pattern replaced on both sides, ``torch_ranks.reduced_config``), from the
JAX package's tempered seed-0 weights through ``convert`` and the same
synthetic batches, against the JAX package's ``train(mesh=...)`` on 4
host devices.  Serving: granite's sharded prefill and decode steps on
(2, 2) with ``cache_shardings`` against the one-device port's steps and
the JAX package's steps on the same mesh.  The port runs in 4 gloo ranks
(``torch_ranks.py``)."""
import jax
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config

torch.set_num_threads(1)

CASES = [
    ("granite-moe-1b-a400m", (2, 2), "tp", "gather", False),
    ("granite-moe-1b-a400m", (2, 2), "tp", "stationary", False),
    ("granite-moe-1b-a400m", (2, 2), "fsdp", "gather", True),
    ("qwen2-1.5b", (1, 4), "tp", "gather", False),
    ("hymba-1.5b", (2, 2), "tp", "gather", False),
    ("hymba-1.5b+mamba", (2, 2), "tp", "gather", False),
]
KEYS = {c: f"{c[0]}_{c[1][0]}x{c[1][1]}_{c[2]}_{c[3]}_{int(c[4])}"
        for c in CASES}

JAX_SIDE = r"""
import functools, os
import numpy as np, jax, jax.numpy as jnp
import torch_ranks
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.checkpoint import CheckpointManager
from repro.distributed import sharding as shard_mod
from repro.launch import mesh as mesh_mod, steps as jsteps
from repro.launch import train as train_mod
from repro.launch.serve import _grow_cache
from repro.models import transformer as T
from repro.optim import adamw

CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
out = "{out}"
make_plan = shard_mod.make_plan


def flat(tree, prefix):
    items, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {{prefix + "/" + "/".join(str(getattr(k, "key", getattr(
        k, "name", k))) for k in path): np.asarray(v) for path, v in items}}


def load(name):
    npz = np.load(os.path.join(out, name + "_init.npz"))
    tree = {{}}
    for k in npz.files:
        node = tree
        parts = k.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(npz[k])
    return tree


for name, shape, strategy, mode, gc, key in {cases}:
    cfg = torch_ranks.reduced_config(get_config, name)
    init = load(name)
    T_init = T.init_params
    T.init_params = lambda k, c, init=init: init
    shard_mod.make_plan = functools.partial(make_plan, moe_weight_mode=mode)
    mesh = mesh_mod.make_mesh(tuple(shape), ("data", "model"))
    ck = os.path.join(out, "jck_" + key)
    _, hist, _ = train_mod.train(
        cfg, ShapeConfig("t", 32, 4, "train"), n_steps=3, mesh=mesh,
        strategy=strategy, log_every=1, opts=T.ModelOptions(**CHUNKS),
        grad_compression=gc, ckpt_dir=ck, ckpt_every=100)
    T.init_params = T_init
    shard_mod.make_plan = make_plan
    like = {{"params": init, "opt": adamw.init(init)}}
    _, st = CheckpointManager(ck).restore(like)
    res = dict(loss=np.array([h["loss"] for h in hist]),
               gnorm=np.array([h["gnorm"] for h in hist]))
    res.update(flat(st["params"], "params"))
    res.update(flat(st["opt"].mu, "mu"))
    res.update(flat(st["opt"].nu, "nu"))
    np.savez(os.path.join(out, key + ".npz"), **res)

# serving: prefill 4 x 16 and 4 decode steps on (2, 2)
cfg = get_config("granite-moe-1b-a400m").reduced()
init = load("granite-moe-1b-a400m")
mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
plan = make_plan(mesh)
toks = np.load(os.path.join(out, "serve_inputs.npz"))["tokens"]
nxt = np.load(os.path.join(out, "serve_inputs.npz"))["next"]
opts = T.ModelOptions(**CHUNKS)
pre = jax.jit(jsteps.make_prefill_step(cfg, plan, opts))
dec = jax.jit(jsteps.make_decode_step(cfg, plan, opts))
with mesh:
    logits, cache = pre(init, {{"tokens": jnp.asarray(toks)}})
    cache = _grow_cache(cfg, cache, 4, 32, 16)
    outs = [np.asarray(logits)]
    for i in range(4):
        logits, cache = dec(init, cache, jnp.int32(16 + i),
                            jnp.asarray(nxt[:, i]))
        outs.append(np.asarray(logits))
np.savez(os.path.join(out, "serve.npz"), logits=np.stack(outs))
"""


def init_npz(name, dest):
    """The JAX package's seed-0 params of reduced ``name``, wq and wk of
    the attention tempered by 1/8 (as tests/test_torch_train.py's
    ``temper``), as ``init/...`` keys: both sides start from them."""
    p = JT.init_params(jax.random.PRNGKey(0),
                       torch_ranks.reduced_config(jax_get_config, name))
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    out = {}
    for path, v in flat:
        keys = [str(k.key) for k in path]
        v = np.asarray(v)
        if keys[-2:-1] == ["attn"] and keys[-1] in ("wq", "wk"):
            v = v / np.float32(8)
        out["init/" + "/".join(keys)] = v
    np.savez(dest, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides at once: the JAX package on 4 host devices, the port in
    4 ranks, from the init params and serving tokens written here."""
    tmp = tmp_path_factory.mktemp("strain")
    for name in {c[0] for c in CASES}:
        init_npz(name, tmp / f"{name}_init.npz")
    rng = np.random.default_rng(5)
    vocab = get_config("granite-moe-1b-a400m").reduced().vocab
    np.savez(tmp / "serve_inputs.npz",
             tokens=rng.integers(0, vocab, (4, 16)).astype(np.int32),
             next=rng.integers(0, vocab, (4, 4)).astype(np.int32))
    cases = [c + (KEYS[c],) for c in CASES]
    jproc = torch_ranks.start_jax(JAX_SIDE, 4, tmp, out=str(tmp),
                                  cases=repr(cases))
    torch_ranks.run_ranks("train_cases", 4, tmp, timeout=300, out=str(tmp),
                          ref=str(tmp), cases=[list(c) for c in CASES])
    torch_ranks.run_ranks("serve_cases", 4, tmp, timeout=120, out=str(tmp),
                          ref=str(tmp))
    torch_ranks.wait_jax(jproc, timeout=300)
    return tmp


def tree(npz, prefix):
    return {k[len(prefix) + 1:]: npz[k] for k in npz.files
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("case", CASES, ids=list(KEYS.values()))
def test_sharded_train_matches_jax_on_the_mesh(results, case):
    """Losses and ``grad_norm`` of each step within 1e-5 relative; after 3
    steps the AdamW moments within 1e-4 of each leaf's largest value and
    the params within 1e-6 relative plus 1e-2 of the summed learning
    rates, as ``tests/test_torch_train.py::close_state`` holds the one-
    device port, but the elements whose gradient is below 1e-4 of its
    leaf's largest (AdamW moves them by about lr whichever sign rounding
    gives them: the zero-initialised biases, the keys' biases above all)
    within 2x the summed learning rates.  With the int8 wire model a
    gradient element within rounding of a quantization boundary can land
    one int8 step (1/127 of its block's largest) off the reference's, so
    there the moments are held to 1/127 of each leaf's largest value, and
    the params whose moment is within that of zero get 2x the summed
    learning rates."""
    key = KEYS[case]
    tol = 1 / 127 if case[4] else 1e-4
    want = np.load(results / f"{key}.npz")
    got = np.load(results / f"port_{key}.npz")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-5)
    for part in ("mu", "nu"):
        w, g = tree(want, part), tree(got, part)
        assert sorted(w) == sorted(g)
        for k in w:
            err = np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-30)
            assert err <= tol, f"{part} {k}: {err:.3g}"
    # lr of steps 1..3 under OptConfig(total_steps=3): warmup 100
    lr_sum = 3e-4 * (1 + 2 + 3) / 100
    mu = tree(want, "mu")
    wp, gp = tree(want, "params"), tree(got, "params")
    assert sorted(wp) == sorted(gp)
    for k in wp:
        loose = np.abs(mu[k]) < tol * np.abs(mu[k]).max()
        atol = np.where(loose, 2 * lr_sum, 1e-2 * lr_sum)
        bad = np.abs(gp[k] - wp[k]) > 1e-6 * np.abs(wp[k]) + atol
        assert not bad.any(), f"{k}: {int(bad.sum())} elements off"


def test_sharded_serving_steps_match_one_device_and_jax(results):
    """granite reduced's sharded prefill (4 prompts of 16) and 4 decode
    steps on (2, 2), the cache laid out by ``cache_shardings`` (kv heads
    over ``model``, batch over ``data``): every step's logits within 1e-5
    of the largest of the JAX package's steps on the same mesh.  Against
    the one-device port's steps the per-shard capacity routes other
    tokens at data = 2, so there both run at capacity factor 4 (every
    expert takes every token of a shard: nothing is dropped on either
    side) and agree to 1e-5 as well; at the configuration's own factor
    the two differ, which shows the comparison is not vacuous."""
    want = np.load(results / "serve.npz")["logits"]
    got = np.load(results / "port_serve.npz")
    scale = np.abs(want).max()
    assert np.abs(got["mesh"] - want).max() <= 1e-5 * scale
    assert np.abs(got["mesh_cf4"] - got["one_cf4"]).max() <= 1e-5 * scale
    assert np.abs(got["mesh"] - got["one"]).max() > 1e-3 * scale
    assert got["mesh"].shape == (5, 4, get_config(
        "granite-moe-1b-a400m").reduced().vocab)
