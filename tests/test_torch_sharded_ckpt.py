"""The port's sharded checkpoints: written by block from 4 gloo ranks on a
(2, 2) mesh and restored onto (4, 1) and onto one process bitwise, a
resumed sharded run bitwise the uninterrupted one, and a checkpoint the
JAX package's manager writes on its 8-device mesh (8 shard files a leaf)
restored by the port bitwise, bf16 leaves as their raw 16-bit words."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.tree import leaves_with_paths, tree_map

torch.set_num_threads(1)

JAX_SIDE = r"""
import dataclasses, os
import numpy as np, jax, jax.numpy as jnp
from repro.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.distributed import sharding as shard_mod
from repro.launch.mesh import make_mesh
from repro.models import transformer as T

cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                          dtype="bfloat16")
mesh = make_mesh((8, 1), ("data", "model"))
plan = shard_mod.make_plan(mesh, strategy="fsdp")
p_struct = jax.eval_shape(lambda k: T.init_params(k, cfg),
                          jax.random.PRNGKey(0))
sh = shard_mod.param_shardings(p_struct, cfg, plan)
with mesh:
    params = jax.jit(lambda k: T.init_params(k, cfg), out_shardings=sh)(
        jax.random.PRNGKey(0))
CheckpointManager("{out}/jck").save(3, {{"params": params}})
items, _ = jax.tree_util.tree_flatten_with_path(params)
np.savez("{out}/jax_params.npz", **{{
    "/".join(str(k.key) for k in path):
    np.asarray(v).view(np.uint16) if v.dtype == jnp.bfloat16
    else np.asarray(v) for path, v in items}})
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sckpt")
    jproc = torch_ranks.start_jax(JAX_SIDE, 8, tmp, out=str(tmp))
    torch_ranks.run_ranks("ckpt_cases", 4, tmp, timeout=150, out=str(tmp),
                          ref=str(tmp))
    torch_ranks.wait_jax(jproc)
    return tmp


def test_sharded_save_restores_onto_another_mesh_and_one_process(results):
    """The (2, 2) checkpoint holds each leaf's distinct blocks once (the
    manifest names one file a block, each file there) and restores onto
    (4, 1) bitwise on every rank (checked in the ranks) and onto one
    process bitwise (here)."""
    one = np.load(results / "one.npz")
    got = {k[4:]: one[k] for k in one.files if k.startswith("got/")}
    want = {k[5:]: one[k] for k in one.files if k.startswith("want/")}
    assert sorted(got) == sorted(want) and got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    step_dir = results / "ck22" / "step_00000007"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    files = {s["file"] for e in manifest["leaves"] for s in e["shards"]}
    assert files == {f for f in os.listdir(step_dir) if f.endswith(".npy")}
    wq = [e for e in manifest["leaves"]
          if e["name"] == "params.layers.e0.attn.wq"][0]
    # (P, d, H, Dh) split over data on d and model on H: 4 blocks
    assert len(wq["shards"]) == 4
    norm = [e for e in manifest["leaves"]
            if e["name"] == "params.final_norm"][0]
    assert len(norm["shards"]) == 1


def test_resume_after_step_two_of_three_is_exact(results):
    """``train(mesh=(2, 2))``: 2 steps with a checkpoint at step 2, then a
    resumed run to step 3, whose last loss and params (checked in the
    ranks, every block) are bitwise the uninterrupted 3-step run's."""
    r = np.load(results / "resume.npz")
    assert r["res"][0] == r["all"][2]


def test_jax_manager_sharded_checkpoint_restores_bitwise(results):
    """The JAX manager's checkpoint of granite reduced in bf16 on an
    8-device mesh (``fsdp``: a leaf with a dim that 8 divides is in 8
    shard files) restores in the port, onto one process, bitwise: the
    bf16 leaves as their raw 16-bit words, the fp32 router as it is."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              dtype="bfloat16")
    like = {"params": tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                               specs.params_struct(cfg))}
    manifest = json.loads((results / "jck" / "step_00000003" /
                           "manifest.json").read_text())
    counts = {e["name"]: len(e["shards"]) for e in manifest["leaves"]}
    assert counts["params.layers.e0.attn.wq"] == 8
    step, got = CheckpointManager(str(results / "jck")).restore(like)
    assert step == 3
    want = np.load(results / "jax_params.npz")
    for path, t in leaves_with_paths(got["params"]):
        w = want["/".join(path)]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy()
                                          .view(np.uint16), w)
        else:
            np.testing.assert_array_equal(t.numpy(), w)
