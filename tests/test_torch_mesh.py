"""The port's device-mesh layer against the JAX package on the CPU: the
sharding plan (every leaf of the ten configurations, reduced, under each
strategy, on four mesh shapes), the expert-parallel MoE on a (2, 2) mesh
in both weight modes, ``compressed_psum`` over 4 ranks, the GPipe
pipeline over 4 stages and the attention block with its heads split over
``model``.  The port's side runs in 4 gloo ranks (``torch_ranks.py``),
the JAX package's on 4 host devices in a subprocess, from the same numpy
inputs."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_ranks
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.distributed import sharding as jshard
from repro.launch import specs as jspecs
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as S
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.launch import specs
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import transformer as T
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

MESHES = ((1, 1), (2, 2), (1, 4), (4, 1))
STRATEGIES = (("tp", "gather"), ("tp", "stationary"), ("fsdp", "gather"),
              ("dp_only", "gather"))


def norm(spec, ndim):
    """A spec as a tuple of axis tuples, padded to ``ndim``."""
    out = [smc.entry_axes(e) for e in tuple(spec)]
    return tuple(out + [()] * (ndim - len(out)))


def jax_leaves(tree):
    """{path: leaf} of a JAX tree, paths as the port's key tuples."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def structs(name):
    cfg, jcfg = get_config(name).reduced(), jax_get_config(name).reduced()
    cache = T.init_cache(cfg, 4, 32, device="meta")
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 32))
    return cfg, jcfg, specs.params_struct(cfg), jspecs.params_struct(jcfg), \
        cache, jcache


def agree(port_fn, jax_fn, shapes):
    """The port's shardings against the reference's; where the reference's
    NamedSharding refuses a spec that maps an axis twice (a cache split
    over ``kv_seq_axis="model"`` while the batch's axes hold ``model``, or
    ZeRO-1 over an axis a leaf is split on already), the port refuses it
    too."""
    try:
        want = jax_fn()
    except Exception as e:
        assert type(e).__name__ == "DuplicateSpecError", e
        with pytest.raises(ValueError):
            port_fn()
        return False
    same(port_fn(), want, shapes)
    return True


def same(got_tree, want_tree, shapes):
    got = {p: s for p, s in leaves_with_paths(got_tree)}
    want = jax_leaves(want_tree)
    assert sorted(got) == sorted(want)
    shape = dict(leaves_with_paths(shapes))
    for path, w in want.items():
        n = len(shape[path].shape) if path in shape else len(w.spec)
        if w is None:
            assert got[path] is None, path
            continue
        assert norm(got[path].spec, n) == norm(w.spec, n), \
            (path, got[path].spec, w.spec)


@pytest.mark.parametrize("name", sorted(list_configs()))
@pytest.mark.parametrize("strategy,mode", STRATEGIES)
@pytest.mark.parametrize("shape", MESHES)
def test_plan_matches_the_reference(name, strategy, mode, shape):
    """Every leaf's spec, params, AdamW state (with and without ZeRO-1
    over ``data``), the batch and the cache (with and without
    ``kv_seq_axis="model"``), equal to the reference's PartitionSpec on
    the same mesh shape (an abstract mesh on both sides), the
    divisibility guard included."""
    cfg, jcfg, ps, jps, cache, jcache = structs(name)
    axes = ("data", "model")
    jmesh, mesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
    jplan = jshard.make_plan(jmesh, strategy=strategy,
                             moe_weight_mode=mode)
    plan = S.make_plan(mesh, strategy=strategy, moe_weight_mode=mode)
    assert (plan.dp_axes, plan.fsdp_axis, plan.model_axis) == \
        (tuple(jplan.dp_axes), jplan.fsdp_axis, jplan.model_axis)
    assert norm(plan.batch_spec(), 1) == norm(jplan.batch_spec(), 1)
    jp_sh = jshard.param_shardings(jps, jcfg, jplan)
    p_sh = S.param_shardings(ps, cfg, plan)
    same(p_sh, jp_sh, ps)
    ost = specs.opt_struct(ps)
    jost = jspecs.opt_struct(jps)
    for z in (None, "data"):
        agree(lambda: S.opt_shardings(ost, p_sh, zero1_axis=z),
              lambda: jshard.opt_shardings(jost, jp_sh, zero1_axis=z), ost)
    batch = specs.batch_struct(cfg, ShapeConfig("t", 32, 4, "train"))
    jbatch = jspecs.batch_struct(
        jcfg, jspecs.ShapeConfig("t", 32, 4, "train"))
    same(S.batch_shardings(batch, plan), jshard.batch_shardings(jbatch,
                                                                jplan), batch)
    for kv in (None, "model"):
        agree(lambda: S.cache_shardings(cache, cfg, plan, kv_seq_axis=kv),
              lambda: jshard.cache_shardings(jcache, jcfg, jplan,
                                             kv_seq_axis=kv), cache)


@pytest.mark.parametrize("name", sorted(list_configs()))
def test_zero1_over_pod_matches_the_reference(name):
    """ZeRO-1 as the reference means it, over a ``pod`` axis the
    parameters do not use: (2, 2, 2) over ("pod", "data", "model"), the
    moments' specs equal the reference's (and the batch over (pod,
    data))."""
    cfg, jcfg, ps, jps, _, _ = structs(name)
    axes = ("pod", "data", "model")
    jplan = jshard.make_plan(AbstractMesh((2, 2, 2), axes))
    plan = S.make_plan(abstract_mesh((2, 2, 2), axes))
    jp_sh = jshard.param_shardings(jps, jcfg, jplan)
    p_sh = S.param_shardings(ps, cfg, plan)
    same(p_sh, jp_sh, ps)
    ost = specs.opt_struct(ps)
    assert agree(lambda: S.opt_shardings(ost, p_sh, zero1_axis="pod"),
                 lambda: jshard.opt_shardings(jspecs.opt_struct(jps), jp_sh,
                                              zero1_axis="pod"), ost)
    assert norm(plan.batch_spec(), 1) == norm(jplan.batch_spec(), 1)


def test_guard_replicates_kv_heads_model_4_does_not_divide():
    """qwen2 reduced (H 4, Hkv 2) on model = 4: wq and wo split over
    ``model``, wk and wv (and their biases) whole; the plan's placements
    say the same."""
    cfg = get_config("qwen2-1.5b").reduced()
    mesh = abstract_mesh((1, 4), ("data", "model"))
    sh = S.param_shardings(specs.params_struct(cfg), cfg, S.make_plan(mesh))
    attn = sh["layers"]["e0"]["attn"]
    assert "model" in smc.spec_axes(attn["wq"].spec)
    assert "model" in smc.spec_axes(attn["wo"].spec)
    for k in ("wk", "wv", "bk", "bv"):
        assert smc.spec_axes(attn[k].spec) == (), k
    assert [type(p).__name__ for p in attn["wq"].placements] == \
        ["Replicate", "Shard"]


def test_input_specs_with_a_plan_match_the_reference():
    """``input_specs`` with a plan: granite reduced, train and decode
    shapes on (2, 2), every sharding the reference's structs carry."""
    cfg, jcfg = get_config("granite-moe-1b-a400m").reduced(), \
        jax_get_config("granite-moe-1b-a400m").reduced()
    mesh, jmesh = abstract_mesh((2, 2), ("data", "model")), \
        AbstractMesh((2, 2), ("data", "model"))
    for kind in ("train", "decode"):
        got = specs.input_specs(cfg, ShapeConfig("t", 32, 4, kind),
                                plan=S.make_plan(mesh), kv_seq_axis="model")
        want = jspecs.input_specs(jcfg, jspecs.ShapeConfig("t", 32, 4, kind),
                                  plan=jshard.make_plan(jmesh),
                                  kv_seq_axis="model")
        sh = got.pop("shardings")
        assert "params" in sh and set(sh) <= set(got)
        for part, tree in sh.items():
            w = want[part]
            wsh = jax.tree.map(lambda s: s.sharding, w)
            same(tree, wsh, got[part])


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 28) < 0.1


# ---------------------------------------------------------------------------
# 4 ranks against 4 devices
# ---------------------------------------------------------------------------
JAX_SIDE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.distributed import compression as comp
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.shardmap_compat import shard_map
ins = np.load("{inputs}")
res = {{}}
cf = float(ins["cf"])
params = {{"router": ins["wr"], "w1": ins["w1"], "w3": ins["w3"],
          "w2": ins["w2"]}}
for shape, tag in (((2, 2), "moe22"), ((1, 4), "moe14")):
    mesh = make_mesh(shape, ("data", "model"))
    for mode in ("gather", "stationary"):
        args = moe.MoEMeshArgs(mesh, ("data",),
                               "data" if shape[0] > 1 else None, "model",
                               weight_mode=mode)
        with mesh:
            y, aux = jax.jit(lambda p, x: moe.moe_ffn(
                p, x, n_experts=4, top_k=2, capacity_factor=cf,
                mesh_args=args))(params, ins["x"])
        res[f"{{tag}}_{{mode}}_y"] = np.asarray(y)
        res[f"{{tag}}_{{mode}}_aux"] = np.asarray(aux)
mesh = make_mesh((4, 1), ("data", "model"))
f = shard_map(lambda v: comp.compressed_psum(v, "data"), mesh=mesh,
              in_specs=P("data"), out_specs=P())
res["cpsum"] = np.asarray(jax.jit(f)(ins["cx"]))
smesh = make_mesh((4,), ("stage",))
with smesh:
    res["pipe"] = np.asarray(pipeline_apply(
        lambda p, x: jnp.tanh(x @ p), ins["pw"], ins["px"], mesh=smesh))
np.savez("{out}", **res)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both sides' results on the same numpy inputs: MoE tokens (4 x 8, d
    64, f 128, 4 experts top 2 at capacity factor 1: a shard drops
    tokens), router N x 0.5 (no top-k ties), compressed_psum's global x
    (4 ranks x (2, 256)), the pipeline's 4 stage weights and 6
    microbatches."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    ins = dict(
        x=rng.standard_normal((4, 8, 64)).astype(np.float32),
        wr=(rng.standard_normal((64, 4)) * 0.5).astype(np.float32),
        w1=(rng.standard_normal((4, 64, 128)) * 0.2).astype(np.float32),
        w3=(rng.standard_normal((4, 64, 128)) * 0.2).astype(np.float32),
        w2=(rng.standard_normal((4, 128, 64)) * 0.2).astype(np.float32),
        cf=np.float32(1.0),
        cx=rng.standard_normal((8, 256)).astype(np.float32),
        pw=(rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
        px=rng.standard_normal((6, 2, 8)).astype(np.float32))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **ins)
    jproc = torch_ranks.start_jax(JAX_SIDE, 4, tmp, inputs=inputs,
                                  out=str(tmp / "jax.npz"))
    torch_ranks.run_ranks("mesh_cases", 4, tmp, out=str(tmp), inputs=inputs)
    torch_ranks.wait_jax(jproc)
    return ins, dict(np.load(tmp / "mesh_cases.npz")), \
        dict(np.load(tmp / "jax.npz"))


def within(got, want, frac, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= frac, f"{what}: max abs error {err:.3g} of max |ref|"


@pytest.mark.parametrize("mesh", ["moe22", "moe14"])
@pytest.mark.parametrize("mode", ["gather", "stationary"])
def test_expert_parallel_moe_matches_jax_on_the_mesh(results, mesh, mode):
    """``moe_ffn`` on a mesh against the JAX package's on the same mesh
    shape: output and aux within 1e-5 of the largest value (f32).  The
    per-shard capacity drops other tokens than one device does when
    data > 1, so mesh is compared with mesh; at data = 1 the sharded
    result is also the one-device port's."""
    ins, port, jax_res = results
    for k in ("y", "aux"):
        within(port[f"{mesh}_{mode}_{k}"], jax_res[f"{mesh}_{mode}_{k}"],
               1e-5, f"{mesh} {mode} {k}")
    if mesh == "moe14":
        within(port[f"{mesh}_{mode}_y"], port["moe_one_y"], 1e-5, "vs one")
        within(port[f"{mesh}_{mode}_aux"], port["moe_one_aux"], 1e-5,
               "aux vs one")


def test_the_mesh_moe_drops_other_tokens_than_one_device(results):
    """The comparison above is not vacuous: on (2, 2) the per-shard
    capacity changes the result against one device."""
    _, port, _ = results
    assert np.abs(port["moe22_gather_y"] - port["moe_one_y"]).max() > 1e-3


def test_compressed_psum_matches_jax_and_the_plain_sum(results):
    """4 ranks' blocks reduced in the compressed domain: within 1e-6 of
    the JAX package's on 4 devices (the summation order of the two
    backends may differ), and off the plain sum by no more than the
    rounding of the four int8 blocks allows (half a step of each rank's
    scale, summed), which for one rank is the reference's 2e-2 check
    (tests/test_substrate.py)."""
    ins, port, jax_res = results
    np.testing.assert_allclose(port["cpsum"], jax_res["cpsum"], rtol=1e-6,
                               atol=1e-6)
    blocks = ins["cx"].reshape(4, 2, 256)
    plain = blocks.sum(0)
    step = np.abs(blocks).max(axis=2, keepdims=True) / 127.0   # (4, 2, 1)
    bound = step.sum(0) / 2 * (1 + 1e-5) + 1e-6
    assert (np.abs(port["cpsum"] - plain) <= bound).all()
    assert np.abs(port["cpsum"] - plain).max() > 0      # it did quantize


def test_gpipe_four_stages_matches_jax_and_sequential(results):
    """``pipeline_apply`` over 4 stages (6 microbatches): the JAX
    package's pipeline on 4 devices and the four stages applied in turn
    (tests/test_pipeline.py's case, on numpy inputs), to 1e-5."""
    ins, port, jax_res = results
    want = ins["px"]
    for s in range(4):
        want = np.tanh(want @ ins["pw"][s])
    np.testing.assert_allclose(port["pipe"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["pipe"], jax_res["pipe"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mesh", ["a22", "a14"])
def test_attention_with_heads_over_model_is_the_global_function(results,
                                                                mesh):
    """The attention block inside a mesh region, its heads over ``model``
    (on (2, 2) q and kv heads both split, G = 2 a rank; on (1, 4) the kv
    heads whole and the q heads gathered before the op), batch over
    ``data``: its output and the gradients of x, wq and wk through the
    op's recompute backward equal the one-device block's to 1e-5 of their
    largest values."""
    _, port, _ = results
    for k in ("y", "gx", "gq", "gk"):
        within(port[f"{mesh}_{k}"], port[f"{mesh}_ref_{k}"], 1e-5,
               f"{mesh} {k}")
