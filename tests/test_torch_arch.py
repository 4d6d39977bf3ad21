"""The reference's remaining configurations in the port, reduced, against
the JAX package: qwen3-32b (qk-norm), starcoder2-15b (qkv bias, and a
variant at 12 q heads per kv head), yi-6b, llava-next-mistral-7b (a
prefix of vlm patch embeddings), musicgen-large (audio frame embeddings
in place of tokens) and llama4-maverick-400b-a17b (a MoE every second
layer with a shared expert), given the same JAX-initialised parameters.
Also ``launch.specs`` against the reference's ``input_specs`` and the
slice contract of ``dense_init``.  On the CPU the attention wrappers run
their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.launch import specs as jax_specs
from repro.launch.serve import _grow_cache as jax_grow
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import MAMBA, SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import specs
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.tree import leaves_with_paths

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

NEW = ("qwen3-32b", "starcoder2-15b", "yi-6b", "llava-next-mistral-7b",
       "musicgen-large", "llama4-maverick-400b-a17b")
# starcoder2 reduced to 12 q heads over one kv head: G = 12, past the
# decode kernel's former limit of 8
G12 = "starcoder2-15b-g12"
S, STEPS = 32, 3
TOPTS = T.ModelOptions(q_chunk=16, kv_chunk=16)
JOPTS = JT.ModelOptions(q_chunk=16, kv_chunk=16)


def configs(name, dtype):
    base = "starcoder2-15b" if name == G12 else name
    over = dict(n_heads=12, n_kv_heads=1) if name == G12 else {}
    return (dataclasses.replace(get_config(base).reduced(), dtype=dtype,
                                **over),
            dataclasses.replace(jax_get_config(base).reduced(), dtype=dtype,
                                **over))


def jax_and_port_params(jcfg):
    """The JAX init on both sides.  In bf16 the attention's wq and wk are
    scaled by 1/8 first (both sides get the same weights): the init takes
    their fan-in from the head axis, the scores are then large and the
    softmax near one-hot, and the JAX package's own bf16 logits lie 3-28%
    of the largest from its f32 ones on these reduced models (llava,
    yi), where the port's bf16 lies 0.5-2.1% from the JAX package's bf16.
    Tempered, the comparison measures the port, not near-ties (as
    ``tests/test_torch_train.py`` and ``chip_smoke.check_against_cpu``
    temper)."""
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.dtype == "bfloat16":
        layers = {e: dict(p, attn={k: v * 0.125 if k in ("wq", "wk") else v
                                   for k, v in p["attn"].items()})
                  if "attn" in p else p for e, p in jp["layers"].items()}
        jp = dict(jp, layers=layers)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def close(t, j, dtype, err_msg=""):
    """float32: elementwise at 1e-4.  bfloat16: the max abs error within
    2e-2 of the largest reference value (as tests/test_torch_model.py)."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 2e-2, f"{err_msg}: max abs error {err:.4g} of max |ref|"
    else:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4,
                                   err_msg=err_msg)


def frontend_batch(cfg, dtype, B=2, seq=S, seed=1, labels=False):
    """The batch layout of ``launch.specs.batch_struct`` (and the JAX
    package's tests/test_arch_smoke.py): audio frame embeddings in place
    of tokens, a vlm prefix of min(frontend_tokens, S // 2) patch
    embeddings before the text, else tokens; seeded values, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {}
    text = seq
    if cfg.frontend == "audio":
        text = 0
        batch["embeds"] = rng.standard_normal((B, seq, cfg.d_model))
    elif cfg.frontend == "vlm" and cfg.frontend_tokens:
        F = min(cfg.frontend_tokens, seq // 2)
        text = seq - F
        batch["embeds"] = rng.standard_normal((B, F, cfg.d_model))
    if "embeds" in batch:
        batch["embeds"] = (0.5 * batch["embeds"]).astype(np.float32)
    if text:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, text), np.int32)
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (B, seq), np.int32)
    return batch


def as_jax(batch, dtype):
    return {k: jnp.asarray(v, dtype if k == "embeds" else jnp.int32)
            for k, v in batch.items()}


def as_torch(batch, dtype):
    return {k: torch.from_numpy(v).to(getattr(torch, dtype))
            if k == "embeds" else torch.from_numpy(v).long()
            for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEW + (G12,))
def test_prefill_and_decode_match_jax(name, dtype):
    """Prefill on the configuration's frontend batch, then teacher-forced
    decode steps (musicgen with a frame embedding per step), logits
    compared at every step and the k cache after."""
    cfg, jcfg = configs(name, dtype)
    jp, tp = jax_and_port_params(jcfg)
    batch = frontend_batch(cfg, dtype)
    jb, tb = as_jax(batch, jnp.dtype(dtype)), as_torch(batch, dtype)
    jl, jc = JT.prefill(jp, jcfg, jb.get("tokens"), jb.get("embeds"),
                        opts=JOPTS)
    tl, tc = T.prefill(tp, cfg, tb.get("tokens"), tb.get("embeds"),
                       opts=TOPTS)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, dtype, err_msg="prefill")
    jc = jax_grow(jcfg, jc, 2, S + STEPS, S)
    tc = serve_mod._grow_cache(tc, S + STEPS, S)
    rng = np.random.default_rng(3)
    for t in range(STEPS):
        if cfg.frontend == "audio":
            e = (0.5 * rng.standard_normal((2, 1, cfg.d_model))).astype(
                np.float32)
            jl, jc = JT.decode_step(jp, jcfg, jc, embed=jnp.asarray(
                e, jnp.dtype(dtype)), pos=jnp.int32(S + t), opts=JOPTS)
            tl, tc = T.decode_step(tp, cfg, tc, embed=torch.from_numpy(e).to(
                getattr(torch, dtype)), pos=S + t, opts=TOPTS)
        else:
            tok = rng.integers(0, cfg.vocab, (2,))
            jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
                tok, jnp.int32), pos=jnp.int32(S + t), opts=JOPTS)
            tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
                tok).long(), pos=S + t, opts=TOPTS)
        close(tl, jl, dtype, err_msg=f"decode step {t}")
    close(tc["e0"]["k"], jc["e0"]["k"], dtype, err_msg="k cache")


@pytest.mark.parametrize("name", ["qwen3-32b", G12])
def test_serve_matches_jax_serve(name):
    """Same seed, same prompts: identical f32 tokens from ``serve``, with
    qk-norm (qwen3) and at G = 12; no kernel launches on the CPU."""
    cfg, jcfg = configs(name, "float32")
    jp, tp = jax_and_port_params(jcfg)
    kw = dict(n_requests=3, batch=2, prompt_len=16, gen_len=5, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    tt, paths = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    assert paths is None and tuple(tt.shape) == (3, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ops.flash_attention.launches == ops.flash_decode.launches == 0


@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "musicgen-large"])
def test_loss_on_a_frontend_batch_matches_jax(name):
    cfg, jcfg = configs(name, "float32")
    jp, tp = jax_and_port_params(jcfg)
    batch = frontend_batch(cfg, "float32", labels=True)
    jl, jm = JT.loss_fn(jp, jcfg, as_jax(batch, jnp.float32),
                        opts=JT.ModelOptions(q_chunk=16, kv_chunk=16,
                                             loss_chunk=16))
    tl, tm = T.loss_fn(tp, cfg, as_torch(batch, "float32"),
                       opts=T.ModelOptions(q_chunk=16, kv_chunk=16,
                                           loss_chunk=16))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["ntok"]) == float(jm["ntok"]) == 2 * S


def _jax_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)
        out.append((keys, tuple(leaf.shape), np.dtype(leaf.dtype).name))
    return out


def _port_leaves(tree):
    return [(tuple(map(str, path)), tuple(t.shape),
             str(t.dtype).replace("torch.", ""))
            for path, t in leaves_with_paths(tree)]


@pytest.mark.parametrize("name", sorted(jax_list_configs())
                         + ["hymba-1.5b+mamba"])
def test_specs_match_the_reference_input_specs(name):
    """Every input of the four shapes, tree, shapes and dtypes, as the
    reference's ``input_specs`` with no plan gives them, from the meta
    device (nothing allocated).  With a plan the same stand-ins come back
    with their shardings beside them (their specs are held to the
    reference's in tests/test_torch_mesh.py).  ``<name>+mamba``: the
    configuration's widths with MAMBA blocks alone (no configuration has
    one), its cache the mamba states."""
    base, _, mamba = name.partition("+")
    cfg, jcfg = get_config(base), jax_get_config(base)
    if mamba:
        cfg = dataclasses.replace(cfg, block_pattern=(MAMBA,))
        jcfg = dataclasses.replace(jcfg, block_pattern=(MAMBA,))
    j_params = jax_specs.params_struct(jcfg)
    t_params = specs.params_struct(cfg)
    assert all(t.is_meta for _, t in leaves_with_paths(t_params))
    assert _port_leaves(t_params) == _jax_leaves(j_params)
    assert specs.nbytes(t_params) == sum(
        int(np.prod(s.shape)) * s.dtype.itemsize
        for s in jax.tree.leaves(j_params))
    for key, shape in SHAPES.items():
        want = dict(jax_specs.input_specs(jcfg, JAX_SHAPES[key]))
        got = specs.input_specs(cfg, shape)
        assert sorted(got) == sorted(want), key
        for part in want:
            if part == "params":
                continue
            assert _port_leaves(got[part]) == _jax_leaves(want[part]), \
                (key, part)
        if shape.kind != "decode":
            assert _port_leaves(specs.batch_struct(cfg, shape)) == \
                _jax_leaves(jax_specs.batch_struct(jcfg, JAX_SHAPES[key]))
        else:
            assert _port_leaves(specs.decode_struct(cfg, shape)) == \
                _jax_leaves(jax_specs.decode_struct(jcfg, JAX_SHAPES[key]))
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.launch.mesh import abstract_mesh
    plan = make_plan(abstract_mesh((1, 1), ("data", "model")))
    sharded = specs.input_specs(cfg, SHAPES["train_4k"], plan=plan)
    assert sorted(sharded.pop("shardings")) == sorted(sharded)
    assert _port_leaves(sharded["params"]) == _port_leaves(t_params)


@pytest.mark.parametrize("lead,shape", [((3,), (5, 7)), ((2,), (4, 3, 6)),
                                        ((), (9, 4))])
def test_dense_init_draws_one_slice_at_a_time(lead, shape):
    """``dense_init`` of a stack equals the stack of successive draws of
    one slice, so the fp32 transient is one slice; the distribution
    (truncated at 2 sigma, fan-in of the slice) is unchanged."""
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(11)
    b.manual_seed(11)
    got = TL.dense_init(a, shape, torch.bfloat16, scale=2.0, lead=lead)
    n = int(np.prod(lead)) if lead else 1
    want = torch.stack([TL.dense_init(b, shape, torch.bfloat16, scale=2.0)
                        for _ in range(n)]).reshape(lead + shape)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    std = 2.0 / shape[-2] ** 0.5
    assert float(got.float().abs().max()) <= 2 * std * (1 + 2 ** -7)
    meta = TL.dense_init(specs._META_GEN, shape, torch.bfloat16, lead=lead)
    assert meta.is_meta and meta.shape == got.shape
