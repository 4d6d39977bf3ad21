"""The port's hybrid slice (hymba-1.5b reduced: 2 HYBRID layers, head_dim
16, window 64) against the JAX package, given the same JAX-initialised
parameters carried across through numpy.  On the CPU the attention and
SSD-scan wrappers run their plain versions.  Prompts of 96 > window 64
make the prefill ring roll by 96 % 64 = 32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _grow_cache as jax_grow
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import SWA
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

PROMPT = 96
CACHE_KEYS = ("k", "v", "ssm", "conv")


def configs(dtype, name="hymba-1.5b", **over):
    return (dataclasses.replace(get_config(name).reduced(), dtype=dtype,
                                **over),
            dataclasses.replace(jax_get_config(name).reduced(), dtype=dtype,
                                **over))


def jax_params(jcfg):
    return JT.init_params(jax.random.PRNGKey(0), jcfg)


def jax_and_port_params(jcfg, temper=False):
    """JAX-initialised parameters and the port's copy of them.  With
    ``temper``, wq and wk are halved on both sides: the init takes their
    fan-in from the head axis, so raw scores are large, the softmax is
    near one-hot, and bf16 rounding in one package flips near-ties the
    other keeps (measured: up to 4% of the largest logit untempered,
    about 1% tempered, against about 5% between either package in bf16
    and the same weights in f32)."""
    tree = jax.tree.map(np.asarray, jax_params(jcfg))
    if temper:
        for attn in (e["attn"] for e in tree["layers"].values()):
            for w in ("wq", "wk"):
                attn[w] = (attn[w].astype(np.float32) * 0.5
                           ).astype(attn[w].dtype)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def close(t, j, dtype, err_msg=""):
    """float32: elementwise at 1e-4.  bfloat16: the max abs error within
    2e-2 of the largest reference value (XLA rounds a fused bf16 chain
    once, PyTorch after every op; tests/test_torch_model.py)."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 2e-2, f"{err_msg}: max abs error {err:.4g} of max |ref|"
    else:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4,
                                   err_msg=err_msg)


def options():
    kw = dict(q_chunk=32, kv_chunk=32, ssm_chunk=32)
    return JT.ModelOptions(**kw), T.ModelOptions(**kw)


def prompts(vocab, B=2, S=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), np.int32)


def test_convert_keeps_fp32_leaves_in_bf16_model():
    """The mamba mixer's dt_bias, A_log and D and the hybrid mix beta are
    float32 in the JAX package whatever the model dtype; the bridge keeps
    each leaf's dtype."""
    _, jcfg = configs("bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jax_params(jcfg)), "cpu")
    e0 = tp["layers"]["e0"]
    for name in ("dt_bias", "A_log", "D"):
        assert e0["mamba"][name].dtype == torch.float32, name
    assert e0["beta"].dtype == torch.float32
    assert e0["mamba"]["in_proj"].dtype == torch.bfloat16
    assert e0["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache(dtype):
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg, temper=dtype == "bfloat16")
    jopts, topts = options()
    toks = prompts(cfg.vocab)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, dtype, "logits")
    assert tc["e0"].keys() == jc["e0"].keys() == set(CACHE_KEYS)
    for key in CACHE_KEYS:
        assert tuple(tc["e0"][key].shape) == jc["e0"][key].shape, key
        assert _dtype_name(tc["e0"][key]) == _dtype_name(jc["e0"][key]), key
        close(tc["e0"][key], jc["e0"][key], dtype, key)
    assert tc["e0"]["k"].shape[2] == cfg.window     # the ring, not S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_teacher_forced(dtype):
    """8 decode steps fed the same tokens on both sides, logits compared
    at every step; they write ring slots 32..39 over positions 96..103."""
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg, temper=dtype == "bfloat16")
    jopts, topts = options()
    steps = 8
    toks = prompts(cfg.vocab, seed=2)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    jc = jax_grow(jcfg, jc, 2, PROMPT + steps, PROMPT)
    tc = serve_mod._grow_cache(tc, PROMPT + steps, PROMPT)
    forced = np.random.default_rng(3).integers(0, cfg.vocab, (steps, 2))
    for t in range(steps):
        jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
            forced[t], jnp.int32), pos=jnp.int32(PROMPT + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
            forced[t]).long(), pos=PROMPT + t, opts=topts)
        close(tl, jl, dtype, err_msg=f"step {t}")
    for key in CACHE_KEYS:
        close(tc["e0"][key], jc["e0"][key], dtype, key)


def test_serve_matches_jax_serve():
    """Same seed, same prompts (the same numpy rng calls), identical
    tokens in f32; no wrapper launches a kernel on the CPU."""
    cfg, jcfg = configs("float32")
    _, tp = jax_and_port_params(jcfg)
    kw = dict(n_requests=3, batch=2, prompt_len=PROMPT, gen_len=6, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    ops.ssm_scan.launches = 0
    tt, paths = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    assert paths is None
    assert tt.dtype == torch.long and tuple(tt.shape) == (3, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ops.flash_attention.launches == 0
    assert ops.flash_decode.launches == 0
    assert ops.ssm_scan.launches == 0


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _dtype_name(v):
    return str(v.dtype).split(".")[-1] if isinstance(v, torch.Tensor) \
        else v.dtype.name


def test_init_params_tree_matches_jax():
    """Seeded init on the port keeps the JAX tree: same keys, shapes and
    dtypes (the fp32 leaves included), so JAX parameters load by key."""
    cfg, jcfg = configs("bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    flat_t = dict(_flatten(T.init_params(gen, cfg)))
    flat_j = dict(_flatten(jax_params(jcfg)))
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert _dtype_name(v) == _dtype_name(flat_j[k]), k
    assert flat_t["layers/e0/beta"].dtype == torch.float32


@pytest.mark.parametrize("max_len", [40, 200])
def test_init_cache_matches_jax(max_len):
    """The ring is min(window, max_len) slots; ssm is fp32, conv in the
    model dtype."""
    cfg, jcfg = configs("bfloat16")
    tc = T.init_cache(cfg, 2, max_len, device="cpu")
    jc = JT.init_cache(jcfg, 2, max_len)
    assert tc.keys() == jc.keys()
    for e in tc:
        assert tc[e].keys() == jc[e].keys()
        for key, v in tc[e].items():
            assert tuple(v.shape) == jc[e][key].shape, key
            assert _dtype_name(v) == _dtype_name(jc[e][key]), key


def test_swa_entries_match_jax():
    """SWA blocks share the window code: qwen2 reduced with every layer
    SWA (window 16), prefill of 48 and 4 decode steps, f32."""
    over = dict(block_pattern=(SWA,), window=16)
    cfg, jcfg = configs("float32", "qwen2-1.5b", **over)
    jp, tp = jax_and_port_params(jcfg)
    jopts, topts = options()
    toks = prompts(cfg.vocab, S=48, seed=4)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    close(tl, jl, "float32", "prefill")
    for t in range(4):
        tok = tl.argmax(-1)
        jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
            tok.numpy(), jnp.int32), pos=jnp.int32(48 + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=tok, pos=48 + t,
                               opts=topts)
        close(tl, jl, "float32", f"step {t}")
