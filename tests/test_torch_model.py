"""The port's serving slice (qwen2-1.5b reduced) against the JAX package,
given the same JAX-initialised parameters carried across through numpy.
On the CPU both attention wrappers run their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)


def configs(dtype):
    return (dataclasses.replace(get_config("qwen2-1.5b").reduced(),
                                dtype=dtype),
            dataclasses.replace(jax_get_config("qwen2-1.5b").reduced(),
                                dtype=dtype))


def jax_and_port_params(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def close(t, j, dtype, err_msg=""):
    """float32: elementwise at 1e-4.  bfloat16: the max abs error within
    2e-2 of the largest reference value.  XLA on the CPU fuses bf16
    elementwise chains in f32 and rounds once, where PyTorch rounds after
    every op, so the two differ by a few bf16 ulps at the tensor's scale,
    which an elementwise rtol cannot bound at values near zero."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 2e-2, f"{err_msg}: max abs error {err:.4g} of max |ref|"
    else:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4,
                                   err_msg=err_msg)


def prompts(vocab, B=2, S=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache(dtype):
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg)
    toks = prompts(cfg.vocab)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks),
                        opts=JT.ModelOptions(q_chunk=32, kv_chunk=32))
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(),
                       opts=T.ModelOptions(q_chunk=32, kv_chunk=32))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    close(tl, jl, dtype)
    for key in ("k", "v"):
        assert tuple(tc["e0"][key].shape) == jc["e0"][key].shape
        assert tc["e0"][key].dtype == getattr(torch, dtype)
        close(tc["e0"][key], jc["e0"][key], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_teacher_forced(dtype):
    """8 decode steps fed the same tokens on both sides, logits compared
    at every step (one near-tie argmax cannot cascade)."""
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg)
    S, steps = 32, 8
    toks = prompts(cfg.vocab, S=S, seed=2)
    jopts = JT.ModelOptions(q_chunk=32, kv_chunk=32)
    topts = T.ModelOptions(q_chunk=32, kv_chunk=32)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    from repro.launch.serve import _grow_cache as jax_grow
    jc = jax_grow(jcfg, jc, 2, S + steps, S)
    tc = serve_mod._grow_cache(tc, S + steps, S)
    forced = np.random.default_rng(3).integers(0, cfg.vocab, (steps, 2))
    for t in range(steps):
        jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
            forced[t], jnp.int32), pos=jnp.int32(S + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
            forced[t]).long(), pos=S + t, opts=topts)
        close(tl, jl, dtype, err_msg=f"step {t}")
    close(tc["e0"]["k"], jc["e0"]["k"], dtype)


def test_serve_matches_jax_serve():
    """Same seed, same prompts (the same numpy rng calls), identical
    tokens in f32; the wrappers never launch a kernel on the CPU."""
    cfg, jcfg = configs("float32")
    jp, tp = jax_and_port_params(jcfg)
    kw = dict(n_requests=5, batch=2, prompt_len=32, gen_len=6, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    tt, paths = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    assert paths is None
    assert tt.dtype == torch.long and tuple(tt.shape) == (5, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ops.flash_attention.launches == 0
    assert ops.flash_decode.launches == 0


def test_init_params_tree_matches_jax():
    """Seeded init on the port keeps the JAX tree: same keys, shapes and
    dtypes, so JAX parameters load by key."""
    cfg, jcfg = configs("bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = T.init_params(gen, cfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    flat_t = {k: v for k, v in _flatten(tp)}
    flat_j = {k: v for k, v in _flatten(jp)}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert v.dtype == torch.bfloat16, k
    assert torch.equal(tp["layers"]["e0"]["ln1"],
                       torch.ones_like(tp["layers"]["e0"]["ln1"]))


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_init_cache_and_grow_match_jax():
    cfg, jcfg = configs("float32")
    tc = T.init_cache(cfg, 2, 40, device="cpu")
    jc = JT.init_cache(jcfg, 2, 40)
    assert tc.keys() == jc.keys()
    for key in ("k", "v"):
        assert tuple(tc["e0"][key].shape) == jc["e0"][key].shape
    grown = serve_mod._grow_cache(
        {"e0": {"k": torch.ones(2, 2, 8, 2, 16), "v": torch.ones(
            2, 2, 8, 2, 16)}}, 12, 8)
    assert tuple(grown["e0"]["k"].shape) == (2, 2, 12, 2, 16)
    assert float(grown["e0"]["k"][:, :, 8:].abs().sum()) == 0.0
    assert float(grown["e0"]["v"][:, :, :8].sum()) == 2 * 2 * 8 * 2 * 16

