"""The port's MoE slice (granite-moe-1b-a400m) against the JAX package:
the local MoE FFN (router, top-k, capacity dispatch, experts, combine,
aux loss) on the same numpy inputs, and the reduced model (2 ATTN layers
with 4 experts top 2, head_dim 16) given the same JAX-initialised
parameters carried across through numpy.  On the CPU the attention
wrappers run their plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _grow_cache as jax_grow
from repro.launch.serve import serve as jax_serve
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import moe
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

NAME = "granite-moe-1b-a400m"


def close(t, j, dtype, f32_tol=1e-5, err_msg=""):
    """float32: elementwise at ``f32_tol``.  bfloat16: the max abs error
    within 2e-2 of the largest reference value (XLA rounds a fused bf16
    chain once, PyTorch after every op; tests/test_torch_model.py)."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 2e-2, f"{err_msg}: max abs error {err:.4g} of max |ref|"
    else:
        np.testing.assert_allclose(t, j, rtol=f32_tol, atol=f32_tol,
                                   err_msg=err_msg)


def moe_inputs(T_, d, f, E, dtype, seed=0):
    """x N(0,1), router N*0.5 (fp32, random logits: no top-k ties), expert
    weights N*0.2, as numpy in ``dtype``."""
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(dtype)
    x = rng.standard_normal((T_, d)).astype(dt)
    wr = (rng.standard_normal((d, E)) * 0.5).astype(np.float32)
    w1, w3 = ((rng.standard_normal((E, d, f)) * 0.2).astype(dt)
              for _ in range(2))
    w2 = (rng.standard_normal((E, f, d)) * 0.2).astype(dt)
    return x, wr, w1, w3, w2


def to_torch(*arrays):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        out.append(t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t)
    return out


def kept_slots(eidx, E, capacity):
    """How many (token, k) assignments fit under ``capacity``."""
    counts = np.zeros(E, int)
    kept = 0
    for e in np.asarray(eidx).reshape(-1):
        kept += counts[e] < capacity
        counts[e] += 1
    return kept


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [32, 5])
def test_local_moe_matches_jax(dtype, capacity):
    """64 tokens, 8 experts top 2: capacity 32 (none dropped at these
    draws) and 5 (most assignments dropped, the dump row in use); the
    output and the aux loss."""
    T_, d, f, E, k = 64, 32, 48, 8, 2
    arrays = moe_inputs(T_, d, f, E, dtype)
    jy, jaux = jmoe._local_moe(
        *map(jnp.asarray, arrays), n_experts=E, top_k=k, capacity=capacity,
        e_loc=E, model_axis=None, fsdp_axis=None, dp_axes=())
    ty, taux = moe._local_moe(*to_torch(*arrays), n_experts=E, top_k=k,
                              capacity=capacity)
    assert ty.dtype == getattr(torch, dtype) and tuple(ty.shape) == jy.shape
    close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    probs = jax.nn.softmax(jnp.asarray(arrays[0], jnp.float32)
                           @ jnp.asarray(arrays[1]), -1)
    kept = kept_slots(jax.lax.top_k(probs, k)[1], E, capacity)
    assert (kept < T_ * k) == (capacity == 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype):
    """(B, S, d) through ``moe_ffn``'s local path: capacity from the
    capacity factor, as in the reference."""
    B, S, d, f, E, k = 2, 24, 32, 48, 8, 2
    x, wr, w1, w3, w2 = moe_inputs(B * S, d, f, E, dtype, seed=1)
    x = x.reshape(B, S, d)
    params = dict(router=wr, w1=w1, w3=w3, w2=w2)
    jy, jaux = jmoe.moe_ffn({n: jnp.asarray(a) for n, a in params.items()},
                            jnp.asarray(x), n_experts=E, top_k=k,
                            capacity_factor=1.25, mesh_args=None)
    tp = dict(zip(params, to_torch(*params.values())))
    ty, taux = moe.moe_ffn(tp, to_torch(x)[0], n_experts=E, top_k=k,
                           capacity_factor=1.25)
    close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def configs(dtype):
    return (dataclasses.replace(get_config(NAME).reduced(), dtype=dtype),
            dataclasses.replace(jax_get_config(NAME).reduced(), dtype=dtype))


def jax_and_port_params(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_init_tree_and_convert_keep_fp32_router():
    """The seeded init keeps the JAX tree (keys, shapes, dtypes), the
    router is float32 in a bf16 model on both sides, and
    ``params_from_jax`` keeps it so."""
    cfg, jcfg = configs("bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = T.init_params(gen, cfg)
    jp, conv = jax_and_port_params(jcfg)
    flat = lambda tree, pre="": [  # noqa: E731
        kv for k, v in tree.items() for kv in (
            flat(v, f"{pre}{k}/") if isinstance(v, dict)
            else [(f"{pre}{k}", v)])]
    t, c = dict(flat(tp)), dict(flat(conv))
    j = dict(flat(jax.tree.map(np.asarray, jp)))
    assert t.keys() == j.keys() == c.keys()
    assert "layers/e0/moe/router" in t and "layers/e0/ffn/w1" not in t
    for key, v in t.items():
        assert tuple(v.shape) == j[key].shape, key
        want = torch.float32 if key.endswith("router") else torch.bfloat16
        assert v.dtype == c[key].dtype == want, key
    assert str(j["layers/e0/moe/router"].dtype) == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill logits and cache, then 6 teacher-forced decode steps, logits
    compared at every step.  The top-2 routing of a bf16 hidden state can
    flip between near-equal experts under one rounding and not the
    other, so bf16 is held at the largest-value tolerance."""
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg)
    S, steps = 48, 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S), np.int32)
    kw = dict(q_chunk=16, kv_chunk=16)
    jopts, topts = JT.ModelOptions(**kw), T.ModelOptions(**kw)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    close(tl, jl, dtype, f32_tol=1e-4, err_msg="prefill")
    close(tc["e0"]["k"], jc["e0"]["k"], dtype, f32_tol=1e-4)
    jc = jax_grow(jcfg, jc, 2, S + steps, S)
    tc = serve_mod._grow_cache(tc, S + steps, S)
    forced = np.random.default_rng(3).integers(0, cfg.vocab, (steps, 2))
    for t in range(steps):
        jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
            forced[t], jnp.int32), pos=jnp.int32(S + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
            forced[t]).long(), pos=S + t, opts=topts)
        close(tl, jl, dtype, f32_tol=1e-4, err_msg=f"step {t}")


def test_serve_matches_jax_serve():
    """Same seed, same prompts, identical tokens in f32; no kernel
    launches on the CPU."""
    cfg, jcfg = configs("float32")
    _, tp = jax_and_port_params(jcfg)
    kw = dict(n_requests=3, batch=2, prompt_len=32, gen_len=5, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    tt, _ = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ops.flash_attention.launches == ops.flash_decode.launches == 0
