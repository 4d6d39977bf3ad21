"""The port's xLSTM slice (xlstm-125m) against the JAX package: the mLSTM
chunkwise form, its recurrent step and the sLSTM recurrence on the same
numpy inputs (and the mLSTM against the port's sequential oracle
``ref.mlstm_ref``), and the reduced model (5 MLSTM + 1 SLSTM layers,
head_dim 16) given the same JAX-initialised parameters carried across
through numpy.  The JAX package has no mLSTM kernel; neither has the
port, so nothing here launches one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.launch.serve import _grow_cache as jax_grow
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as T
from repro_torch.models import xlstm

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

NAME = "xlstm-125m"
# float32: the chunkwise form and the recurrence reassociate the same
# sums of exponentials (measured about 1e-6 of the output scale)
TOL = dict(rtol=1e-4, atol=1e-5)


def mlstm_inputs(B, S, nh, dqk, dv, seed=0, with_state=False):
    """q/k/v N(0,1), input gate N(0,1), forget gate N(0,1) + 2 (mostly
    remembering), as float32 numpy; an entering state (H N*0.1 with the
    normaliser column positive, m N(0,1)) when asked."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = [f(B, S, nh, dqk), f(B, S, nh, dqk), f(B, S, nh, dv),
              f(B, S, nh), f(B, S, nh) + 2.0]
    state = None
    if with_state:
        H = f(B, nh, dqk, dv + 1) * 0.1
        H[..., -1] = np.abs(H[..., -1])
        state = (H, f(B, nh))
    return arrays, state


def as_torch(arrays, state):
    t = [torch.from_numpy(a) for a in arrays]
    ts = None if state is None else tuple(torch.from_numpy(s) for s in state)
    return t, ts


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_jax_and_oracle(chunk, with_state):
    """S = 48: chunk 8 and 16 divide it, 64 falls back to pick_chunk's
    largest divisor (48), as in the reference."""
    arrays, state = mlstm_inputs(2, 48, 3, 16, 24, seed=chunk,
                                 with_state=with_state)
    jh, (jH, jm) = jx.mlstm_chunked(
        *map(jnp.asarray, arrays), chunk=chunk,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    targs, tstate = as_torch(arrays, state)
    th, (tH, tm) = xlstm.mlstm_chunked(*targs, chunk=chunk, state=tstate)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
    # the port's oracle and the JAX package's agree step by step
    rh, (rH, rm) = ref.mlstm_ref(*targs, state=tstate)
    jrh, _ = jref.mlstm_ref(
        *map(jnp.asarray, arrays),
        state=None if state is None else tuple(map(jnp.asarray, state)))
    np.testing.assert_allclose(rh.numpy(), np.asarray(jrh), **TOL)
    np.testing.assert_allclose(th.numpy(), rh.numpy(), **TOL)
    np.testing.assert_allclose(tm.numpy(), rm.numpy(), **TOL)


def test_mlstm_chunked_entering_state_at_minus_1e30():
    """A serving cache's stabiliser starts at -1e30 (finite): the chunkwise
    form keeps it, as the reference does."""
    arrays, _ = mlstm_inputs(1, 16, 2, 8, 8, seed=5)
    H = np.zeros((1, 2, 8, 9), np.float32)
    m = np.full((1, 2), -1e30, np.float32)
    jh, (_, jm) = jx.mlstm_chunked(*map(jnp.asarray, arrays), chunk=8,
                                   state=(jnp.asarray(H), jnp.asarray(m)))
    targs, tstate = as_torch(arrays, (H, m))
    th, (_, tm) = xlstm.mlstm_chunked(*targs, chunk=8, state=tstate)
    assert np.isfinite(th.numpy()).all()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("m0", [-1e30, 0.5, float("-inf")])
def test_mlstm_decode_matches_jax(m0):
    """One recurrent step from a finite, a -1e30 and a -inf stabiliser
    (the isfinite guards)."""
    arrays, state = mlstm_inputs(2, 1, 3, 16, 24, seed=3, with_state=True)
    step = [a[:, 0] for a in arrays]
    H, _ = state
    m = np.full((2, 3), m0, np.float32)
    jh, (jH, jm) = jx.mlstm_decode(*map(jnp.asarray, step),
                                   (jnp.asarray(H), jnp.asarray(m)))
    th, (tH, tm) = xlstm.mlstm_decode(
        *map(torch.from_numpy, step),
        (torch.from_numpy(H), torch.from_numpy(m)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), **TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


def slstm_params(d, nh, seed):
    """The JAX package's sLSTM init at float32, as numpy; the bias is
    drawn too so that the gates are exercised."""
    p = jx.init_slstm_params(jax.random.PRNGKey(seed), d, nh, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    p["b"] = np.random.default_rng(seed).standard_normal(
        p["b"].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("S,time_block", [(12, 16), (10, 4), (7, 16)])
def test_slstm_forward_matches_jax(S, time_block):
    """time_block 16 over S = 12 halves to 4, 4 over 10 to 2, and over a
    prime S to 1; with and without an entering state."""
    d, nh, B = 32, 4, 2
    p = slstm_params(d, nh, seed=S)
    x = np.random.default_rng(S).standard_normal((B, S, d)).astype(
        np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jy, jst = jx.slstm_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               n_heads=nh, time_block=time_block)
    ty, tst = xlstm.slstm_forward(tp, torch.from_numpy(x), n_heads=nh,
                                  time_block=time_block)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for k in ("c", "n", "h", "m"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
    # continue from the state both sides returned
    jy2, _ = jx.slstm_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              n_heads=nh, state=jst, time_block=time_block)
    ty2, _ = xlstm.slstm_forward(tp, torch.from_numpy(x), n_heads=nh,
                                 state=tst, time_block=time_block)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), **TOL)


def configs(dtype):
    return (dataclasses.replace(get_config(NAME).reduced(), dtype=dtype),
            dataclasses.replace(jax_get_config(NAME).reduced(), dtype=dtype))


def jax_params(jcfg, temper=False):
    """The JAX package's seeded parameters as numpy.  With ``temper``, the
    mLSTM's wq, wk and wif are scaled by 1/8 (their fan-in is taken from
    the head axis, 4 here, so q.k scores and the exponential gates' pre-
    activations are tens: the model is then chaotic in bf16, where JAX in
    bf16 differs from JAX in f32 by 73% of the largest logit, and the 6
    recurrent layers amplify f32 reassociation to 1.4e-4 in 4 decode
    steps; tempered, 2.0% and 1.3e-6: scripts/xlstm_conditioning.py)."""
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    if temper:
        for e in tree["layers"].values():
            for w in ("wq", "wk", "wif") if "mlstm" in e else ():
                e["mlstm"][w] = (e["mlstm"][w].astype(np.float32) * 0.125
                                 ).astype(e["mlstm"][w].dtype)
    return tree


def jax_and_port_params(jcfg, temper=False):
    tree = jax_params(jcfg, temper)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def rel_err(t, j):
    t, j = np.asarray(t, np.float32), np.asarray(j, np.float32)
    return np.abs(t - j).max() / np.abs(j).max()


def test_init_tree_and_cache_match_jax():
    """The seeded init keeps the JAX tree with ``b_if`` and ``b`` float32
    in a bf16 model (kept so by ``params_from_jax``); the serving cache
    has the reference's states, stabilisers at -1e30."""
    cfg, jcfg = configs("bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = T.init_params(gen, cfg)
    _, conv = jax_and_port_params(jcfg)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    for e in jp["layers"]:
        for block, leaves in jp["layers"][e].items():
            if not isinstance(leaves, dict):
                continue
            for name, leaf in leaves.items():
                got, cv = tp["layers"][e][block][name], \
                    conv["layers"][e][block][name]
                assert tuple(got.shape) == leaf.shape, (e, block, name)
                want = torch.float32 if name in ("b_if", "b") \
                    else torch.bfloat16
                assert got.dtype == cv.dtype == want, (e, block, name)
    tc = T.init_cache(cfg, 2, 40, device="cpu")
    jc = JT.init_cache(jcfg, 2, 40)
    assert tc.keys() == jc.keys()
    for e in jc:
        assert tc[e].keys() == jc[e].keys(), e
        for name, leaf in jc[e].items():
            np.testing.assert_array_equal(tc[e][name].numpy(),
                                          np.asarray(leaf), err_msg=name)
    # _grow_cache leaves the recurrent states alone
    assert serve_mod._grow_cache(tc, 50, 40)["e0"]["H"] is tc["e0"]["H"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill (3 mLSTM chunks of 16) then 4 teacher-forced decode steps on
    tempered weights (``jax_params``), logits compared at every step.
    float32: within 1e-4 of the largest JAX logit.  bfloat16: XLA rounds a
    fused bf16 chain once and PyTorch after every op, and the exponential
    gates amplify either rounding, so both are held against JAX in f32 on
    the same (bf16-valued) weights: the port's distance from it within
    max(2e-2, 1.5x) JAX's own bf16 distance from it."""
    cfg, jcfg = configs(dtype)
    jp, tp = jax_and_port_params(jcfg, temper=True)
    bf16 = dtype == "bfloat16"
    if bf16:
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    S, steps = 48, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, S), np.int32)
    kw = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16)
    jopts, topts = JT.ModelOptions(**kw), T.ModelOptions(**kw)

    def check(tl, jl, jl32, what):
        if not bf16:
            assert rel_err(tl.numpy(), jl) <= 1e-4, what
            return
        ref_err = rel_err(jl, jl32)
        assert rel_err(tl.float().numpy(), jl32) <= max(2e-2, 1.5 * ref_err), \
            (what, ref_err)

    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    jl32, jc32 = (JT.prefill(jp32, jcfg32, jnp.asarray(toks), opts=jopts)
                  if bf16 else (None, None))
    check(tl, jl, jl32, "prefill")
    if not bf16:
        assert rel_err(tc["e0"]["H"].numpy(), jc["e0"]["H"]) <= 1e-4
        assert rel_err(tc["e5"]["c"].numpy(), jc["e5"]["c"]) <= 1e-4
    jc = jax_grow(jcfg, jc, 2, S + steps, S)
    tc = serve_mod._grow_cache(tc, S + steps, S)
    forced = np.random.default_rng(3).integers(0, cfg.vocab, (steps, 2))
    for t in range(steps):
        tok = jnp.asarray(forced[t], jnp.int32)
        jl, jc = JT.decode_step(jp, jcfg, jc, token=tok, pos=jnp.int32(S + t),
                                opts=jopts)
        if bf16:
            jl32, jc32 = JT.decode_step(jp32, jcfg32, jc32, token=tok,
                                        pos=jnp.int32(S + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
            forced[t]).long(), pos=S + t, opts=topts)
        check(tl, jl, jl32, f"step {t}")


def test_serve_matches_jax_serve():
    """Same seed, same prompts, identical tokens in f32; no kernel is
    launched (there is none on this path)."""
    cfg, jcfg = configs("float32")
    _, tp = jax_and_port_params(jcfg)
    kw = dict(n_requests=3, batch=2, prompt_len=32, gen_len=5, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    for name in ("flash_attention", "flash_decode", "ssm_scan"):
        getattr(ops, name).launches = 0
    tt, _ = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ops.flash_attention.launches == ops.flash_decode.launches == \
        ops.ssm_scan.launches == 0
