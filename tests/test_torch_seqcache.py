"""A serving cache split over its sequence on a mesh, on the CPU: the
port's sharded prefill writes each rank's slots of every kv head, as the
JAX package's ``cache_shardings`` lays them out (``kv_seq_axis="model"``,
or kv heads the model axis does not divide), and its sharded decode
merges the ranks' partial attentions by log-sum-exp
(``attention.split_decode``).  The logits of a 16-token prefill and 6
decode steps over a 32-slot cache are held to the JAX package's
unsharded steps on the same weights and tokens, within 1e-5 of the
largest logit (the tolerance of ``tests/test_torch_sharded_train.py``'s
serving comparison).  The port runs in gloo ranks (``torch_ranks.py``).

The cases: reduced qwen2 (2 kv heads) on (1, 4), where the guard keeps
``wk``/``wv`` whole and the cache's sequence goes over ``model``; reduced
qwen2 with ``kv_seq_axis="model"`` on (1, 2) and (2, 2), where the new
token's kv heads are gathered before its slot is written; reduced hymba
with an 8-slot window, a ring shorter than the prompt, on (1, 4) and
with ``kv_seq_axis`` on (2, 2) and (1, 2) (its mamba states split over
``model`` too, gathered for each step); reduced hymba's widths with a
MAMBA block and an ATTN block (``hymba-1.5b+mamba-attn``, the block
pattern replaced on both sides, ``torch_ranks.reduced_config``) with
``kv_seq_axis`` on (2, 2): the ATTN
layer's k/v split over their sequence, the MAMBA layer's states whole in
the step.  At the first decode step of
(1, 4) the last rank holds no valid slot: its kernel call has length
0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro.launch.serve import _grow_cache
from repro.models import transformer as JT
from repro_torch.kernels import decode_attention as fd

torch.set_num_threads(1)

PROMPT, MAX_LEN, N_DECODE = 16, 32, 6
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
FOUR = [("qwen2-1.5b", 0, (1, 4), None),
        ("qwen2-1.5b", 0, (2, 2), "model"),
        ("hymba-1.5b", 8, (1, 4), None),
        ("hymba-1.5b", 8, (2, 2), "model"),
        ("hymba-1.5b+mamba-attn", 0, (2, 2), "model")]
TWO = [("qwen2-1.5b", 0, (1, 2), "model"),
       ("hymba-1.5b", 8, (1, 2), "model")]


def key(case) -> str:
    name, window, shape, kv_axis = case
    return f"{name}_{window}_{shape[0]}x{shape[1]}_{kv_axis}"


def jax_config(name, window):
    cfg = torch_ranks.reduced_config(jax_get_config, name)
    return dataclasses.replace(cfg, window=window) if window else cfg


def jax_params(name):
    """The JAX package's seed-0 params of reduced ``name``, wq and wk of
    the attention tempered by 1/8 (as the sharded train tests')."""
    p = JT.init_params(jax.random.PRNGKey(0),
                       torch_ranks.reduced_config(jax_get_config, name))

    def temper(path, v):
        keys = [str(k.key) for k in path]
        if keys[-2:-1] == ["attn"] and keys[-1] in ("wq", "wk"):
            return v / 8
        return v
    return jax.tree_util.tree_map_with_path(temper, p)


def save_init(params, dest):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(dest, **{"init/" + "/".join(str(k.key) for k in path):
                      np.asarray(v) for path, v in flat})


def jax_logits(name, window, params, toks, nxt):
    """The JAX package's unsharded prefill and decode steps."""
    cfg = jax_config(name, window)
    opts = JT.ModelOptions(**CHUNKS)
    pre = jax.jit(jsteps.make_prefill_step(cfg, None, opts))
    dec = jax.jit(jsteps.make_decode_step(cfg, None, opts))
    logits, cache = pre(params, {"tokens": jnp.asarray(toks)})
    cache = _grow_cache(cfg, cache, toks.shape[0], MAX_LEN, PROMPT)
    outs = [np.asarray(logits)]
    for i in range(N_DECODE):
        logits, cache = dec(params, cache, jnp.int32(PROMPT + i),
                            jnp.asarray(nxt[:, i]))
        outs.append(np.asarray(logits))
    return np.stack(outs)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqcache")
    params = {n: jax_params(n) for n in {c[0] for c in FOUR + TWO}}
    for n, p in params.items():
        save_init(p, tmp / f"{n}_init.npz")
    rng = np.random.default_rng(3)
    vocab = jax_get_config("qwen2-1.5b").reduced().vocab
    toks = rng.integers(0, vocab, (4, PROMPT)).astype(np.int32)
    nxt = rng.integers(0, vocab, (4, N_DECODE)).astype(np.int32)
    np.savez(tmp / "seq_inputs.npz", tokens=toks, next=nxt)
    kw = dict(out=str(tmp), ref=str(tmp), prompt=PROMPT, max_len=MAX_LEN,
              n_decode=N_DECODE)
    torch_ranks.run_ranks("seqcache_cases", 4, tmp, timeout=240,
                          cases=[list(c) for c in FOUR], **kw)
    torch_ranks.run_ranks("seqcache_cases", 2, tmp, timeout=240,
                          cases=[list(c) for c in TWO], **kw)
    want = {(n, w): jax_logits(n, w, params[n], toks, nxt)
            for n, w in {(c[0], c[1]) for c in FOUR + TWO}}
    return tmp, want


@pytest.mark.parametrize("case", FOUR + TWO, ids=[key(c) for c in FOUR + TWO])
def test_split_sequence_serving_matches_unsharded_jax(results, case):
    """Every step's logits within 1e-5 of the largest of the JAX
    package's unsharded steps, and the cache's k/v really split over
    their sequence on the mesh."""
    tmp, want = results
    got = np.load(tmp / f"port_{key(case)}.npz")
    w = want[case[0], case[1]]
    assert got["logits"].shape == w.shape == (N_DECODE + 1, 4, 256)
    assert int(got["split"]) > 0
    assert np.abs(got["logits"] - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("length", [0, 1, 37, 64])
def test_flash_decode_plain_lse_against_float64(length):
    """``flash_decode_plain``'s log-sum-exp against a float64 one of the
    same scaled scores over the first ``length`` keys, within 1e-5
    (fp32 scores); at length 0 the lse is -inf and the output 0."""
    rng = np.random.default_rng(length)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 6, 16), (2, 64, 3, 16), (2, 64, 3, 16)))
    out, lse = fd.flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), length,
                                     with_lse=True)
    assert lse.shape == (2, 6) and lse.dtype == torch.float32
    if length == 0:
        assert torch.isneginf(lse).all() and not out.any()
        return
    s = np.einsum("bhgd,bshd->bhgs", q.reshape(2, 3, 2, 16).astype(np.float64),
                  k[:, :length].astype(np.float64)) / 4.0
    top = s.max(-1, keepdims=True)
    want = (top[..., 0] + np.log(np.exp(s - top).sum(-1))).reshape(2, 6)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    # the output is the function without lse, bitwise
    assert torch.equal(out, fd.flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        length))


def test_merged_partials_are_the_whole_attention():
    """Partial attentions over slices of a cache (one of them empty),
    merged by their log-sum-exp as ``attention.merge_partials`` does,
    equal the attention over the whole cache within 1e-6."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    length = 23
    parts = [fd.flash_decode_plain(q, k[:, a:b], v[:, a:b],
                                   max(0, min(length - a, b - a)),
                                   with_lse=True)
             for a, b in ((0, 10), (10, 20), (20, 30), (30, 40))]
    lse = torch.stack([p[1] for p in parts])
    top = lse.amax(0)
    w = torch.exp(lse - top)
    got = sum(p[0] * wi[..., None] for p, wi in zip(parts, w)) \
        / w.sum(0)[..., None]
    want = fd.flash_decode_plain(q, k, v, length)
    assert torch.isneginf(parts[-1][1]).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
