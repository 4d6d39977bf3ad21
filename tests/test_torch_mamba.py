"""The port's MAMBA blocks (the mamba mixer alone, no FFN) against the JAX
package's, on reduced hymba-1.5b widths (d 64, 4 heads of 16, state 16)
with ``block_pattern`` (MAMBA,) and (MAMBA, ATTN), and (MAMBA,) with an
MoE set (the MAMBA entry takes no FFN, MoE or dense).  No configuration
of the JAX package has a MAMBA block: both sides build it here.  The JAX
package runs as its own tests run it on the CPU (its plain SSD scan);
the port's wrappers run their plain versions on CPU tensors.  Inputs are
seeded numpy draws; the parameters are the JAX package's seed-0 init,
carried across through ``convert.params_from_jax``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch import steps as jsteps
from repro.launch.serve import _grow_cache as jax_grow
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, MAMBA, MoEConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths

torch.set_num_threads(1)

PATTERNS = {"mamba": (MAMBA,), "mamba-attn": (MAMBA, ATTN)}
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
PROMPT = 40     # not a multiple of the SSD chunk (16)


def configs(pattern, dtype="float32", moe=False):
    """(port config, JAX config): reduced hymba at ``pattern``; with
    ``moe`` every layer marked MoE (``moe_every`` 1)."""
    out = []
    for get, moe_cls in ((get_config, MoEConfig),
                         (jax_get_config, JMoEConfig)):
        over = dict(block_pattern=PATTERNS[pattern], dtype=dtype)
        if moe:
            over["moe"] = moe_cls(n_experts=4, top_k=2, moe_every=1)
        out.append(dataclasses.replace(get("hymba-1.5b").reduced(), **over))
    return tuple(out)


def jax_numpy_params(jcfg, temper=False):
    """The JAX package's seed-0 params as numpy; ``temper`` scales the
    attention's wq and wk by 1/8 (tests/test_torch_arch.py: bf16 rounding
    flips near-ties of the untempered softmax in one package and not the
    other)."""
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(0), jcfg))
    for e in tree["layers"].values():
        for w in ("wq", "wk") if temper and "attn" in e else ():
            e["attn"][w] = (e["attn"][w].astype(np.float32) / 8
                            ).astype(e["attn"][w].dtype)
    return tree


def params_pair(jcfg, temper=False):
    tree = jax_numpy_params(jcfg, temper)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def close(t, j, dtype, what=""):
    """float32: elementwise at 1e-4.  bfloat16: the max abs error within
    2e-2 of the largest reference value (XLA rounds a fused bf16 chain
    once, PyTorch after every op)."""
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    if dtype == "bfloat16":
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err <= 2e-2, f"{what}: max abs error {err:.4g} of max |ref|"
    else:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=what)


def options():
    return JT.ModelOptions(**CHUNKS), T.ModelOptions(**CHUNKS)


def prompts(vocab, S=PROMPT, B=2, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S), np.int32)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
INIT_CASES = [("mamba", False), ("mamba-attn", False), ("mamba", True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern,moe", INIT_CASES,
                         ids=["mamba", "mamba-attn", "mamba-moe"])
def test_init_tree_is_the_references(pattern, moe, dtype):
    """Names, shapes and dtypes of ``init_params`` leaf for leaf the JAX
    package's: a MAMBA entry holds ``ln1`` and ``mamba`` alone (no FFN
    and no MoE, even where the layer is marked MoE), its ``dt_bias``,
    ``A_log`` and ``D`` float32 in a bf16 model; ``params_from_jax``
    carries every leaf across in its own dtype."""
    cfg, jcfg = configs(pattern, dtype, moe)
    got = T.init_params(torch.Generator().manual_seed(0), cfg)
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    want = dict(leaves_with_paths(jax.tree.map(
        lambda s: (tuple(s.shape), str(s.dtype)), want,
        is_leaf=lambda s: isinstance(s, jax.ShapeDtypeStruct))))
    assert {p: (tuple(v.shape), _dtype(v))
            for p, v in leaves_with_paths(got)} == want
    e0 = got["layers"]["e0"]
    assert sorted(e0) == ["ln1", "mamba"]
    for name in ("dt_bias", "A_log", "D"):
        assert e0["mamba"][name].dtype == torch.float32
    converted = params_from_jax(jax_numpy_params(jcfg), "cpu")
    assert {p: (tuple(v.shape), _dtype(v))
            for p, v in leaves_with_paths(converted)} == want


def test_n_params_counts_the_references_inner():
    """``ModelConfig.n_params`` keeps the JAX package's formula, which
    sizes a MAMBA block's inner as 2·d where ``init_ssm_params`` builds
    n_heads·head_dim: at hymba-1.5b's widths (inner 1600 = d) 597,507,200
    counted against 351,341,600 built (ROADMAP §3)."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              block_pattern=(MAMBA,))
    jcfg = dataclasses.replace(jax_get_config("hymba-1.5b"),
                               block_pattern=(MAMBA,))
    from repro_torch.launch import specs
    built = sum(t.numel() for _, t in leaves_with_paths(
        specs.params_struct(cfg)))
    assert cfg.n_params() == jcfg.n_params() == 597_507_200
    assert built == 351_341_600


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
SERVE_CASES = [(p, d) for p in PATTERNS for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("pattern,dtype", SERVE_CASES)
def test_prefill_logits_and_states(pattern, dtype):
    """The last logits and every cache leaf (the mamba ``ssm`` fp32 and
    ``conv`` in the model dtype, an ATTN layer's k/v)."""
    cfg, jcfg = configs(pattern, dtype)
    jp, tp = params_pair(jcfg, temper=dtype == "bfloat16")
    jopts, topts = options()
    toks = prompts(cfg.vocab)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    close(tl, jl, dtype, "logits")
    assert tc.keys() == jc.keys()
    for e in jc:
        assert tc[e].keys() == jc[e].keys()
        for key in jc[e]:
            assert tuple(tc[e][key].shape) == jc[e][key].shape, (e, key)
            assert _dtype(tc[e][key]) == str(jc[e][key].dtype), (e, key)
            close(tc[e][key], jc[e][key], dtype, f"{e}/{key}")
    assert tc["e0"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("prompt", [PROMPT, 2], ids=["long", "short"])
@pytest.mark.parametrize("pattern,dtype", SERVE_CASES)
def test_decode_steps_teacher_forced(pattern, dtype, prompt):
    """8 decode steps fed the same tokens on both sides after the prefill,
    the logits at every step and the states after the last.  The short
    prompt (2 tokens, under the conv's CONV_W - 1 = 3) leaves zero
    padding in the prefill's conv carry, which the decode reads."""
    cfg, jcfg = configs(pattern, dtype)
    jp, tp = params_pair(jcfg, temper=dtype == "bfloat16")
    jopts, topts = options()
    n = 8
    toks = prompts(cfg.vocab, S=prompt, seed=2)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks), opts=jopts)
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long(), opts=topts)
    if prompt < ssm_mod.CONV_W - 1:
        pad = ssm_mod.CONV_W - 1 - prompt
        assert not tc["e0"]["conv"][:, :, :pad].any()
    jc = jax_grow(jcfg, jc, 2, prompt + n, prompt)
    tc = serve_mod._grow_cache(tc, prompt + n, prompt)
    forced = np.random.default_rng(3).integers(0, cfg.vocab, (n, 2))
    for t in range(n):
        jl, jc = JT.decode_step(jp, jcfg, jc, token=jnp.asarray(
            forced[t], jnp.int32), pos=jnp.int32(prompt + t), opts=jopts)
        tl, tc = T.decode_step(tp, cfg, tc, token=torch.from_numpy(
            forced[t]).long(), pos=prompt + t, opts=topts)
        close(tl, jl, dtype, f"step {t}")
    for e in jc:
        for key in jc[e]:
            close(tc[e][key], jc[e][key], dtype, f"{e}/{key}")


def test_grow_cache_pads_only_k_and_v():
    """``serve``'s cache growth pads the k/v sequence axis and leaves the
    mamba states as they are."""
    cfg, _ = configs("mamba-attn")
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    for c in cache.values():
        for v in c.values():
            v.normal_()
    grown = serve_mod._grow_cache(cache, 12, 8)
    assert grown["e1"]["k"].shape[2] == 12
    for key in ("ssm", "conv"):
        assert torch.equal(grown["e0"][key], cache["e0"][key])


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_serve_tokens_are_the_references(pattern):
    """``serve`` on the same seed and prompts: identical tokens in f32;
    on the CPU no wrapper launches a kernel."""
    cfg, jcfg = configs(pattern)
    _, tp = params_pair(jcfg)
    kw = dict(n_requests=3, batch=2, prompt_len=PROMPT, gen_len=6, seed=0)
    jt, _ = jax_serve(jcfg, **kw)
    ops.flash_attention.launches = ops.flash_decode.launches = 0
    ops.ssm_scan.launches = 0
    tt, _ = serve_mod.serve(cfg, device="cpu", params=tp, **kw)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert ops.ssm_scan.launches == ops.flash_attention.launches == \
        ops.flash_decode.launches == 0


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mamba_block_routes_the_scan_by_the_option(mode, monkeypatch):
    """A MAMBA block hands ``ModelOptions.use_flash_kernel`` to the scan,
    as a HYBRID block does: the kernel's op by default, the plain scan
    only when asked, which on CUDA tensors raises
    (``tests/test_torch_train.py::test_no_option_takes_the_card_off_the_
    kernels``): no MAMBA layer on the card takes the plain scan.  (The
    JAX package's MAMBA branch passes no ``use_kernel``: its plain scan,
    the same function.)"""
    from repro_torch.tree import tree_map
    cfg, _ = configs("mamba")
    entry = tree_map(lambda t: t[0], T.init_params(
        torch.Generator().manual_seed(0), cfg)["layers"]["e0"])
    seen, real = [], ssm_mod.ssd_chunked

    def spy(*args, use_kernel=True, **kwargs):
        seen.append(use_kernel)
        return real(*args, use_kernel=use_kernel, **kwargs)
    monkeypatch.setattr(ssm_mod, "ssd_chunked", spy)
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator(
    ).manual_seed(5))
    outs = []
    for kernel in (True, False):
        y, new, aux = T._apply_entry(
            entry, T.EntrySpec(MAMBA, False), x, None, cfg,
            T.ModelOptions(**CHUNKS, use_flash_kernel=kernel), mode)
        assert (new is None) == (mode == "train") and aux == 0.0
        outs.append(y)
    assert seen == [True, False]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def lm_batch(vocab, B=2, S=64, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S), np.int32)
    labels = rng.integers(0, vocab, (B, S), np.int32)
    labels[0, :5] = -100
    return toks, labels


@functools.lru_cache(maxsize=None)
def jax_step(pattern, dtype):
    """One step of the JAX package's ``make_train_step`` (no mesh, AdamW
    from its init) on the tempered seed-0 params: (params as numpy, its
    metrics, its AdamW ``mu`` after the step, the gradients of the loss
    it differentiates)."""
    _, jcfg = configs(pattern, dtype)
    tree = jax_numpy_params(jcfg, temper=True)
    jp = jax.tree.map(jnp.asarray, tree)
    toks, labels = lm_batch(jcfg.vocab)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    opts = JT.ModelOptions(**CHUNKS)
    step = jax.jit(jsteps.make_train_step(jcfg, None, opts,
                                          jadamw.OptConfig()))
    _, new_o, metrics = step(jp, jadamw.init(jp), batch)
    grads = jax.jit(jax.grad(lambda p: JT.loss_fn(p, jcfg, batch,
                                                  opts=opts)[0]))(jp)
    npt = functools.partial(jax.tree.map, np.asarray)
    return tree, npt(metrics), npt(new_o.mu), npt(grads)


def grad_tolerance(pattern, dtype, which, path):
    """1e-4 of the largest value in f32; in bf16 2e-2, or 1.5x the
    distance bf16 rounding alone puts between the JAX package's own bf16
    and f32 values of that leaf where larger (tests/test_torch_train.py's
    ``bf16_tolerance``)."""
    if dtype == "float32":
        return 1e-4
    i = {"mu": 2, "grads": 3}[which]
    a = dict(leaves_with_paths(jax_step(pattern, "bfloat16")[i]))[path]
    b = dict(leaves_with_paths(jax_step(pattern, "float32")[i]))[path]
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return max(2e-2, 1.5 * np.abs(a - b).max() / np.abs(b).max())


def within(t, j, frac, what):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
    assert err <= frac, f"{what}: {err:.3g} of max |ref| > {frac:.3g}"


@pytest.mark.parametrize("pattern,dtype", SERVE_CASES)
def test_train_step_loss_and_grads(pattern, dtype):
    """One donated ``make_train_step`` of the port against one of the JAX
    package's on the same tempered params and batch: the loss (1e-5
    relative in f32, 2e-2 in bf16), the gradient norm, every gradient
    leaf (``steps._value_and_grad``, under remat, through the scan's
    recompute backward) and every leaf of AdamW's first moment after the
    step (the clipped gradient x (1 - b1)) at ``grad_tolerance``."""
    cfg, _ = configs(pattern, dtype)
    tree, jm, jmu, jgrads = jax_step(pattern, dtype)
    params = params_from_jax(tree, "cpu")
    toks, labels = lm_batch(cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels)}
    opts = T.ModelOptions(**CHUNKS)
    _, _, grads = steps._value_and_grad(cfg, opts, params, batch)
    want = dict(leaves_with_paths(jgrads))
    for path, g in leaves_with_paths(grads):
        within(g, want[path], grad_tolerance(pattern, dtype, "grads", path),
               "grad " + "/".join(path))
    step = steps.make_train_step(cfg, opts, adamw.OptConfig(), donate=True)
    opt = adamw.init(params)
    _, opt, metrics = step(params, opt, batch)
    frac = 1e-5 if dtype == "float32" else 2e-2
    for key in ("loss", "grad_norm"):
        got, ref = float(metrics[key]), float(jm[key])
        assert abs(got - ref) <= frac * abs(ref), (key, got, ref)
    want = dict(leaves_with_paths(jmu))
    for path, m in leaves_with_paths(opt.mu):
        within(m, want[path], grad_tolerance(pattern, dtype, "mu", path),
               "mu " + "/".join(path))
