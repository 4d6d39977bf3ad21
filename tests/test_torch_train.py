"""The port's training slice against the JAX package, on the CPU, on the
same numpy inputs and the same JAX-initialised weights: the gradients of
the two kernel wrappers (against the Pallas kernels' custom VJPs in
interpret mode, as tests/test_kernels.py runs them), ``loss_fn`` and its
gradients for reduced qwen2 and hymba, and ``train()`` itself.

On the CPU the wrappers run their plain versions through the custom ops
and their registered backward; on the card the forward is the Hopper
kernel (chip_smoke.py holds its gradients there)."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.launch.train import train as jax_train
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core import export
from repro_torch.core.aggregate import aggregate
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.train import register_train_step, to_device, train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves_with_paths

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)


def within(t, j, frac, what=""):
    """max |t - j| within ``frac`` of max |j|."""
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j, np.float32)
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
    assert err <= frac, f"{what}: max abs error {err:.3g} of max |ref|"


def draws(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s)).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# kernel gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,Hkv,D,bq,bk,window", [
    # tests/test_kernels.py:26-31, at its block sizes
    (1, 128, 4, 4, 64, 64, 64, 0),
    (2, 256, 8, 2, 64, 128, 128, 0),
    (1, 256, 8, 1, 32, 64, 128, 0),
    (1, 512, 2, 2, 128, 256, 256, 0),
    # windowed (tests/test_kernels.py:46-57)
    (1, 256, 4, 4, 32, 64, 64, 64),
    (1, 256, 4, 4, 32, 64, 64, 128),
    # ragged: S on no power of two, one block of S, a window
    (2, 100, 4, 2, 32, 256, 256, 0),
    (1, 100, 4, 1, 32, 256, 256, 24),
])
def test_flash_attention_grad_vs_pallas_vjp(B, S, H, Hkv, D, bq, bk, window):
    """dq/dk/dv of the port's wrapper (its registered recompute backward)
    against jax.vjp of the Pallas kernel's custom VJP, f32 to 1e-4 of
    each gradient's largest value."""
    q, k, v, do = draws(0, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D),
                            (B, S, H, D)])
    out, vjp = jax.vjp(lambda *a: jops.flash_attention(
        *a, True, window, bq, bk), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    ops.flash_attention.launches = 0
    got_out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(do))
    within(got_out, out, 1e-4, "out")
    for g, w, n in zip(got, want, "qkv"):
        within(g, w, 1e-4, f"d{n}")
    assert ops.flash_attention.launches == 0      # the CPU runs no kernel


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,nh,hd,st,chunk", [
    (1, 128, 2, 16, 16, 64),         # tests/test_kernels.py:93-97
    (2, 256, 4, 32, 16, 128),
    (1, 256, 1, 64, 32, 256),
    (1, 96, 2, 8, 8, 64),            # ragged: the chunk is cut to 48
])
def test_ssm_scan_grad_vs_pallas_vjp(B, S, nh, hd, st, chunk, with_h0):
    """dxv/dlogdecay/dB/dC(/dh0) of the port's wrapper against jax.vjp of
    the Pallas kernel's custom VJP, with cotangents on both outputs, f32
    to 1e-4 of each gradient's largest value.  Without h0 the scan starts
    from zeros and h0 gets no gradient, as in the reference."""
    rng = np.random.default_rng(1)
    xv = (rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32)
    ld = (-np.logaddexp(0.0, rng.standard_normal((B, S, nh)))
          ).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, st)) * 0.3).astype(np.float32)
              for _ in range(2))
    h0 = (rng.standard_normal((B, nh, hd, st)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dh = rng.standard_normal((B, nh, hd, st)).astype(np.float32)
    ins = [xv, ld, Bm, Cm] + ([h0] if with_h0 else [])
    if S % chunk:
        chunk = max(c for c in range(1, chunk + 1) if S % c == 0)

    def jfn(*a):
        return jops.ssm_scan(*a[:4], a[4] if with_h0 else None, chunk)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, h = ops.ssm_scan(*tins[:4], tins[4] if with_h0 else None, chunk)
    got = torch.autograd.grad((y, h), tins,
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    for g, w, n in zip(got, want, ["xv", "logdecay", "B", "C", "h0"]):
        within(g, w, 1e-4, f"d{n}")


def test_ssm_scan_grad_of_y_alone():
    """A loss on y alone (h_final unused, as in training) gives the same
    gradients as a zero cotangent on h_final."""
    xv, ld, Bm, Cm = draws(2, [(1, 64, 2, 8), (1, 64, 2), (1, 64, 8),
                               (1, 64, 8)])
    ld = -np.abs(ld)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (xv, ld, Bm, Cm)]
    y, h = ops.ssm_scan(*a, None, 32)
    g1 = torch.autograd.grad(y.square().sum(), a)
    y, h = ops.ssm_scan(*a, None, 32)
    g2 = torch.autograd.grad((y.square().sum(), h.sum() * 0), a)
    for x, z in zip(g1, g2):
        torch.testing.assert_close(x, z)


def test_flash_decode_stays_inference_only_on_cpu_grad():
    """On the CPU a decode input that requires grad runs the plain version
    (differentiable); the CUDA branch raises (see ops.flash_decode)."""
    q, kc = draws(3, [(1, 2, 16), (1, 32, 1, 16)])
    tq = torch.from_numpy(q).requires_grad_(True)
    out = ops.flash_decode(tq, torch.from_numpy(kc), torch.from_numpy(kc),
                           20)
    out.sum().backward()
    assert tq.grad is not None and ops.flash_decode.launches == 0


@pytest.mark.parametrize("route", ["attention", "scan", "decode-grad"])
def test_no_option_takes_the_card_off_the_kernels(route, monkeypatch):
    """On CUDA tensors the plain routes raise: training attention and the
    mamba scan with ``use_kernel=False`` (``ModelOptions.
    use_flash_kernel``; the plain schedules are for the CPU), and
    ``flash_decode`` on an input that requires grad (inference-only).
    The tensors are fake ones on the card (``FakeTensorMode``), which
    need no card (the rope table, a constant made on the card, is left
    out: the projections hand over fake q, k, v); the kernel route of the
    same call traces through the custom op's fake implementation and
    counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm
    from repro_torch.tree import tree_map
    cfg, _ = configs("qwen2-1.5b", "float32")
    layer = tree_map(lambda t: t[0], T.init_params(
        torch.Generator().manual_seed(0), cfg)["layers"]["e0"]["attn"])
    with FakeTensorMode():
        def card(shape, **kw):
            return torch.empty(shape, device="cuda", **kw)
        if route == "attention":
            x = card((2, 32, cfg.d_model))
            ap = tree_map(lambda t: card(t.shape), layer)
            pos = card((2, 32), dtype=torch.long)
            qkv = (card((2, 32, cfg.n_heads, cfg.head_dim)),
                   *(card((2, 32, cfg.n_kv_heads, cfg.head_dim))
                     for _ in range(2)))
            monkeypatch.setattr(attn, "project_qkv", lambda *a: qkv)
            y, _ = attn.attention_block(ap, x, pos, cfg, use_kernel=True)
            assert y.is_cuda and y.shape == x.shape
            with pytest.raises(ValueError, match="attention_block"):
                attn.attention_block(ap, x, pos, cfg, use_kernel=False)
        elif route == "scan":
            xv, ld, bc = (card(s) for s in ((2, 64, 4, 8), (2, 64, 4),
                                             (2, 64, 8)))
            y, h = ssm.ssd_chunked(xv, ld, bc, bc, chunk=16)
            assert y.is_cuda and h.shape == (2, 4, 8, 8)
            with pytest.raises(ValueError, match="ssd_chunked"):
                ssm.ssd_chunked(xv, ld, bc, bc, chunk=16, use_kernel=False)
        else:
            q = card((1, 2, 16), requires_grad=True)
            kc = card((1, 32, 1, 16))
            with pytest.raises(NotImplementedError, match="inference-only"):
                ops.flash_decode(q, kc, kc, 20)
    assert ops.flash_attention.launches == ops.ssm_scan.launches == 0


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
MODELS = ("qwen2-1.5b", "hymba-1.5b")
CHUNKS = dict(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
VARIANTS = {   # the port's options; the JAX side runs its plain path
    "kernel-remat": dict(),
    "kernel-no-remat": dict(remat=False),
    "plain-remat": dict(use_flash_kernel=False),
    "plain-binary": dict(use_flash_kernel=False, attn_schedule="binary"),
    "kernel-remat-nothing": dict(remat_policy="nothing"),
}


def configs(name, dtype):
    return (dataclasses.replace(get_config(name).reduced(), dtype=dtype),
            dataclasses.replace(jax_get_config(name).reduced(), dtype=dtype))


def lm_batch(vocab, B=2, S=64, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S), np.int32)
    labels = rng.integers(0, vocab, (B, S), np.int32)
    labels[0, :5] = -100                         # masked positions
    return toks, labels


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(name, dtype):
    """The JAX package's loss, metrics and gradients on reduced ``name``
    (its plain path, dense schedule), with its params as numpy.

    wq and wk are scaled by 1/8, as chip_smoke's CPU check does: the seeded
    init takes their fan-in from the head axis, which makes the softmax
    near one-hot, and there bf16 rounding alone moves the JAX package's
    own gradients 17-77% of their largest value away from its f32 ones;
    tempered, 1-3% (beta aside, see ``bf16_tolerance``)."""
    _, jcfg = configs(name, dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    for e in jp["layers"].values():
        for w in ("wq", "wk"):
            e["attn"][w] = (e["attn"][w].astype(jnp.float32) / 8).astype(
                e["attn"][w].dtype)
    toks, labels = lm_batch(jcfg.vocab)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)},
                             opts=JT.ModelOptions(**CHUNKS)),
        has_aux=True)(jp)
    np_tree = functools.partial(jax.tree.map, np.asarray)
    return (float(loss), np_tree(metrics), np_tree(grads), np_tree(jp))


def bf16_tolerance(name, path):
    """A bf16 gradient leaf's tolerance: 2e-2 of its largest value, or 1.5x
    the distance bf16 rounding alone puts between the JAX package's own
    bf16 and f32 gradients of that leaf where that is larger.  It is for
    hymba's ``beta`` (fp32 leaves whose gradient is a sum over every
    element of the two mixer outputs, which cancels: the JAX package's
    bf16 gradient is 20% of its largest value from its f32 one, since XLA
    fuses the product and the sum in f32 where PyTorch rounds the product
    to bf16 first) and the mamba ``wdt`` (2.8%)."""
    g16 = dict(leaves_with_paths(jax_loss_and_grads(name, "bfloat16")[2]))
    g32 = dict(leaves_with_paths(jax_loss_and_grads(name, "float32")[2]))
    a, b = (np.asarray(g[path], np.float32) for g in (g16, g32))
    return max(2e-2, 1.5 * np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_loss_fn_and_grads_vs_jax(name, dtype, variant):
    """f32: the loss within 1e-5 relative, every gradient leaf within 1e-4
    of its largest value.  bf16: the loss within 2e-2 relative, every
    gradient leaf at ``bf16_tolerance`` (XLA fuses bf16 elementwise chains
    in f32 and rounds once, PyTorch rounds after every op).  The port's
    remat (selective checkpoint), kernel routing and binary schedule
    change nothing but the rounding."""
    cfg, _ = configs(name, dtype)
    jloss, jmetrics, jgrads, jp = jax_loss_and_grads(name, dtype)
    params = params_from_jax(jp, "cpu")
    toks, labels = lm_batch(cfg.vocab)
    opts = T.ModelOptions(**CHUNKS, **VARIANTS[variant])
    loss, metrics, grads = steps._value_and_grad(
        cfg, opts, params, {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels)})
    frac = 1e-5 if dtype == "float32" else 2e-2
    assert abs(float(loss) - jloss) <= frac * abs(jloss), (float(loss), jloss)
    assert float(metrics["ntok"]) == float(jmetrics["ntok"]) == 2 * 64 - 5
    want = dict(leaves_with_paths(jgrads))
    for path, g in leaves_with_paths(grads):
        within(g, want[path], 1e-4 if dtype == "float32"
               else bf16_tolerance(name, path), "/".join(path))


def test_remat_recomputes_only_the_kernels_and_non_dots():
    """With remat, the kernels run again in the backward (the recompute);
    without it, once.  Counted through the custom op's CPU
    implementation."""
    cfg, _ = configs("hymba-1.5b", "float32")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks, labels = lm_batch(cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels)}
    calls = {"flash": 0, "ssm": 0}
    fa_plain = ops._fa.flash_attention_plain
    ss_plain = ops._ss.ssm_scan_plain

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    ops._fa.flash_attention_plain = count("flash", fa_plain)
    ops._ss.ssm_scan_plain = count("ssm", ss_plain)
    try:
        for remat, want in ((True, 2), (False, 1)):
            calls.update(flash=0, ssm=0)
            steps._value_and_grad(cfg, T.ModelOptions(**CHUNKS, remat=remat),
                                  params, batch)
            # + one plain scan per layer in the scan's own backward
            assert calls["flash"] == want * cfg.n_layers, (remat, calls)
            assert calls["ssm"] == (want + 1) * cfg.n_layers, (remat, calls)
    finally:
        ops._fa.flash_attention_plain = fa_plain
        ops._ss.ssm_scan_plain = ss_plain


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------
SEQ, BATCH = 64, 4


def jax_train_losses(jcfg, n_steps, **kw):
    _, hist, _ = jax_train(jcfg, JShapeConfig("t", SEQ, BATCH, "train"),
                           n_steps=n_steps, log_every=1,
                           opts=JT.ModelOptions(**CHUNKS), **kw)
    return [h["loss"] for h in hist]


@functools.lru_cache(maxsize=None)
def qwen2_reduced():
    jcfg = jax_get_config("qwen2-1.5b").reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return get_config("qwen2-1.5b").reduced(), jcfg, jax.tree.map(
        np.asarray, jp)


@pytest.mark.parametrize("grad_compression", [False, True])
def test_train_matches_jax_train(grad_compression):
    """3 steps of ``train()`` on reduced qwen2 from the JAX package's
    seed-0 weights (the JAX ``train``'s own init) and the same synthetic
    batches: every loss within 1e-5 relative (f32), with and without the
    int8 gradient wire model."""
    cfg, jcfg, jp = qwen2_reduced()
    want = jax_train_losses(jcfg, 3, grad_compression=grad_compression)
    _, hist, paths = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                           n_steps=3, log_every=1,
                           opts=T.ModelOptions(**CHUNKS),
                           grad_compression=grad_compression, device="cpu",
                           params=params_from_jax(jp, "cpu"))
    got = [h["loss"] for h in hist]
    assert paths is None and [h["step"] for h in hist] == [0, 1, 2]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def unsettled(jmu_before, jmu_after, b1):
    """Per leaf, the elements whose JAX gradient at a step (recovered from
    the step's moments: g = (mu_after - b1 mu_before) / (1 - b1), after
    clipping) is below 1e-4 of the leaf's largest.  The gradients of the
    two packages agree to 1e-4 of each leaf's largest value
    (``test_loss_fn_and_grads_vs_jax``), which leaves the sign of such an
    element to rounding (the zero-initialised biases' elements are of
    this kind), and AdamW moves an element by about lr x sign(g) whatever
    the gradient's size, so there the two packages' steps can point
    opposite ways."""
    out = {}
    for path, after in leaves_with_paths(jmu_after):
        before = dict(leaves_with_paths(jmu_before))[path]
        g = np.abs((np.asarray(after) - b1 * np.asarray(before)) / (1 - b1))
        out[path] = g < 1e-4 * g.max()
    return out


def close_state(tparams, tstate, jparams, jstate, unsettled_at, lr_sum):
    """The port's params and AdamW state after some steps against the JAX
    package's.  The moments, which are linear (mu) and quadratic (nu) in
    the gradients and have no sign ambiguity, within 1e-4 of each leaf's
    largest value: that catches a gradient from the wrong microbatches, a
    skipped or a doubled accumulation.  The params within 1e-6 relative
    plus 1e-2 of the summed learning rates (measured: at most 2e-3), which
    catches a skipped or a reversed update (each moves most elements by a
    large fraction of lr); only the elements that ``unsettled`` marks at
    some step get 2 x the summed learning rates."""
    want_p = dict(leaves_with_paths(jax.tree.map(np.asarray, jparams)))
    for name, t, j in (("mu", tstate.mu, jstate.mu),
                       ("nu", tstate.nu, jstate.nu)):
        want = dict(leaves_with_paths(jax.tree.map(np.asarray, j)))
        for path, x in leaves_with_paths(t):
            within(x, want[path], 1e-4, f"{name} " + "/".join(path))
    for path, t in leaves_with_paths(tparams):
        got, want = t.float().numpy(), want_p[path]
        loose = np.zeros(want.shape, bool)
        for marks in unsettled_at:
            loose |= marks[path]
        atol = np.where(loose, 2 * lr_sum, 1e-2 * lr_sum)
        bad = np.abs(got - want) > 1e-6 * np.abs(want) + atol
        assert not bad.any(), (f"{'/'.join(path)}: {int(bad.sum())} "
                               f"elements off, {int(loose.sum())} of "
                               f"{loose.size} unsettled")


def test_train_two_microbatches_matches_jax_step():
    """``n_microbatches=2`` (fp32 accumulation) against the JAX package's
    ``make_train_step(..., n_microbatches=2)`` over the same 3 batches,
    step by step: losses within 1e-5 relative, the AdamW moments and the
    params at ``close_state``.  ``train(n_microbatches=2)`` gives the same
    losses and bitwise the same params (the CPU is deterministic)."""
    cfg, jcfg, jp = qwen2_reduced()
    opt_cfg = jadamw.OptConfig(total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, None,
                                           JT.ModelOptions(**CHUNKS),
                                           opt_cfg, n_microbatches=2))
    tstep = steps.make_train_step(cfg, T.ModelOptions(**CHUNKS),
                                  adamw.OptConfig(total_steps=3),
                                  n_microbatches=2)
    ds = JSyntheticLM(jcfg, JShapeConfig("t", SEQ, BATCH, "train"))
    p, o = jax.tree.map(jnp.asarray, jp), jadamw.init(jp)
    tp = params_from_jax(jp, "cpu")
    to = adamw.init(tp)
    losses, marks, lr_sum = [], [], 0.0
    for s in range(3):
        b = ds.batch_at(s)
        p, o_new, m = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, to_device(b, "cpu"))
        marks.append(unsettled(o.mu, o_new.mu, opt_cfg.b1))
        o, lr_sum = o_new, lr_sum + float(m["lr"])
        assert abs(float(tm["loss"]) - float(m["loss"])) <= \
            1e-5 * abs(float(m["loss"])), (s, float(tm["loss"]), m["loss"])
        close_state(tp, to, p, o, marks, lr_sum)
        losses.append(float(tm["loss"]))
    params, hist, _ = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                            n_steps=3, log_every=1, n_microbatches=2,
                            opts=T.ModelOptions(**CHUNKS),
                            opt_cfg=adamw.OptConfig(total_steps=3),
                            device="cpu", params=params_from_jax(jp, "cpu"))
    assert [h["loss"] for h in hist] == losses
    for (path, a), (_, b) in zip(leaves_with_paths(params),
                                 leaves_with_paths(tp)):
        assert torch.equal(a, b), path


def test_resumed_opt_state_matches_jax():
    """One JAX step, then its params and AdamW state carried across
    (``params_from_jax``, ``opt_state_from_jax``): the port's next step
    gives the JAX package's next loss, moments and params
    (``close_state``)."""
    cfg, jcfg, jp = qwen2_reduced()
    opt_cfg = jadamw.OptConfig(total_steps=4, warmup_steps=1)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, None, JT.ModelOptions(**CHUNKS), opt_cfg))
    ds = JSyntheticLM(jcfg, JShapeConfig("t", SEQ, BATCH, "train"))
    p, o, _ = jstep(jax.tree.map(jnp.asarray, jp), jadamw.init(jp),
                    {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()})
    b1 = ds.batch_at(1)
    p2, o2, m2 = jstep(p, o, {k: jnp.asarray(v) for k, v in b1.items()})
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, o), "cpu")
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 1
    tstep = steps.make_train_step(cfg, T.ModelOptions(**CHUNKS),
                                  adamw.OptConfig(total_steps=4,
                                                  warmup_steps=1))
    tp, to, tm = tstep(params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                       tstate, to_device(b1, "cpu"))
    assert abs(float(tm["loss"]) - float(m2["loss"])) <= \
        1e-5 * abs(float(m2["loss"]))
    close_state(tp, to, p2, o2, [unsettled(o.mu, o2.mu, opt_cfg.b1)],
                float(m2["lr"]))
    assert int(to.step) == 2 and float(tm["lr"]) == pytest.approx(
        float(m2["lr"]), rel=1e-6)


def test_train_resume_from_checkpoint_is_exact(tmp_path):
    """4 steps with a checkpoint every 2 (async), then a resume from step
    2 of the same run: steps 2 and 3 give bitwise the same losses (the CPU
    is deterministic; on the card chip_smoke checks the first resumed
    step)."""
    cfg, _, jp = qwen2_reduced()
    kw = dict(n_steps=4, log_every=1, opts=T.ModelOptions(**CHUNKS),
              device="cpu", ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    _, full, _ = train(cfg, shape, params=params_from_jax(jp, "cpu"), **kw)
    # a fresh init: the resume must overwrite every leaf
    (tmp_path / "ck" / "step_00000004").rename(tmp_path / "later")
    _, resumed, _ = train(cfg, shape, resume=True, **kw)
    assert [h["step"] for h in resumed] == [2, 3]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in full[2:]]


def test_training_path_imports_with_jax_blocked():
    """Importing the training path loads no jax (blocked outright) and no
    module of the JAX package."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.checkpoint, repro_torch.distributed.compression, "
            "repro_torch.data.pipeline, repro_torch.convert, "
            "repro_torch.core.export\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    res = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_needs_cuda_by_default():
    """No silent CPU fallback: without CUDA, the default device raises
    before any work."""
    cfg, _, _ = qwen2_reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(cfg, ShapeConfig("t", SEQ, BATCH, "train"), n_steps=1)
    import inspect
    assert inspect.signature(train).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# the train step's structure under the profiler
# ---------------------------------------------------------------------------
def test_train_under_profiler_registers_the_step(tmp_path):
    """``train(profile_dir=...)`` writes the profiles and a measurement
    JSON; the registered train step holds one custom-call per forward
    launch (2 layers x (forward + remat recompute)), each bound to the
    flash kernel's interior; the aggregated database has the train_step
    placeholder with PC samples, some inside the kernel's interior."""
    cfg, _, jp = qwen2_reduced()
    prof_dir = str(tmp_path / "prof")
    _, hist, paths = train(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                           n_steps=2, log_every=1, profile_dir=prof_dir,
                           opts=T.ModelOptions(**CHUNKS), device="cpu",
                           params=params_from_jax(jp, "cpu"))
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(os.path.getsize(p) > 0 for p in paths.values())
    with open(paths["measurement"]) as f:
        step = json.load(f)["steps"]["train_step"]
    assert step["custom_calls"] == 2 * cfg.n_layers
    assert step["ops"] > 500 and step["flops"] > 0 and step["seconds"] > 0
    profiles = sorted(v for k, v in paths.items()
                      if k.startswith(("cpu_", "gpu_")) and "trace" not in k)
    db = aggregate(profiles, str(tmp_path / "db"))
    col = db.stats["sum"][:, db.metric_id("gpu_inst/samples")]
    ph = [g for g, fr in enumerate(db.frames)
          if fr.kind == "placeholder" and fr.name == "kernel:train_step"]
    assert ph and sum(col[g] for g in ph) > 0
    assert any(fr.module.endswith("flash_attention.cu") and col[g] > 0
               for g, fr in enumerate(db.frames) if fr.kind == "gpu_op")


@pytest.mark.parametrize("remat,policy,per_layer", [
    (True, "dots_no_batch", 2), (True, "nothing", 2),
    (True, "everything", 1), (False, "dots_no_batch", 1)])
def test_traced_step_has_a_node_per_launch(remat, policy, per_layer):
    """The traced train step (make_fx on fake tensors) has one custom-call
    per forward launch of each kernel, recompute included, on hymba
    (flash and SSD scan); tracing runs nothing and counts no launch."""
    cfg, _ = configs("hymba-1.5b", "float32")
    opts = T.ModelOptions(**CHUNKS, remat=remat, remat_policy=policy)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks, labels = lm_batch(cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels)}
    fn = steps.make_train_step(cfg, opts, adamw.OptConfig())
    module = export.module_from_graph("train_step", export.trace_train_step(
        fn, (params, adamw.init(params), batch)))
    calls = [op for op in module.all_ops() if op.opcode == "custom-call"]
    kinds = sorted(op.op_name.rsplit("/", 1)[-1] for op in calls)
    want = per_layer * cfg.n_layers
    assert kinds == ["flash_attention"] * want + ["ssm_scan"] * want
    assert ops.flash_attention.launches == ops.ssm_scan.launches == 0


def test_register_train_step_binds_both_kernels():
    cfg, _ = configs("hymba-1.5b", "float32")
    opts = T.ModelOptions(**CHUNKS)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks, labels = lm_batch(cfg.vocab)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels)}

    class Prof:
        def register_structure(self, name, module, cost):
            self.got = (name, module, cost)
            return 7
    prof = Prof()
    mid, info = register_train_step(
        prof, cfg, opts, steps.make_train_step(cfg, opts, adamw.OptConfig()),
        params, adamw.init(params), batch)
    name, module, cost = prof.got
    assert mid == 7 and name == "train_step"
    assert info["custom_calls"] == 4 * cfg.n_layers
    assert {ks.name for ks in module.kernel_structures().values()} == {
        "flash_attention", "ssm_scan"}
    assert cost["flops"] > 0 and info["ops"] == len(module.all_ops())
