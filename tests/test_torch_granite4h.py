"""granite-4.0-h-small on the port, on the CPU at a reduced size, against
the benchmark's plain reference (``hpcbench/reference/granite_hybrid.py``,
plain torch in fp32, nothing of the port) on its seeded weights: prefill
logits and both kinds of cache, prefill then decode through the mixed
cache against the reference's full forward, the SSD scan at state 128
against the sequential recurrence, the kernel's launch plan at the cell's
shape, the expert share (four shares sum to the uncut layer) and the
spans and counters the benchmark reads.

The port runs in fp32 here (``dtype`` float32), so the reference and the
port differ only by the order of fp32 sums: the tolerances below are
fp32 rounding grown over ten layers, each written beside its check."""
import dataclasses

import pytest
import torch

from hpcbench.drivers.prefill_hybrid import port_config
from hpcbench.reference import granite_hybrid as ref
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import steps
from repro_torch.launch.serve import _grow_cache
from repro_torch.models import moe
from repro_torch.models import transformer as T

torch.set_num_threads(1)

# one period of the published pattern at tiny widths, 3 of 8 experts held
TINY = {"n_layers": 10, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "block_pattern": ["mamba"] * 5 + ["attn"]
        + ["mamba"] * 4, "mamba_heads": 4, "mamba_head_dim": 16,
        "mamba_groups": 1, "ssm_state": 16, "conv_width": 4, "d_ff": 32,
        "shared_ff": 48, "vocab": 256,
        "moe": {"n_experts": 8, "top_k": 2, "capacity_factor": 1.25,
                "held": 3},
        "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
        "attention_multiplier": 0.0625, "logits_scaling": 16.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
        "dtype": "float32"}
SEED = 2 ** 31 + 29
# fp32 against fp32: the port's chunked scan, fused matmuls and its
# softmax-then-top-k router sum in another order than the reference
TOL = dict(rtol=2e-4, atol=2e-4)


def model(**moe_kw) -> dict:
    return dict(TINY, moe=dict(TINY["moe"], **moe_kw))


def port_cfg(m: dict):
    """The registered configuration at the sizes of ``m``, as the
    benchmark's driver maps it."""
    return port_config(m, "granite-4.0-h-small")


def opts(chunk: int = 16):
    return T.ModelOptions(q_chunk=chunk, kv_chunk=chunk, ssm_chunk=chunk)


def tokens(B: int, S: int, seed: int = 0):
    return torch.randint(0, TINY["vocab"], (B, S),
                         generator=torch.Generator().manual_seed(seed))


def test_published_sizes_and_parameter_counts():
    """The registered configuration holds the catalog's widths; its
    counts are the source's 32B-A9B, and 11.8B with 18 experts held."""
    cfg = get_config("granite-4.0-h-small")
    assert cfg.blocks.count("mamba") == 36 and cfg.blocks[5::10] == \
        ("attn",) * 4
    assert (cfg.mamba_heads, cfg.mamba_head_dim, cfg.ssm_state,
            cfg.shared_ff, cfg.moe.n_experts, cfg.moe.top_k) == \
        (128, 64, 128, 1536, 72, 10)
    assert abs(cfg.n_params() / 32.2e9 - 1) < 0.01
    assert abs(cfg.n_active_params() / 8.8e9 - 1) < 0.01
    held = dataclasses.replace(cfg, experts_held=18)
    assert abs(held.n_params() / 11.8e9 - 1) < 0.01
    # the tree the program initialises is the reference's, leaf for leaf
    small = port_cfg(model())
    prog = T.init_params(torch.Generator().manual_seed(0), small)
    want = ref.flat(ref.make_params(TINY, 0, "cpu"))
    got = ref.flat(prog)
    assert {p: (tuple(t.shape), t.dtype) for p, t in got.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in want.items()}


def test_prefill_logits_and_both_caches_match_the_reference():
    """Logits, every attention layer's k / v and every mixer's final
    state against the reference, layer by layer, with capacity drops (the
    same token-major rule on both sides) and 3 of 8 experts held."""
    m = model()
    cfg = port_cfg(m)
    params = ref.make_params(m, SEED, "cpu")
    toks = tokens(2, 48)
    logits, cache = steps.make_prefill_step(cfg, opts())(params,
                                                         {"tokens": toks})
    seen = {}
    want = ref.prefill(params, m, toks, ref.Numerics(),
                       lambda i, kind, st: seen.setdefault(i, (kind, st)))
    torch.testing.assert_close(logits, want, **TOL)
    kinds = set()
    for i, (kind, st) in seen.items():
        c = cache[f"e{i % 10}"]
        kinds.add(kind)
        if kind == "mamba":
            torch.testing.assert_close(c["ssm"][i // 10], st, **TOL)
            assert c["conv"].shape[-2:] == (3, 4 * 16 + 2 * 16)
        else:
            torch.testing.assert_close(c["k"][i // 10], st[0], **TOL)
            torch.testing.assert_close(c["v"][i // 10], st[1], **TOL)
    assert kinds == {"mamba", "attn"}


def test_prefill_then_decode_matches_the_full_forward():
    """Prefill of 32 tokens, then 6 decode steps through the mixed cache
    (k / v of the attention layer, ssm and the conv carry over xBC of the
    mixers): each step's logits against the reference's full forward at
    that position.  The capacity admits every assignment (cf E / k) on
    both sides: a full forward's capacity differs from a prefill's and a
    decode step's otherwise."""
    m = model(capacity_factor=4.0)
    cfg = port_cfg(m)
    params = ref.make_params(m, SEED + 1, "cpu")
    S, n = 32, 6
    toks = tokens(2, S, 1)
    logits, cache = steps.make_prefill_step(cfg, opts())(params,
                                                         {"tokens": toks})
    cache = _grow_cache(cache, S + n, S)
    decode = steps.make_decode_step(cfg, opts())
    seq, outs = toks, []
    tok = logits.argmax(-1)
    for t in range(n):
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = decode(params, cache, S + t, token=tok)
        outs.append(logits)
        tok = logits.argmax(-1)
    want = ref.forward(params, m, seq, ref.Numerics(), last=n)
    torch.testing.assert_close(torch.stack(outs, 1), want, **TOL)


def test_plain_scan_at_state_128_matches_the_recurrence():
    """The plain scan (and the op's CPU path) at state 128 against the
    sequential recurrence h = exp(a) h + x B^T, y = h C, in fp32."""
    g = torch.Generator().manual_seed(3)
    B, S, nh, hd, st = 1, 40, 2, 8, 128
    xv = torch.randn(B, S, nh, hd, generator=g) * 0.5
    ld = -torch.nn.functional.softplus(torch.randn(B, S, nh, generator=g))
    Bm = torch.randn(B, S, st, generator=g) * 0.3
    Cm = torch.randn(B, S, st, generator=g) * 0.3
    h = torch.zeros(B, nh, hd, st)
    ys = []
    for t in range(S):
        h = h * ld[:, t].exp()[..., None, None] + \
            xv[:, t][..., None] * Bm[:, t][:, None, None, :]
        ys.append((h * Cm[:, t][:, None, None, :]).sum(-1))
    y_want = torch.stack(ys, 1)
    # fp32 sums of up to 40 terms of 128 products
    tol = dict(rtol=1e-5, atol=1e-5)
    for chunk in (8, 16, 40):
        y, hf = ss.ssm_scan_plain(xv, ld, Bm, Cm, chunk=chunk)
        torch.testing.assert_close(y, y_want, **tol)
        torch.testing.assert_close(hf, h, **tol)
    y, hf = ops.ssm_scan(xv, ld, Bm, Cm, None, 16)
    torch.testing.assert_close(y, y_want, **tol)
    # the reference's scan (chunked its own way) is the same function
    yr, hr = ref.ssd(xv, ld, Bm, Cm, chunk=16)
    torch.testing.assert_close(yr, y_want, **tol)
    torch.testing.assert_close(hr, h, **tol)


@pytest.mark.parametrize("chunk,want", [(64, (64, 2)), (256, (128, 1))])
def test_plan_takes_the_cell_shape(chunk, want):
    """At the cell's shape (B 2, S 16384, 128 heads of 64, state 128) the
    plan fits the H100's 232448 bytes: at chunk 64 with two heads a
    block, at 256 by halving the chunk (one head at 256 needs 279,552)."""
    p = ss.plan(2, 16384, 128, 64, 128, chunk)
    assert (p.chunk, p.heads_per_block) == want
    assert max(p.smem_state, p.smem_out) <= 232448 == ss.MAX_SMEM
    assert p.workspace == (2, -(-16384 // p.chunk), 128, 64, 128)


@pytest.mark.parametrize("shape,want", [
    # hymba's serve and train shapes and the MAMBA path's: the plans the
    # kernel launched before state 128 (chunk, heads a block, shared
    # memory of steps 1 and 3, X row strides)
    ((4, 1536, 25, 64, 16, 64), (64, 2, 28160, 55808, 72, 72)),
    ((2, 1536, 25, 64, 16, 64), (64, 2, 28160, 55808, 72, 72)),
    ((1, 256, 8, 128, 32, 256), (256, 1, 111616, 199680, 136, 136))])
def test_plans_below_state_64_are_unchanged(shape, want):
    p = ss.plan(*shape)
    assert (p.chunk, p.heads_per_block, p.smem_state, p.smem_out,
            p.ldx_state, p.ldx_out) == want


def test_four_expert_shares_sum_to_the_uncut_layer():
    """One MoE layer cut into four shares of 2 of 8 experts: the port's
    partial outputs of each share, with the shared expert counted once,
    add up to the reference's layer with every expert held (the capacity
    is the whole layer's in every share)."""
    m = model(held=8)
    g = torch.Generator().manual_seed(5)
    d, f, E = TINY["d_model"], TINY["d_ff"], 8
    p = moe.init_moe_params(g, d, f, E, torch.float32)
    sh = {k: torch.randn(s, generator=g) * 0.1 for k, s in
          (("w1", (d, 48)), ("w3", (d, 48)), ("w2", (48, d)))}
    x = torch.randn(2, 24, d, generator=g) + 0.3
    kw = dict(n_experts=E, top_k=2, capacity_factor=1.25)
    parts = []
    for first in range(0, E, 2):
        share = dict(p, **{k: p[k][first:first + 2]
                           for k in ("w1", "w3", "w2")})
        y, _ = moe.moe_ffn(share, x, experts=(first, 2), **kw)
        parts.append(y)
    shared = ref.swiglu(x, sh["w1"], sh["w3"], sh["w2"], ref.Numerics())
    want = ref.moe(p, x, m, ref.Numerics()) + shared
    torch.testing.assert_close(sum(parts) + shared, want, **TOL)
    # a share drops assignments: the capacity is from all 48 x 2
    whole, _ = moe.moe_ffn(p, x, **kw)
    torch.testing.assert_close(sum(parts), whole, **TOL)


def test_spans_and_counters_under_the_profiler():
    """Recorded, a prefill opens ``rt.mamba`` once a mixer and
    ``rt.shared`` once a layer, and the MoE counts this device's
    assignments (``routed``) beside every assignment (``routed_all``);
    unrecorded it opens and counts nothing."""
    from torch.profiler import ProfilerActivity, profile
    m = model()
    cfg = port_cfg(m)
    params = ref.make_params(m, SEED, "cpu")
    step = steps.make_prefill_step(cfg, opts())
    toks = tokens(2, 32, 2)
    moe.reset_dispatch_counts()
    step(params, {"tokens": toks})
    assert moe.dispatch_counts()["routed_all"] == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, {"tokens": toks})
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["rt.mamba"] == 9 and counts["rt.shared"] == 10
    assert counts["rt.attn"] == 1 and counts["rt.moe"] == 10
    c = moe.dispatch_counts()
    assert c["routed_all"] == 10 * 64 * 2
    assert 0 < c["routed"] < c["routed_all"]
    moe.reset_dispatch_counts()
