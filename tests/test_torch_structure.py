"""The port's program structure (``core.export``: a ``torch.export`` graph
of each serving step as an ``HloModule``) and its kernel interiors
(``core.kstruct``: recovered from the CUDA source), against the JAX
package's HLO structure and the kstruct contract of
``tests/test_kstruct.py``, at reduced size on the CPU."""
import os
import re
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.structure import parse_hlo
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import HYBRID
from repro_torch.core import export, sampling
from repro_torch.core.cct import GPU_FUNC, GPU_LOOP, GPU_OP
from repro_torch.core.kstruct import KernelStructure
from repro_torch.kernels import CSRC, kernel_structures, ops
from repro_torch.kernels import decode_attention as fd
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.models import transformer as T

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, GEN = 2, 32, 4
OPTS = T.ModelOptions(q_chunk=16, kv_chunk=16, ssm_chunk=16)
MODELS = ("qwen2-1.5b", "hymba-1.5b")


def chip_smoke():
    """The chip script, imported for its SASS line-table reader (its top
    level only defines)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    return cs


@pytest.fixture(scope="module")
def modules():
    """{(model, step): (cfg, HloModule)} of the reduced models' steps."""
    out = {}
    for name in MODELS:
        cfg = get_config(name).reduced()
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.init_params(gen, cfg)
        prefill = steps.make_prefill_step(cfg, OPTS)
        decode = steps.make_decode_step(cfg, OPTS)
        batch = {"tokens": torch.zeros((B, S), dtype=torch.long)}
        out[name, "prefill"] = cfg, export.module_from_export(
            "prefill", export.export_step(prefill, (params, batch)))
        logits, cache = prefill(params, batch)
        cache = serve_mod._grow_cache(cache, S + GEN, S)
        out[name, "decode_step"] = cfg, export.module_from_export(
            "decode_step", export.export_step(
                decode, (params, cache, S), {"token": logits.argmax(-1)}))
    return out


def analytic_dot_flops(cfg, step: str) -> float:
    """Every matmul of a step: the projections, the FFN, the mamba
    mixer's projections and the last position's unembedding (attention
    and the SSD scan are custom-calls, not dots); decode adds the
    recurrent mamba step's readout h C (its state update is an outer
    product, elementwise)."""
    d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    tokens = B * (S if step == "prefill" else 1)
    per_tok = 2 * d * h * dh + 2 * 2 * d * hkv * dh + 2 * h * dh * d \
        + 3 * 2 * d * f
    hybrid = sum(k == HYBRID for k in cfg.blocks)
    inner, st = h * dh, cfg.ssm_state
    mamba = 2 * d * 2 * inner + 2 * inner * 2 * st + 2 * inner * h \
        + 2 * inner * d
    total = tokens * (cfg.n_layers * per_tok + hybrid * mamba)
    if step == "decode_step":
        total += hybrid * 2 * B * inner * st
    return total + B * 2 * d * cfg.vocab


def dot_flops(module) -> float:
    return sum(op.flops for op in module.all_ops() if op.opcode == "dot")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("step", ["prefill", "decode_step"])
def test_export_structure(modules, name, step):
    cfg, mod = modules[name, step]
    ops_ = mod.all_ops()
    assert [op.index for op in ops_] == list(range(len(ops_)))
    calls = [op for op in ops_ if op.opcode == "custom-call"]
    kernel = "flash_attention" if step == "prefill" else "decode_attention"
    hybrid = sum(k == HYBRID for k in cfg.blocks)
    assert sum(kernel in op.op_name for op in calls) == cfg.n_layers
    assert sum("ssm_scan" in op.op_name for op in calls) == \
        (hybrid if step == "prefill" else 0)
    assert len(calls) == cfg.n_layers + (hybrid if step == "prefill" else 0)
    assert all(op.flops == 0 for op in calls)
    # every other op has an opcode of the shared vocabulary, none unmapped
    assert all(op.opcode in export.HLO_VOCABULARY for op in ops_)
    assert not [op.attrs for op in ops_ if "unmapped" in op.attrs]
    assert {"parameter", "dot", "tuple"} <= {op.opcode for op in ops_}
    # the scope chains of the model functions, with frames and lines
    scopes = set()
    for op in ops_:
        scopes |= {f.name for f in mod.op_context(op) if f.kind == GPU_FUNC}
    assert {"rms_norm", "swiglu", "apply_rope"} <= scopes
    qkv = [op for op in ops_ if "/project_qkv/" in op.op_name]
    assert qkv and all(op.op_name.startswith(f"{step}/") for op in qkv)
    fr = mod.frames[qkv[0].frame_id]
    assert fr.file.endswith(os.path.join("repro_torch", "models",
                                         "attention.py")) and fr.line > 0
    assert fr.parent and mod.frames[fr.parent].function
    # the loop is unrolled: one computation, multiplier 1
    assert list(mod.computations) == ["main"]
    assert set(mod.comp_multipliers().values()) == {1.0}
    # the matmul FLOPs are the config's
    want = analytic_dot_flops(cfg, step)
    assert abs(dot_flops(mod) - want) <= 0.01 * want


# the JAX package's scopes of the functions that the port's kernels compute
_KERNEL_SCOPES = re.compile(r"attention_core|swa_attention|attn_binary|"
                            r"decode_attention|ssd_intra|ssd_state|ssd_inter")


@pytest.mark.parametrize("name", MODELS)
def test_prefill_dots_match_the_jax_structure(modules, name):
    """The projection, FFN and unembedding dots of the JAX package's own
    prefill_step, parsed from its compiled HLO, carry the FLOPs of the
    port's exported prefill within 2%.  Attention and the SSD scan are
    left out: the JAX prefill computes them with jnp chunked code."""
    cfg, mod = modules[name, "prefill"]
    jcfg = jax_get_config(name).reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    fn = jsteps.make_prefill_step(jcfg, None, JT.ModelOptions(
        q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=16))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    hlo = parse_hlo(jax.jit(fn).lower(jp, batch).compile().as_text())
    mults = hlo.comp_multipliers()
    ref = sum(op.flops * mults.get(op.comp, 1.0) for op in hlo.all_ops()
              if op.opcode == "dot" and not _KERNEL_SCOPES.search(op.op_name))
    got = dot_flops(mod)
    assert ref > 0 and abs(got - ref) <= 0.02 * ref, (got, ref)


def test_kernels_are_one_opaque_node_and_tracing_counts_no_launch():
    q = torch.randn(1, 32, 4, 16)
    k = torch.randn(1, 32, 2, 16)
    ops.flash_attention.launches = 0
    ep = torch.export.export(export._Step(lambda q, k, v: ops.flash_attention(
        q, k, v, window=8)), (q, k, k), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("repro_torch.flash_attention.default") == 1
    assert ops.flash_attention.launches == 0
    torch.testing.assert_close(ep.module()(q, k, k),
                               fa.flash_attention_plain(q, k, k, window=8))
    assert ops.flash_attention.launches == 0      # the CPU runs the plain


# ---------------------------------------------------------------------------
# kernel interiors from the CUDA source
# ---------------------------------------------------------------------------
# a leaf's primitive and what its source line must say
_LINE_HOLDS = {"dot_general": r"wgmma|mma", "exp2": r"\bex2\b|exp2f",
               "exp": r"expf", "load": r"cp_async|tma_load|kstruct: load",
               "store": r"kstruct: store", "reduce_max": r"_max\(",
               "reduce_sum": r"_sum\(", "max": r"fmaxf",
               "convert_element_type": r"bf16|bfloat16"}
# (kernel, its shapes, the chip script's bound of the same call)
SHAPES = {
    "flash_attention": dict(B=4, S=512, H=12, Hkv=2, D=128, window=0),
    "decode_attention": dict(B=4, H=12, Hkv=2, D=128, length=528),
    "ssm_scan": dict(B=4, S=1536, nh=25, hd=64, st=16, chunk=64)}
WORK = {"flash_attention": fa.work, "decode_attention": fd.work,
        "ssm_scan": ss.work}


def recover(kernel, **over):
    sh = dict(SHAPES[kernel], **over)
    flops, nbytes = WORK[kernel](**sh)
    return KernelStructure.from_cuda_source(
        os.path.join(CSRC, f"{kernel}.cu"), kernel,
        dict(sh, flops=flops, bytes=nbytes))


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_kernel_interior_contract(kernel):
    ks = recover(kernel)
    assert ks.name == kernel and ks.file == f"{kernel}.cu"
    assert len(ks.leaves) >= 10 and ks.active_s > 0
    kinds = {f.kind for lf in ks.leaves for f in lf.frames}
    assert kinds == {GPU_LOOP, GPU_FUNC, GPU_OP}
    # the root is the __global__ function's line
    with open(os.path.join(CSRC, ks.file)) as f:
        lines = f.read().splitlines()
    assert "__global__" in lines[ks.line - 1]
    grid = {"flash_attention": "grid:kv_blocks",
            "decode_attention": "grid:kv_blocks",
            "ssm_scan": "grid:chunks"}[kernel]
    looped = [lf for lf in ks.leaves
              if any(f.kind == GPU_LOOP for f in lf.frames)]
    assert looped
    for lf in looped:
        loops = [f for f in lf.frames if f.kind == GPU_LOOP]
        assert loops[0].name == grid
        # outermost: nothing but the step's own function above it
        above = lf.frames[:lf.frames.index(loops[0])]
        assert all(f.kind == GPU_FUNC and f.name.endswith("_kernel")
                   for f in above)
    dots = [lf for lf in ks.leaves if lf.frames[-1].name == "dot_general"]
    assert len(dots) >= (4 if kernel == "ssm_scan" else 2)
    assert all(lf.stall == "compute" and lf.flops > 0 for lf in dots)
    # a run of products on consecutive lines is one leaf at its first
    lines = {(lf.frames[:-1], lf.line) for lf in dots}
    assert not [k for k in lines if (k[0], k[1] + 1) in lines]
    if kernel != "ssm_scan":     # the products walk the kv tiles
        assert all(lf.frames[0].name == grid for lf in dots)
    else:                        # the state pass walks the chunks
        passes = [lf for lf in looped
                  if lf.frames[0].name == "ssd_state_pass_kernel"]
        assert passes and {lf.frames[-1].name for lf in passes} >= {
            "load", "store"}
    # every leaf's line is a line of its file that holds the op
    texts = {}
    for lf in ks.leaves:
        op = lf.frames[-1]
        if op.module not in texts:
            with open(os.path.join(CSRC, op.module)) as f:
                texts[op.module] = f.read().splitlines()
        assert 0 < op.line <= len(texts[op.module])
        assert re.search(_LINE_HOLDS[op.name], texts[op.module][op.line - 1]), \
            (op, texts[op.module][op.line - 1])
    # the totals are the function's own, as the chip script bounds it
    # (chip_smoke.time_kernels takes its bound from the same work())
    flops, nbytes = WORK[kernel](**SHAPES[kernel])
    assert ks.total_flops == pytest.approx(flops, rel=1e-12)
    assert ks.total_bytes == pytest.approx(nbytes, rel=1e-12)


# hymba's prefill attention, bound by operations where qwen2's is bound
# by bytes
HYMBA_FLASH = dict(B=4, S=1536, H=25, Hkv=5, D=64, window=1024)


@pytest.mark.parametrize("kernel,over", [
    ("flash_attention", {}), ("decode_attention", {}), ("ssm_scan", {}),
    ("flash_attention", HYMBA_FLASH)])
def test_leaf_stalls_follow_the_bound(kernel, over):
    """The leaves' bytes are the function's global traffic and move at
    the HBM rate, as the op time model moves a custom-call's bytes: a
    call bound by bytes puts most of its leaves' weight (where its PC
    samples land) on memory stalls, a call bound by operations on
    compute."""
    ks = recover(kernel, **over)
    flops, nbytes = WORK[kernel](**dict(SHAPES[kernel], **over))
    by_bytes = nbytes / sampling.HBM_BW > flops / sampling.PEAK_FLOPS
    memory = sum(lf.weight for lf in ks.leaves if lf.stall == "memory")
    share = memory / sum(lf.weight for lf in ks.leaves)
    assert (share > 0.5) == by_bytes, (share, by_bytes)
    # the leaves' roofline times add up to the function's compute time
    # plus its memory time, at least its bound
    t_c, t_m = flops / sampling.PEAK_FLOPS, nbytes / sampling.HBM_BW
    assert max(t_c, t_m) < ks.active_s == pytest.approx(t_c + t_m, rel=1e-6)


@pytest.mark.parametrize("kernel", sorted(SHAPES))
def test_kernel_recovery_is_deterministic(kernel):
    a, b = recover(kernel), recover(kernel)
    assert [lf.frames for lf in a.leaves] == [lf.frames for lf in b.leaves]
    assert [lf.weight for lf in a.leaves] == [lf.weight for lf in b.leaves]


def test_constexpr_branch_follows_the_head_dim():
    """issue_pv's ``if constexpr (D == 128)`` picks the wgmma n128 product
    at D = 128 and the n64 one at D = 64, and the products keep the
    QK^T : PV split even at either width."""
    for d, want in ((128, "wgmma_rs_n128_tb"), (64, "wgmma_rs_n64_tb")):
        ks = recover("flash_attention", D=d)
        with open(os.path.join(CSRC, "flash_attention.cu")) as f:
            lines = f.read().splitlines()
        dots = [lf for lf in ks.leaves if lf.frames[-1].name == "dot_general"]
        pv = [lf for lf in dots
              if any(f.name == "issue_pv" for f in lf.frames)]
        assert len(pv) == 1 and want in lines[pv[0].line - 1]
        qk = [lf for lf in dots if lf not in pv]
        assert sum(lf.flops for lf in qk) == pytest.approx(pv[0].flops)


@pytest.mark.parametrize("name", MODELS)
def test_kernel_structures_bind_to_the_custom_calls(modules, name):
    cfg, prefill = modules[name, "prefill"]
    _, decode = modules[name, "decode_step"]
    structs = {ks.name: ks for ks in kernel_structures(cfg, B, S, S + GEN)}
    hybrid = HYBRID in cfg.blocks
    assert set(structs) == {"flash_attention", "decode_attention"} | (
        {"ssm_scan"} if hybrid else set())
    n_pre = sum(prefill.bind_kernel_structure(ks) for ks in structs.values())
    n_dec = sum(decode.bind_kernel_structure(ks) for ks in structs.values())
    n_hybrid = sum(k == HYBRID for k in cfg.blocks)
    assert n_pre == cfg.n_layers + n_hybrid and n_dec == cfg.n_layers
    # a bound custom-call gains the interior's modeled cost
    cost = export.cost(prefill)
    assert cost["flops"] == pytest.approx(
        dot_flops(prefill) + cfg.n_layers * structs["flash_attention"]
        .total_flops + n_hybrid * (structs["ssm_scan"].total_flops
                                   if hybrid else 0.0))
    assert cost["bytes accessed"] == sum(op.bytes for op in
                                         prefill.all_ops())


def test_sass_line_table_keeps_inlined_call_sites():
    """chip_smoke's reading of ``nvdisasm -gi``: each instruction counts
    for every level of the "//##" block above it, so the .cu call site of
    an inlined header helper (a dot_general leaf's line) is found; an
    annotation with no instruction under it counts for nothing."""
    sass = "\n".join([
        '\t//## File "/x/csrc/hopper.cuh", line 110 inlined at '
        '"/x/csrc/flash_attention.cu", line 155',
        '\t//## File "/x/csrc/flash_attention.cu", line 155 inlined at '
        '"/x/csrc/flash_attention.cu", line 285',
        '\t//## File "/x/csrc/flash_attention.cu", line 285',
        "        /*1590*/                   SHF.R.U32.HI R12, RZ, 0x4, R12 ;",
        "        /*15a0*/                   HGMMA.64x64x16.F32.BF16 R88 ;",
        '\t//## File "/x/csrc/hopper.cuh", line 135 inlined at '
        '"/x/csrc/flash_attention.cu", line 154',
        "        /*15b0*/                   NOP ;",
        '\t//## File "/x/csrc/flash_attention.cu", line 999'])
    assert chip_smoke().line_table(sass) == {
        ("hopper.cuh", 110), ("flash_attention.cu", 155),
        ("flash_attention.cu", 285), ("hopper.cuh", 135),
        ("flash_attention.cu", 154)}
