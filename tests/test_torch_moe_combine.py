"""The MoE dispatch's gated combine as one custom op
(``kernels.ops.moe_combine``) and its adjoint (``moe_uncombine``).

On the CPU the op runs its plain version, which is held here to the
combine the MoE layer computed before it became an op (kept below as
``combine_before``), forward and ``torch.autograd.grad`` both: y and the
gradient of the expert rows bitwise, the gates' gradient to 1e-6 of its
largest.  A step's program holds the op as one custom-call a MoE layer,
bound to the kernel's interior.  On the card ``chip_smoke.py`` holds
the kernels to the plain version (``check_combine``): y and the expert
rows' gradient bitwise, the gates' gradient to 1e-5 of its largest."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core import export
from repro_torch.core.kstruct import KernelStructure
from repro_torch.kernels import CSRC, call_shapes, graph_structures, ops
from repro_torch.kernels import moe_combine as mc
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

# one intra-op thread: the suite runs in several workers at once
torch.set_num_threads(1)


def combine_before(eo, slot, w):
    """The combine as ``models.moe._local_moe`` computed it inline: the
    zero dump row appended, the gather, fp32, the slots added in order."""
    R, d = eo.shape
    T_, k = w.shape
    out_flat = torch.cat([eo, eo.new_zeros((1, d))], dim=0)
    contrib = out_flat[slot].float().reshape(T_, k, d)
    y = torch.zeros((T_, d), dtype=torch.float32, device=eo.device)
    for j in range(k):
        y = y + contrib[:, j] * w[:, j, None]
    return y


def routing(gen, T_, k, E, capacity, e_loc=None, e0=0):
    """(slot, keep) as ``_local_moe`` makes them from top-k routing over E
    experts: token-major running counts, the assignments past an expert's
    capacity and those bound for another shard's experts (outside [e0,
    e0 + e_loc)) sent to the dump row ``e_loc * capacity``."""
    e_loc = E if e_loc is None else e_loc
    probs = torch.rand((T_, E), generator=gen)
    eidx = torch.topk(probs, k, dim=-1).indices
    le = eidx.reshape(-1) - e0
    mine = (le >= 0) & (le < e_loc)
    le = torch.where(mine, le, torch.full_like(le, e_loc))
    onehot = F.one_hot(le, e_loc + 1)[:, :e_loc]
    counts = onehot.t().contiguous().cumsum(dim=1).t()
    pos = ((counts - onehot) * onehot).sum(1)
    keep = mine & (pos < capacity)
    slot = torch.where(keep, le * capacity + pos,
                       torch.full_like(pos, e_loc * capacity))
    return slot, keep


def operands(gen, dtype, T_, k, d, R, slot, keep, device="cpu"):
    """eo (R, d) in ``dtype`` and w = gates * keep (T, k) fp32, both
    leaves that require grad, and dy (T, d) fp32."""
    eo = torch.randn((R, d), generator=gen).to(dtype)
    gates = torch.rand((T_, k), generator=gen)
    gates = gates / gates.sum(-1, keepdim=True)
    w = gates * keep.reshape(T_, k)
    dy = torch.randn((T_, d), generator=gen)
    return (eo.to(device).requires_grad_(True), w.to(device)
            .requires_grad_(True), dy.to(device), slot.to(device))


def assert_rel(got, want, tol):
    scale = want.abs().max().clamp_min(1e-30)
    assert float((got - want).abs().max() / scale) <= tol


# (T, k, E, capacity, e_loc, e0): none dropped, some over capacity, every
# assignment dropped (a capacity no slot fits in is not the layer's, so
# "all" sends every slot to the dump row), and a mesh shard's view
CASES = {
    "none": (24, 4, 8, 96, None, 0),
    "some": (24, 4, 8, 6, None, 0),
    "all": (24, 4, 8, 6, None, 0),
    "mesh": (24, 4, 8, 12, 4, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_op_is_the_combine_before_it(case, dtype):
    T_, k, E, cap, e_loc, e0 = CASES[case]
    gen = torch.Generator().manual_seed(7)
    slot, keep = routing(gen, T_, k, E, cap, e_loc, e0)
    R = (e_loc or E) * cap
    if case == "all":
        slot, keep = torch.full_like(slot, R), torch.zeros_like(keep)
    dropped = int((~keep).sum())
    assert {"none": dropped == 0, "some": 0 < dropped < T_ * k,
            "all": dropped == T_ * k, "mesh": dropped > 0}[case]
    eo, w, dy, slot = operands(gen, dtype, T_, k, 16, R, slot, keep)
    want = combine_before(eo, slot, w)
    got = ops.moe_combine(eo, slot, w)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    d_eo0, dw0 = torch.autograd.grad(want, (eo, w), dy)
    d_eo1, dw1 = torch.autograd.grad(got, (eo, w), dy)
    assert d_eo1.dtype == dtype and torch.equal(d_eo1, d_eo0)
    # a dropped slot's gate gradient is 0 in both
    assert_rel(dw1, dw0, 1e-6)
    assert torch.equal(dw1[~keep.reshape(T_, k)], torch.zeros(dropped))


def test_adjoint_is_the_registered_backward():
    """``moe_uncombine`` called directly gives what autograd gives."""
    gen = torch.Generator().manual_seed(3)
    slot, keep = routing(gen, 16, 2, 4, 5)
    eo, w, dy, slot = operands(gen, torch.bfloat16, 16, 2, 8, 20, slot,
                               keep)
    d_eo, dw = ops.moe_uncombine(dy, eo.detach(), slot, w.detach())
    g = torch.autograd.grad(ops.moe_combine(eo, slot, w), (eo, w), dy)
    assert torch.equal(d_eo, g[0]) and torch.equal(dw, g[1])


def test_work_and_interiors():
    """``call_shapes`` reads both ops' shapes, the FLOP counter counts no
    FLOPs for them (elementwise work, as the cost counts it), and each
    kernel's interior recovered from its source carries its bytes."""
    gen = torch.Generator().manual_seed(1)
    slot, keep = routing(gen, 8, 2, 4, 4)
    eo, w, dy, slot = operands(gen, torch.float32, 8, 2, 8, 16, slot, keep)
    assert call_shapes("repro_torch::moe_combine",
                       [eo.shape, slot.shape, w.shape]) == (
        "moe_combine", dict(T=8, k=2, d=8, R=16))
    assert call_shapes("repro_torch::moe_uncombine",
                       [dy.shape, eo.shape, slot.shape, w.shape]) == (
        "moe_uncombine", dict(T=8, k=2, d=8, R=16))
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(ops.moe_combine(eo, slot, w), (eo, w), dy)
    assert counter.get_total_flops() == 0
    sh = dict(T=8192, k=8, d=1024, R=32 * 2560)
    for name, work in (("moe_combine", mc.work),
                       ("moe_uncombine", mc.uncombine_work)):
        flops, nbytes = work(**sh)
        ks = KernelStructure.from_cuda_source(
            f"{CSRC}/{name}.cu", name, dict(sh, flops=flops, bytes=nbytes))
        assert ks.name == name and ks.total_flops == 0
        assert ks.total_bytes == pytest.approx(nbytes)
        assert all(lf.frames[-1].module == f"{name}.cu" for lf in ks.leaves)


def test_a_granite_step_holds_one_combine_a_moe_layer():
    """Reduced granite's recorded train step: each MoE layer's combine is
    one custom-call in the forward and one in the remat's recompute, its
    adjoint one in the backward, each bound to its own kernel's interior
    at the step's shapes; the exported prefill holds one a layer."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    n_moe = len(cfg.moe_layers())
    assert n_moe == cfg.n_layers == 2
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    opts = T.ModelOptions()
    fn = steps.make_train_step(cfg, opts, adamw.OptConfig())
    gm = export.trace_train_step(fn, (params, adamw.init(params),
                                      {"tokens": toks,
                                       "labels": toks.int()}))
    module = export.module_from_graph("train_step", gm)
    kinds = [op.op_name.rsplit("/", 1)[-1] for op in module.all_ops()
             if op.opcode == "custom-call"]
    assert kinds.count("moe_combine") == 2 * n_moe
    assert kinds.count("moe_uncombine") == n_moe
    structs = {ks.name: ks for ks in graph_structures(gm)}
    assert set(structs) == {"flash_attention", "moe_combine",
                            "moe_uncombine"}
    assert sum(module.bind_kernel_structure(ks)
               for ks in structs.values()) == len(kinds)
    assert sorted(ks.name for ks in module.kernel_structures().values()) \
        == sorted(kinds)
    prefill = steps.make_prefill_step(cfg, opts)
    program = export.export_step(prefill, (params, {"tokens": toks}))
    pre = export.module_from_export("prefill", program)
    assert [op.op_name.rsplit("/", 1)[-1] for op in pre.all_ops()
            if op.opcode == "custom-call"].count("moe_combine") == n_moe
    assert ops.moe_combine.launches == ops.moe_uncombine.launches == 0
