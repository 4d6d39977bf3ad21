"""The MoE dispatch's gated combine: the Hopper kernels and their plain
versions.

Replaces no TPU kernel.  The JAX package's ``_local_moe`` gathers each
token's k expert slots from the experts' outputs (a zero dump row
appended for the dropped assignments and, on a mesh, those bound for
another shard's experts), casts them to fp32 and sums them weighted by
the gates, with XLA ops.  Done the same way on the card, the gather's
backward is an ``index_put_(accumulate=True)`` that sorts the T * k slot
indices and adds every duplicate of the dump row one after another: at
granite-moe's training shape 18k-35k rows of zeros summed serially into a
row that nothing reads, most of a train step's device time while the
router still drops many assignments.

``moe_combine(eo, slot, w)``: ``eo`` (R, d) the experts' output rows,
``slot`` (T * k,) int64 each assignment's row (R: the dump row, which adds
nothing), ``w`` (T, k) fp32 the gates, 0 where dropped.  Returns y (T, d)
fp32, y[t] = sum over j = 0..k-1, in that order, of eo[slot[t, j]] * w[t,
j].  ``csrc/moe_combine.cu`` gives each token a block that reads its kept
rows with 16-byte loads and writes y once, in the same fp32 multiplies
and adds as the plain version's separate kernels (no contraction), so
the two agree bitwise.

``moe_uncombine(dy, eo, slot, w)``, the combine's adjoint: d_eo (R, d) in
eo's dtype, each kept slot's row w[t, j] * dy[t] and zero elsewhere, and
dw (T, k) fp32, dw[t, j] = <dy[t], eo[slot[t, j]]> and 0 at the dump
row.  The kept slots of one call are distinct (a slot is its expert's
running count below the capacity), so ``csrc/moe_uncombine.cu`` writes
each once, with no atomics and nothing accumulated, after zero-filling
d_eo; one warp a (t, j) reduces its dw.  Its d_eo is bitwise what
autograd makes of the plain combine (a single add onto a zero row), dw
differs by the order of the fp32 sum.

Both are bound by bytes (under one FLOP a byte): what they save is the
serial sum and the fp32 (T, k, d) intermediate of the plain version and
its eight views' zero-filled gradients.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' element types


def moe_combine_plain(eo: torch.Tensor, slot: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The combine in plain torch, as the JAX package's ``_local_moe``
    computes it: the zero dump row appended, the gather, fp32, and the
    weighted slots added one at a time."""
    R, d = eo.shape
    T, k = w.shape
    out_flat = torch.cat([eo, eo.new_zeros((1, d))], dim=0)
    contrib = out_flat[slot].float().reshape(T, k, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=eo.device)
    for j in range(k):
        y = y + contrib[:, j] * w[:, j, None]
    return y


def moe_uncombine_plain(dy: torch.Tensor, eo: torch.Tensor,
                        slot: torch.Tensor, w: torch.Tensor) -> tuple:
    """The combine's adjoint in plain torch: (d_eo (R, d) in eo's dtype,
    dw (T, k) fp32).  Each kept row is added once onto zeros, as
    autograd's index-put adds it, so d_eo is bitwise that of the plain
    combine's autograd."""
    R, d = eo.shape
    T, k = w.shape
    kept = slot < R
    g = (dy.unsqueeze(1) * w.unsqueeze(2)).reshape(T * k, d)
    d_eo = eo.new_zeros((R, d))
    d_eo.index_put_((slot[kept],), g[kept].to(eo.dtype), accumulate=True)
    rows = torch.cat([eo, eo.new_zeros((1, d))], dim=0)[slot].float()
    dw = (dy.unsqueeze(1) * rows.reshape(T, k, d)).sum(-1)
    return d_eo, dw


def work(T: int, k: int, d: int, R: int, kept=None) -> tuple:
    """(FLOPs, bytes) of one combine.  FLOPs as the port's cost counts
    them, products only: none (its 2 * T * k * d multiply-adds are
    elementwise work).  Bytes: every kept assignment's row read once
    (``kept`` rows, bf16; every assignment, at most R rows, where it is
    not given), the slots and gates read and y written once."""
    rows = min(T * k, R) if kept is None else kept
    return 0.0, float(2 * rows * d + 12 * T * k + 4 * T * d)


def uncombine_work(T: int, k: int, d: int, R: int, kept=None) -> tuple:
    """(FLOPs, bytes) of one adjoint, counted as ``work``: none; dy, the
    kept assignments' rows, slots and gates read once, d_eo (all R rows,
    bf16) and dw written once."""
    rows = min(T * k, R) if kept is None else kept
    return 0.0, float(4 * T * d + 2 * rows * d + 12 * T * k + 2 * R * d
                      + 4 * T * k)


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        n_ptr = 4 if name == "moe_combine" else 6
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 \
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(eo: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
           what: str) -> tuple:
    """(T, k, d, R) after checking the kernels' operands."""
    if eo.dtype not in _DTYPES or eo.dim() != 2:
        raise ValueError(f"{what} kernel: eo must be a 2-D float32 or "
                         f"bfloat16 tensor, got {eo.dtype} "
                         f"{tuple(eo.shape)}")
    if w.dtype != torch.float32 or w.dim() != 2:
        raise ValueError(f"{what} kernel: w must be a (T, k) float32 "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    if slot.dtype != torch.int64 or slot.shape != (w.numel(),):
        raise ValueError(f"{what} kernel: slot must be int64 of shape "
                         f"({w.numel()},), got {slot.dtype} "
                         f"{tuple(slot.shape)}")
    for name, t in (("eo", eo), ("slot", slot), ("w", w)):
        if not t.is_cuda or t.device != eo.device:
            raise ValueError(f"{what} kernel: {name} must be on eo's CUDA "
                             f"device, got {t.device}")
    return w.shape[0], w.shape[1], eo.shape[1], eo.shape[0]


def moe_combine_cuda(eo: torch.Tensor, slot: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Launch the combine (one launch) on the current stream.  Takes CUDA
    eo (R, d) float32 or bfloat16, slot (T * k,) int64, w (T, k) float32
    on one device; raises on anything else."""
    T, k, d, R = _check(eo, slot, w, "moe_combine")
    eo, slot, w = eo.contiguous(), slot.contiguous(), w.contiguous()
    y = torch.empty((T, d), dtype=torch.float32, device=eo.device)
    if T == 0 or d == 0:
        return y
    stream = torch.cuda.current_stream(eo.device).cuda_stream
    with torch.cuda.device(eo.device):
        err = _lib("moe_combine").moe_combine_launch(
            eo.data_ptr(), slot.data_ptr(), w.data_ptr(), y.data_ptr(),
            T, k, d, R, _DTYPES[eo.dtype], stream)
    build.check(err, "moe_combine_launch")
    return y


def moe_uncombine_cuda(dy: torch.Tensor, eo: torch.Tensor,
                       slot: torch.Tensor, w: torch.Tensor) -> tuple:
    """Launch the adjoint (a fill of d_eo, then one launch) on the current
    stream: (d_eo (R, d) in eo's dtype, dw (T, k) float32).  Takes dy (T,
    d) float32 and the combine's operands on one CUDA device."""
    T, k, d, R = _check(eo, slot, w, "moe_uncombine")
    if dy.dtype != torch.float32 or dy.shape != (T, d) \
            or dy.device != eo.device:
        raise ValueError(f"moe_uncombine kernel: dy must be float32 "
                         f"({T}, {d}) on {eo.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    dy, eo = dy.contiguous(), eo.contiguous()
    slot, w = slot.contiguous(), w.contiguous()
    d_eo = torch.empty_like(eo)
    dw = torch.empty((T, k), dtype=torch.float32, device=eo.device)
    stream = torch.cuda.current_stream(eo.device).cuda_stream
    with torch.cuda.device(eo.device):
        err = _lib("moe_uncombine").moe_uncombine_launch(
            dy.data_ptr(), eo.data_ptr(), slot.data_ptr(), w.data_ptr(),
            d_eo.data_ptr(), dw.data_ptr(), T, k, d, R,
            _DTYPES[eo.dtype], stream)
    build.check(err, "moe_uncombine_launch")
    return d_eo, dw
