"""Mamba-2 SSD chunked scan forward: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py::_ssd_kernel``
(wrapper ``ssm_scan_fwd``), whose grid (B, nh, chunks) runs the chunk axis
in order and carries the fp32 (hd, st) state in VMEM scratch.

On the H100 the kernel (``csrc/ssm_scan.cu``) is the SSD decomposition in
three launches, every part but the h recurrence parallel over (batch,
chunk, head):

1. chunk state, one block per (b, chunk, group of heads): ``cum`` (a warp
   scan per head) and the chunk's own state contribution
   S_i = X_i^T (B_i * exp(total_i - cum_i)) on the tensor cores, into an
   fp32 workspace (B, n_chunks, nh, hd, st) beside exp(total_i);
2. state passing, one thread per (b, head, d, s): the fp32 recurrence
   h_i = exp(total_i) h_{i-1} + S_i in chunk order, leaving the state that
   enters each chunk in the workspace, and h_final;
3. chunk output, one block per (b, chunk, group of heads): C B^T once for
   the group (B and C are shared by the heads), then per head
   y = (L * C B^T) X + exp(cum) (C h^T) on the tensor cores.

What bounds it: bytes.  At the serving shape (B=4, S=1536, nh=25, hd=64,
st=16, chunk 64) the function moves about 41 MB of xv, y, logdecay, B/C
and h_final: 0.0122 ms at 3.35 TB/s; its 1.3 GFLOP take 0.0013 ms on the
bf16 tensor cores.  Against the limits of the one-block-per-(head,
batch) kernel this replaces: the grid has B * chunks * groups blocks
(1248 at the serving shape, 2 heads per block) instead of 100 serial
walks; every product is an ``mma.sync`` fed by ``ldmatrix`` instead of an
fp32 FMA fed from shared memory; each block issues all its loads up front
with ``cp.async``, so the next head loads while this one computes, and
the heads' cumsums run in parallel; the tensor cores, not the fp32
CUDA-core rate, do the arithmetic.  Of the fp32 operands, G and B * w are rounded to bf16
(2^-9 relative) as the products take them, and the entering state is
split into bf16 hi + lo (two products): rounded to bf16 alone it fails
the per-row check on long prompts.  The state carried between chunks
stays fp32, and the tolerances of the JAX package's tests hold unchanged
(``tests/test_torch_ssm.py`` emulates this rounding on the CPU).  The mask goes in before ``exp`` as a select, the
ragged last chunk is zero-filled with logdecay 0, and nothing is atomic,
so a repeat is bitwise equal.

The launch plan (chunk, heads per block, grid, workspace, and the
shared-memory layout's X row strides and bytes) is ``plan``, in Python,
cached per shape.  It is the one source of those sizes: the C launcher
takes them and refuses a plan whose bytes are not where its kernels'
carve-up of shared memory ends.

``ssm_scan_plain`` is the chunked algorithm of the JAX package's
``repro.models.ssm.ssd_chunked`` in plain torch (fp32 throughout, the
decay mask applied before ``exp``, a chunk that divides S).  The CPU path
and the on-card comparison use it; nothing on the CUDA main path does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import pick_chunk

MAX_CHUNK = 256        # positions per chunk the kernel holds (kMaxChunk)
MAX_HEAD_DIM = 128     # kMaxHD; the head dim must also be a multiple of 8
MAX_STATE = 128        # kMaxST
MAX_SMEM = 232448      # shared-memory bytes an H100 block may use
HEADS_PER_BLOCK = 2    # kMaxHeads: one head per pair of warps in step 3
BAND = 64              # kBand: rows of C B^T a block holds at once
PASS_THREADS = 256     # kPassThreads: threads per block of step 2


def ssm_scan_plain(xv: torch.Tensor, logdecay: torch.Tensor,
                   Bmat: torch.Tensor, Cmat: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *, chunk: int = 256
                   ) -> tuple:
    """xv (B,S,nh,hd); logdecay (B,S,nh); Bmat/Cmat (B,S,st); h0
    (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd) in xv.dtype, h_final
    (B,nh,hd,st) fp32).  Chunks are the largest divisor of S that is at
    most ``chunk``, as in ``ssd_chunked``."""
    B, S, nh, hd = xv.shape
    st = Bmat.shape[-1]
    c = pick_chunk(S, chunk)
    n = S // c
    xc = xv.reshape(B, n, c, nh, hd).float()
    ld = logdecay.reshape(B, n, c, nh).float()
    Bc = Bmat.reshape(B, n, c, st).float()
    Cc = Cmat.reshape(B, n, c, st).float()
    if h0 is None:
        h = torch.zeros((B, nh, hd, st), dtype=torch.float32,
                        device=xv.device)
    else:
        h = h0.float()

    cum = torch.cumsum(ld, dim=2)                          # (B,n,c,nh)
    total = cum[:, :, -1]                                  # (B,n,nh)
    # g[t, tau] = exp(cum_t - cum_tau) * (C_t . B_tau) for tau <= t; the
    # mask goes in before exp, so the upper triangle's positive deltas
    # never overflow
    cb = torch.einsum("bncs,bnks->bnck", Cc, Bc)           # (B,n,c,c)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,n,t,tau,nh)
    tri = torch.ones((c, c), dtype=torch.bool, device=xv.device).tril()
    dec = torch.where(tri[:, :, None], dec,
                      torch.full_like(dec, float("-inf")))
    g = torch.exp(dec) * cb[..., None]
    y_intra = torch.einsum("bntkh,bnkhd->bnthd", g, xc)
    # each chunk's contribution to the state: sum_tau exp(total - cum) x B
    w = torch.exp(total[:, :, None, :] - cum)              # (B,n,c,nh)
    sc = torch.einsum("bnch,bnchd,bncs->bnhds", w, xc, Bc)
    y_inter = []
    for i in range(n):
        y_inter.append(torch.einsum("bcs,bhds,bch->bchd", Cc[:, i], h,
                                    torch.exp(cum[:, i])))
        h = h * torch.exp(total[:, i])[:, :, None, None] + sc[:, i]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(B, S, nh, hd)
    return y.to(xv.dtype), h


def work(B: int, S: int, nh: int, hd: int, st: int, chunk: int) -> tuple:
    """(FLOPs, bytes) of one call.  FLOPs: per (batch, chunk) C B^T over
    the causal pairs, shared by the heads; per head the masked product
    with X, the inter-chunk term and the state update.  Bytes: xv and y
    (bf16), logdecay (fp32), B and C (bf16) and h_final (fp32), each
    once."""
    c = min(chunk, S)
    n_chunks = -(-S // c)
    tri = c * (c + 1) / 2
    flops = 2.0 * B * n_chunks * (tri * st + nh * (tri * hd + 2 * c * st
                                                    * hd))
    nbytes = (2 * B * S * nh * hd * 2 + B * S * nh * 4 + 2 * B * S * st * 2
              + B * nh * hd * st * 4)
    return flops, float(nbytes)


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _smem_layout(c: int, hd: int, st: int, heads: int, step: int,
                 xpad: int) -> int:
    cp, hp = _up16(c), _up16(hd)
    ldx, ldb = hp + xpad, _up16(st) + 8
    if step == 1:      # X per head, B, B * w per head, w per head
        return (2 * heads * cp * ldx + 2 * cp * ldb + 2 * heads * cp * ldb
                + 4 * heads * cp)
    if step == 3:      # X per head, C and B, entering states as bf16 hi
        # and lo, cum per head, and a region that holds first the entering
        # states in fp32, then one band of C B^T
        return (2 * heads * cp * ldx + 4 * cp * ldb + 4 * heads * hp * ldb
                + 4 * heads * cp + max(4 * BAND * (cp + 8),
                                       4 * heads * hd * st))
    raise ValueError(f"step {step}: only steps 1 and 3 use shared memory")


def _x_pad(c: int, hd: int, st: int, heads: int, step: int) -> int:
    """X rows keep their pad of 8 bf16 unless that alone would not fit
    (large chunks at hd >= 104 and st > 48, one head per block)."""
    return 8 if _smem_layout(c, hd, st, heads, step, 8) <= MAX_SMEM else 0


def smem_bytes(c: int, hd: int, st: int, heads: int, step: int) -> int:
    """Shared memory of one block of step 1 (chunk state) or step 3 (chunk
    output) at chunk ``c`` (capped at S), as ``csrc/ssm_scan.cu``'s
    ``state_smem`` / ``out_smem`` carve it up: bf16 rows padded to 16 and
    then by 8 (16 bytes, so ldmatrix's row reads fall into different bank
    groups), except X's rows where that pad alone would not fit."""
    return _smem_layout(c, hd, st, heads, step,
                        _x_pad(c, hd, st, heads, step))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch plan.  Steps 1 and 3 run ``blocks`` blocks, block
    i owning batch i // (n_chunks * n_groups), chunk (i // n_groups) %
    n_chunks and heads [g * heads_per_block, +heads_per_block) clipped at
    nh, g = i % n_groups; step 2 runs ``pass_blocks`` blocks of
    ``PASS_THREADS``.  ``ldx_*`` is X's row stride in shared memory (bf16)
    and ``smem_*`` the shared-memory bytes, of steps 1 and 3."""
    chunk: int
    n_chunks: int
    heads_per_block: int
    n_groups: int
    blocks: int
    pass_blocks: int
    ldx_state: int
    smem_state: int
    ldx_out: int
    smem_out: int
    workspace: tuple      # states (B, n_chunks, nh, hd, st) fp32
    decay: tuple          # exp(total) (B, n_chunks, nh) fp32


def _fits(c: int, hd: int, st: int, k: int) -> bool:
    return max(smem_bytes(c, hd, st, k, 1),
               smem_bytes(c, hd, st, k, 3)) <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, nh: int, hd: int, st: int, chunk: int) -> Plan:
    """The launch plan for these shapes, or ValueError where the kernel
    does not take them.  A group is ``HEADS_PER_BLOCK`` heads (at most
    nh), one where shared memory would not hold more; where one head does
    not fit at ``chunk`` either, the chunk is halved until it does (a
    state past 64 at large chunks: at hd 64 and st 128 a chunk of 256
    needs 279,552 bytes with one head, 128 takes 158,208).  The chunk does
    not change the result, up to rounding.  A shape that fitted one head
    at its chunk keeps that chunk."""
    if B < 1 or S < 1 or nh < 1 or hd % 8 or not 8 <= hd <= MAX_HEAD_DIM \
            or not 1 <= st <= MAX_STATE or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssm_scan kernel: unsupported B={B} S={S} nh={nh} "
                         f"hd={hd} st={st} chunk={chunk}")
    c = min(chunk, S)
    while c > 1 and not _fits(c, hd, st, 1):
        c = -(-c // 2)
    k = min(HEADS_PER_BLOCK, nh)
    while k > 1 and not _fits(c, hd, st, k):
        k -= 1
    sm1, sm3 = smem_bytes(c, hd, st, k, 1), smem_bytes(c, hd, st, k, 3)
    n_chunks = -(-S // c)
    n_groups = -(-nh // k)
    return Plan(chunk=c, n_chunks=n_chunks, heads_per_block=k,
                n_groups=n_groups, blocks=B * n_chunks * n_groups,
                pass_blocks=-(-B * nh * hd * st // PASS_THREADS),
                ldx_state=_up16(hd) + _x_pad(c, hd, st, k, 1),
                smem_state=sm1,
                ldx_out=_up16(hd) + _x_pad(c, hd, st, k, 3), smem_out=sm3,
                workspace=(B, n_chunks, nh, hd, st), decay=(B, n_chunks, nh))


def _lib() -> ctypes.CDLL:
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssm_scan_cuda(xv: torch.Tensor, logdecay: torch.Tensor,
                  Bmat: torch.Tensor, Cmat: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, *, chunk: int = 256
                  ) -> tuple:
    """Launch the Hopper kernel's three steps on the current stream.  Takes
    CUDA tensors: xv (B,S,nh,hd) bf16 with hd a multiple of 8 and at most
    ``MAX_HEAD_DIM``, logdecay (B,S,nh) fp32, Bmat/Cmat (B,S,st) bf16 with
    st <= ``MAX_STATE``, h0 (B,nh,hd,st) fp32 or None, and
    1 <= chunk <= ``MAX_CHUNK``; raises on anything else.  Returns
    (y (B,S,nh,hd) bf16, h_final (B,nh,hd,st) fp32)."""
    if xv.dim() != 4:
        raise ValueError(f"ssm_scan kernel: xv must be 4-d, got "
                         f"{tuple(xv.shape)}")
    B, S, nh, hd = xv.shape
    st = Bmat.shape[-1] if Bmat.dim() == 3 else -1
    want = {"xv": (xv, torch.bfloat16, (B, S, nh, hd)),
            "logdecay": (logdecay, torch.float32, (B, S, nh)),
            "Bmat": (Bmat, torch.bfloat16, (B, S, st)),
            "Cmat": (Cmat, torch.bfloat16, (B, S, st))}
    if h0 is not None:
        want["h0"] = (h0, torch.float32, (B, nh, hd, st))
    for name, (t, dtype, shape) in want.items():
        if not t.is_cuda or t.dtype != dtype:
            raise ValueError(f"ssm_scan kernel: {name} must be a {dtype} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssm_scan kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    p = plan(B, S, nh, hd, st, int(chunk))
    xv, logdecay = xv.contiguous(), logdecay.contiguous()
    Bmat, Cmat = Bmat.contiguous(), Cmat.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    # X rows, and B/C rows where st % 8 == 0, go to shared memory by
    # 16-byte cp.async
    aligned = [("xv", xv)] + ([("Bmat", Bmat), ("Cmat", Cmat)]
                              if st % 8 == 0 else [])
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"ssm_scan kernel: {name} must be 16-byte "
                             f"aligned")
    y = torch.empty_like(xv)
    h_out = torch.empty((B, nh, hd, st), dtype=torch.float32,
                        device=xv.device)
    states = torch.empty(p.workspace, dtype=torch.float32, device=xv.device)
    decay = torch.empty(p.decay, dtype=torch.float32, device=xv.device)
    stream = torch.cuda.current_stream(xv.device).cuda_stream
    with torch.cuda.device(xv.device):
        err = _lib().ssm_scan_fwd_bf16(
            xv.data_ptr(), logdecay.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), states.data_ptr(),
            decay.data_ptr(), B, S, nh, hd, st, p.chunk, p.heads_per_block,
            p.ldx_state, p.smem_state, p.ldx_out, p.smem_out, stream)
    build.check(err, "ssm_scan_fwd_bf16")
    return y, h_out
