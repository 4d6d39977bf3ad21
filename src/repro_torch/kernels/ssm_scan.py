"""Mamba-2 SSD chunked scan forward: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/ssm_scan.py::_ssd_kernel``
(wrapper ``ssm_scan_fwd``), whose grid (B, nh, chunks) runs the chunk axis
in order and carries the fp32 (hd, st) state in VMEM scratch.

On the H100 blocks run in no order and the chunk order is a true
dependency, so the kernel (``csrc/ssm_scan.cu``) gives one thread block
(1024 threads) to each (head, batch) and loops over the chunks inside it,
the state in shared memory.  Each chunk's X, B, C and logdecay are staged into shared
memory in fp32, ``cum`` is a warp scan, one warp computes each output row
(the decay weights of 32 keys at a time, masked before ``exp``), and the
state update follows once every row has read the old state.  The ragged
last chunk is zero-filled instead of asserting ``S % chunk == 0``.

What bounds it, at the serving shapes (B=4, S=1536, nh=25, hd=64, st=16):
about 41 MB of xv, y, logdecay, B/C and h_final, 0.012 ms at 3.35 TB/s;
its 2.2 GFLOP at chunk 64 take 0.002 ms at the bf16 tensor-core peak but
about 0.033 ms at the fp32 CUDA-core rate the kernel runs at (fp32 FMAs,
as the reference's fp32 g and h require).  B*nh = 100 blocks leave 32 of
the 132 SMs idle; a split into chunk-state, state-passing and chunk-output
kernels would fill the card.

``ssm_scan_plain`` is the chunked algorithm of the JAX package's
``repro.models.ssm.ssd_chunked`` in plain torch (fp32 throughout, the
decay mask applied before ``exp``, a chunk that divides S).  The CPU path
and the on-card comparison use it; nothing on the CUDA main path does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import pick_chunk

MAX_CHUNK = 256        # positions per chunk the kernel holds (kMaxChunk)
MAX_HEAD_DIM = 128     # kMaxHD; the head dim must also be a multiple of 8
MAX_STATE = 64         # kMaxST
MAX_SMEM = 232448      # shared-memory bytes an H100 block may use


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


def smem_bytes(c: int, hd: int, st: int) -> int:
    """Shared memory of one block: X, padded B and C, cum, w and h."""
    return 4 * (c * hd + 2 * c * (st + 1) + 2 * c + st * hd)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ssm_scan_cuda(xv: torch.Tensor, logdecay: torch.Tensor,
                  Bmat: torch.Tensor, Cmat: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, *, chunk: int = 256
                  ) -> tuple:
    """Launch the Hopper kernel on the current stream.  Takes CUDA tensors:
    xv (B,S,nh,hd) bf16 with hd a multiple of 8 and at most
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
    c = min(int(chunk), S)
    if S < 1 or hd % 8 or hd > MAX_HEAD_DIM or not 1 <= st <= MAX_STATE \
            or not 1 <= int(chunk) <= MAX_CHUNK \
            or smem_bytes(c, hd, st) > MAX_SMEM:
        raise ValueError(f"ssm_scan kernel: unsupported S={S} hd={hd} "
                         f"st={st} chunk={chunk}")
    xv, logdecay = xv.contiguous(), logdecay.contiguous()
    Bmat, Cmat = Bmat.contiguous(), Cmat.contiguous()
    if h0 is not None:
        h0 = h0.contiguous()
    if xv.data_ptr() % 16:
        raise ValueError("ssm_scan kernel: xv must be 16-byte aligned")
    y = torch.empty_like(xv)
    h_out = torch.empty((B, nh, hd, st), dtype=torch.float32,
                        device=xv.device)
    stream = torch.cuda.current_stream(xv.device).cuda_stream
    with torch.cuda.device(xv.device):
        err = _lib().ssm_scan_fwd_bf16(
            xv.data_ptr(), logdecay.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), B, S, nh, hd, st, c, stream)
    build.check(err, "ssm_scan_fwd_bf16")
    return y, h_out
