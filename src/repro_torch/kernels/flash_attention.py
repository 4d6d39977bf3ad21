"""Flash attention forward: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
_flash_fwd_kernel`` (wrapper ``flash_attention_fwd``), which walks kv
blocks on a sequential grid axis carrying fp32 (m, l, acc) in VMEM.

The Hopper kernel (``csrc/flash_attention.cu``) gives one CTA to each
(batch, q head, 64-row q tile), heaviest first, and loops over kv tiles
inside it, since blocks on the H100 run in parallel in no order.  It is
warp-specialised: a producer warp keeps TMA loads of the K and V tiles in
flight through a ring of shared-memory stages guarded by mbarriers, and
one consumer warpgroup runs both products on ``wgmma`` (bf16, fp32
accumulate) with the online softmax in registers.  What bounds it: about
4*B*H*S^2*D/2 causal FLOPs against the q+k+v+o bytes; at the serving
prompt of 512 the two bounds are close (bytes slightly ahead), and FLOPs
take over as S grows or under a window.  The design keeps everything
between the two products out of device memory, overlaps loads with the
math, and loads only the kv tiles inside the causal (and window) bound.
The wrapper encodes the three TMA descriptors on the host per call.

``flash_attention_plain`` computes the same function in plain torch (a
materialized masked softmax in fp32).  The CPU path and the on-card
comparison use it; nothing on the CUDA main path does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head dims the kernel is built for
                       # (launch<64> and launch<128>)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H,D) in q.dtype.  Rows sit
    at absolute positions ``q_offset + i`` (top-left alignment, as the
    TPU kernel); key j is visible to row i when ``j <= q_offset + i``
    (causal) and ``j > q_offset + i - window`` (window > 0)."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * (D ** -0.5)
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def work(B: int, S: int, H: int, Hkv: int, D: int, window: int = 0
         ) -> tuple:
    """(FLOPs, bytes) of one call: QK^T and PV over the causal (and
    window) pairs; q, k, v read once and the output written once, bf16."""
    w = window or S
    pairs = sum(min(i + 1, w) for i in range(S))
    return (4.0 * B * H * pairs * D,
            2.0 * (2 * B * S * H * D + 2 * B * S * Hkv * D))


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream.  Takes bf16 CUDA
    tensors q (B,S,H,D) and k/v (B,Sk,Hkv,D) with D in ``HEAD_DIMS``;
    raises on anything else."""
    B, S, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be a 4-d "
                             f"bf16 CUDA tensor, got {t.dtype} on {t.device}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or H % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if q_offset < 0 or window < 0:
        raise ValueError("flash_attention kernel: q_offset and window must "
                         "be >= 0")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Sk, H, Hkv, D, int(bool(causal)), int(window),
            int(q_offset), stream)
    build.check(err, "flash_attention_fwd_bf16")
    return out
