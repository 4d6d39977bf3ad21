"""Flash-decode attention: the Hopper kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
_decode_kernel`` (wrapper ``flash_decode_fwd``): one query token per
sequence against a (B, Smax, Hkv, D) cache, all G q heads of one kv head
in one cell, positions >= ``length`` masked and whole blocks beyond it
skipped, (m, l, acc) carried over a sequential grid axis.  It takes any
G; so does the kernel here, in tiles of ``Q_TILE`` q heads: a kv head of
G q heads is ceil(G / 16) cells, each reading the kv head's keys.

On the H100 there is no sequential grid to carry the state, and B*Hkv
blocks would leave most of the 132 SMs idle at serving batch sizes.  The
kernel (``csrc/decode_attention.cu``) therefore splits [0, length) across
blocks (flash-decoding), ``plan_splits`` choosing the split in keys.
The splits of one (batch, kv head)
form one thread-block cluster and merge their partial (m, l, acc) through
distributed shared memory in a fixed order, inside the same launch: one
kernel per call, no scratch, bitwise-deterministic results.  What bounds
it: bytes, about 6 FLOP per byte; but at serving cache sizes a call's
time is its chain of latencies, so every block issues all its loads up
front and both products run on the tensor cores (mma.sync).

``flash_decode_plain`` computes the same function in plain torch, as
``repro.models.attention.decode_attention`` does: fp32 scores and
softmax, p cast to the cache dtype, fp32 accumulation.  The CPU path and
the on-card comparison use it; nothing on the CUDA main path does.  The
kernel also feeds p to the tensor cores in bf16, so the two differ by
the order of sums only (and both differ from the TPU kernel, which keeps
p in fp32, by the bf16 rounding of p).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the head dims the kernel is built for
                       # (launch<64> and launch<128>)
Q_TILE = 16            # q heads per cell (kMaxG): one m16 tile of q
                       # rows; a kv head of G q heads is ceil(G / 16) cells
MAX_SPLITS = 8         # splits per (batch, kv head): one portable cluster
MIN_KEYS = 64          # keys per split at least: one 16-key step a warp


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, length: int,
                       with_lse: bool = False):
    """q: (B,H,D); caches: (B,Smax,Hkv,D); length: valid cache length
    (0 <= length <= Smax).  Returns (B,H,D) in q.dtype; ``with_lse`` also
    each row's natural log-sum-exp of its scaled scores over the valid
    keys, (B,H) fp32.  At length 0 (a rank's slice of a cache split over
    its sequence that holds no valid key yet) the output is 0 and the lse
    -inf, so the slice weighs nothing in ``merge_partials``."""
    B, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    if length == 0:
        out = q.new_zeros((B, H, D))
        lse = torch.full((B, H), float("-inf"), device=q.device)
        return (out, lse) if with_lse else out
    qr = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qr.float(), k_cache.float()) \
        * (D ** -0.5)
    valid = torch.arange(k_cache.shape[1], device=q.device) < length
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H)


def q_tiles(H: int, Hkv: int) -> int:
    """Cells of one kv head: tiles of ``Q_TILE`` of its H / Hkv q
    heads."""
    return -(-(H // Hkv) // Q_TILE)


def work(B: int, H: int, Hkv: int, D: int, length: int) -> tuple:
    """(FLOPs, bytes) the function needs: QK^T and PV over ``length``
    keys; q read and the output written once, the first ``length`` rows
    of each cache read once, bf16.  The kernel reads each kv head's keys
    once a tile of q heads (``q_tiles``), so past G = 16 it moves more
    bytes than this."""
    return (4.0 * B * H * length * D,
            2.0 * (2 * B * H * D + 2 * B * length * Hkv * D))


def plan_splits(batch: int, n_kv_heads: int, length: int, n_sms: int,
                n_q_tiles: int = 1) -> tuple:
    """(n_splits, keys_per_split): split [0, length) into ranges of any
    number of keys, none empty.  The split count is the largest power of
    two up to ``MAX_SPLITS`` (one portable cluster) that keeps the grid,
    batch * n_kv_heads * n_q_tiles * splits blocks, within one block per
    SM of the ``n_sms`` and each split at about ``MIN_KEYS`` keys or
    more.  At the serving shapes that is 8 splits for qwen2 (64 blocks)
    and 4 for hymba (80 blocks; 8 would be 160), the fastest of 1-8 in
    ``chip_smoke``'s split sweep on an H100 (``PERF.md``)."""
    n_keys = -(-length // MIN_KEYS)
    cells = batch * n_kv_heads * n_q_tiles
    want = 1
    while (2 * want <= min(MAX_SPLITS, n_keys)
           and 2 * want * cells <= n_sms):
        want *= 2
    per = -(-length // want)
    return -(-length // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.flash_decode_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, length: int,
                      with_lse: bool = False):
    """Launch the kernel (one launch) on the current stream.  Takes a
    bf16 CUDA q (B,H,D) and contiguous bf16 CUDA caches (B,Smax,Hkv,D),
    D in ``HEAD_DIMS``, any H/Hkv and 0 <= length <= Smax; raises on
    anything else.  ``with_lse``: also the (B,H) fp32 log-sum-exp the
    kernel writes after its cluster merge (without it the kernel is given
    a null pointer and writes the output alone)."""
    B, H, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode kernel: {name} must be a bf16 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != D \
            or H % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel: bad shapes q {tuple(q.shape)}"
                         f" cache {tuple(k_cache.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode kernel: caches must be contiguous")
    length = int(length)
    if not 0 <= length <= Smax:
        raise ValueError(f"flash_decode kernel: length {length} outside "
                         f"[0, {Smax}]")
    q = q.contiguous()
    n_splits, keys_per_split = plan_splits(B, Hkv, length,
                                           _sm_count(q.device),
                                           q_tiles(H, Hkv)) \
        if length else (1, 0)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().flash_decode_fwd_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), B, H, Hkv, Smax, D, length, n_splits,
            keys_per_split, lse.data_ptr() if with_lse else None, stream)
    build.check(err, "flash_decode_fwd_bf16")
    return (out, lse) if with_lse else out
