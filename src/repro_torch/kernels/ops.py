"""Public wrappers around the Hopper kernels (forward only).

A wrapper picks its route from where its input lies: a CPU tensor takes
the kernel's plain torch version; a CUDA tensor launches the kernel or
raises (there is no fallback).  Each wrapper counts its kernel launches
in its ``launches`` attribute, so a run can show that its main path went
through the kernels.  The backward passes come with the training slice:
a CUDA input that requires grad raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssm_scan as _ss


def _no_grad_on_cuda(what: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward-only; the backward comes "
            f"with the training slice")


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    block_q: int = 256, block_kv: int = 256):
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H,D).  Causal (+optional
    sliding window) GQA attention with q and k aligned at position 0.
    ``block_q``/``block_kv`` are the TPU kernel's tile sizes, kept for the
    signature; the Hopper kernel's tiles are fixed at compile time and
    the plain version has none."""
    del block_q, block_kv
    if q.is_cuda:
        _no_grad_on_cuda("flash_attention", q, k, v)
        out = _fa.flash_attention_cuda(q, k, v, causal=bool(causal),
                                       window=int(window))
        flash_attention.launches += 1
        return out
    return _fa.flash_attention_plain(q, k, v, causal=bool(causal),
                                     window=int(window))


def flash_decode(q, k_cache, v_cache, length: int, block_kv: int = 512):
    """One-token decode attention against a KV cache (B,H,D) x
    (B,Smax,Hkv,D) -> (B,H,D).  ``length`` is a Python int (no device
    sync); ``block_kv`` is the TPU kernel's tile size, kept for the
    signature."""
    del block_kv
    if q.is_cuda:
        _no_grad_on_cuda("flash_decode", q, k_cache, v_cache)
        out = _fd.flash_decode_cuda(q, k_cache, v_cache, int(length))
        flash_decode.launches += 1
        return out
    return _fd.flash_decode_plain(q, k_cache, v_cache, int(length))


def ssm_scan(xv, logdecay, Bmat, Cmat, h0=None, chunk: int = 256):
    """Chunkwise SSD scan.  xv (B,S,nh,hd), logdecay (B,S,nh), Bmat/Cmat
    (B,S,st), h0 (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd) in
    xv.dtype, h_final (B,nh,hd,st) fp32).  ``chunk`` is capped at S, as
    in the JAX wrapper."""
    c = min(int(chunk), xv.shape[1])
    if xv.is_cuda:
        _no_grad_on_cuda("ssm_scan", *(t for t in (xv, logdecay, Bmat, Cmat,
                                                   h0) if t is not None))
        out = _ss.ssm_scan_cuda(xv, logdecay, Bmat, Cmat, h0, chunk=c)
        ssm_scan.launches += 1
        return out
    return _ss.ssm_scan_plain(xv, logdecay, Bmat, Cmat, h0, chunk=c)


flash_attention.launches = 0
flash_decode.launches = 0
ssm_scan.launches = 0
