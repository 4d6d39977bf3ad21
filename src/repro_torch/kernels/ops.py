"""Public wrappers around the Hopper kernels (forward only).

Each kernel is a ``torch.library.custom_op`` (``repro_torch::
flash_attention``, ``repro_torch::flash_decode``, ``repro_torch::
ssm_scan``) with two implementations: on a CUDA tensor it launches the
hand-written kernel (or raises: there is no fallback), on a CPU tensor it
runs the kernel's plain torch version.  ``register_fake`` gives shapes and
dtypes, so ``torch.export`` records each kernel as one opaque node (the
``custom-call`` of the port's program structure, ``core.export``) without
running it.

The public wrappers keep their signatures and count launches in their
``launches`` attribute, bumped by the CUDA implementation where it
launches the kernel, so a run can show that its main path went through
the kernels; tracing through the fake implementation counts nothing.
The backward passes come with the training slice: a CUDA input that
requires grad raises ``NotImplementedError``, and a CPU input that
requires grad runs the plain version directly, which autograd
differentiates (the ops have no backward of their own).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssm_scan as _ss


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_grad_on_cuda(what: str, *tensors: torch.Tensor) -> None:
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{what}: the CUDA kernel is forward-only; the backward comes "
            f"with the training slice")


# ---------------------------------------------------------------------------
# the custom ops: CPU = plain version, CUDA = the kernel
# ---------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                        window: int) -> Tensor:
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)


@_flash_attention_op.register_kernel("cuda")
def _(q, k, v, causal, window):
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


@_flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         device_types="cpu")
def _flash_decode_op(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     length: int) -> Tensor:
    return _fd.flash_decode_plain(q, k_cache, v_cache, length)


@_flash_decode_op.register_kernel("cuda")
def _(q, k_cache, v_cache, length):
    out = _fd.flash_decode_cuda(q, k_cache, v_cache, length)
    flash_decode.launches += 1
    return out


@_flash_decode_op.register_fake
def _(q, k_cache, v_cache, length):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=(),
                         device_types="cpu")
def _ssm_scan_op(xv: Tensor, logdecay: Tensor, Bmat: Tensor, Cmat: Tensor,
                 h0: Optional[Tensor], chunk: int) -> tuple[Tensor, Tensor]:
    return _ss.ssm_scan_plain(xv, logdecay, Bmat, Cmat, h0, chunk=chunk)


@_ssm_scan_op.register_kernel("cuda")
def _(xv, logdecay, Bmat, Cmat, h0, chunk):
    out = _ss.ssm_scan_cuda(xv, logdecay, Bmat, Cmat, h0, chunk=chunk)
    ssm_scan.launches += 1
    return out


@_ssm_scan_op.register_fake
def _(xv, logdecay, Bmat, Cmat, h0, chunk):
    B, _, nh, hd = xv.shape
    return (torch.empty_like(xv),
            xv.new_empty((B, nh, hd, Bmat.shape[-1]), dtype=torch.float32))


# ---------------------------------------------------------------------------
# the public wrappers
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H,D).  Causal (+optional
    sliding window) GQA attention with q and k aligned at position 0.
    The Hopper kernel's tiles are fixed at compile time."""
    if q.is_cuda:
        _no_grad_on_cuda("flash_attention", q, k, v)
    elif _needs_grad(q, k, v):
        return _fa.flash_attention_plain(q, k, v, causal=bool(causal),
                                         window=int(window))
    return _flash_attention_op(q, k, v, bool(causal), int(window))


def flash_decode(q, k_cache, v_cache, length: int):
    """One-token decode attention against a KV cache (B,H,D) x
    (B,Smax,Hkv,D) -> (B,H,D).  ``length`` is a Python int (no device
    sync)."""
    if q.is_cuda:
        _no_grad_on_cuda("flash_decode", q, k_cache, v_cache)
    elif _needs_grad(q, k_cache, v_cache):
        return _fd.flash_decode_plain(q, k_cache, v_cache, int(length))
    return _flash_decode_op(q, k_cache, v_cache, int(length))


def ssm_scan(xv, logdecay, Bmat, Cmat, h0=None, chunk: int = 256):
    """Chunkwise SSD scan.  xv (B,S,nh,hd), logdecay (B,S,nh), Bmat/Cmat
    (B,S,st), h0 (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd) in
    xv.dtype, h_final (B,nh,hd,st) fp32).  ``chunk`` is capped at S, as
    in the JAX wrapper."""
    c = min(int(chunk), xv.shape[1])
    tensors = [t for t in (xv, logdecay, Bmat, Cmat, h0) if t is not None]
    if xv.is_cuda:
        _no_grad_on_cuda("ssm_scan", *tensors)
    elif _needs_grad(*tensors):
        return _ss.ssm_scan_plain(xv, logdecay, Bmat, Cmat, h0, chunk=c)
    return _ssm_scan_op(xv, logdecay, Bmat, Cmat, h0, c)


flash_attention.launches = 0
flash_decode.launches = 0
ssm_scan.launches = 0
