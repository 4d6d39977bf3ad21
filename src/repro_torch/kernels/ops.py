"""Public wrappers around the Hopper kernels.

Each kernel is a ``torch.library.custom_op`` (``repro_torch::
flash_attention``, ``repro_torch::flash_decode``, ``repro_torch::
ssm_scan``) with two implementations: on a CUDA tensor it launches the
hand-written kernel (or raises: there is no fallback), on a CPU tensor it
runs the kernel's plain torch version.  ``register_fake`` gives shapes and
dtypes, so ``torch.export`` and ``make_fx`` record each kernel as one
opaque node (the ``custom-call`` of the port's program structure,
``core.export``) without running it.

The public wrappers keep their signatures and count launches in their
``launches`` attribute, bumped by the CUDA implementation where it
launches the kernel, so a run can show that its main path went through
the kernels; tracing through the fake implementation counts nothing.

Gradients, as in the JAX package (``repro/kernels/ops.py``), which has no
backward kernel: ``flash_attention`` and ``ssm_scan`` carry a backward
registered with ``torch.library.register_autograd`` that recomputes the
forward through the differentiable plain versions and takes their
``torch.autograd.grad`` (attention through ``models.attention.
chunked_attention`` with the same causal/window mask and q aligned at
position 0, the scan through ``ssm_scan_plain``).  So on the card the
forward is the kernel, its recompute under remat is the kernel again (a
counted launch), and the backward launches no kernel of the port.
``flash_decode`` is inference-only, as in the reference: a CUDA input
that requires grad raises ``NotImplementedError``.
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


# the recompute's blocks: the JAX wrapper's default block_q = block_kv
RECOMPUTE_CHUNK = 256


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


def _flash_attention_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _flash_attention_backward(ctx, dout):
    """Recompute the forward in plain torch and differentiate it (the JAX
    package's ``_flash_vjp_bwd``).  Causal only, as every caller is."""
    from repro_torch.models.attention import chunked_attention
    if not ctx.causal:
        raise NotImplementedError("flash_attention: the backward "
                                  "recomputes causal attention only")
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        out = chunked_attention(q, k, v, q_chunk=RECOMPUTE_CHUNK,
                                kv_chunk=RECOMPUTE_CHUNK, window=ctx.window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    return dq, dk, dv, None, None


_flash_attention_op.register_autograd(_flash_attention_backward,
                                      setup_context=_flash_attention_setup)


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


def _ssm_scan_setup(ctx, inputs, output):
    xv, logdecay, Bmat, Cmat, h0, chunk = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(xv, logdecay, Bmat, Cmat,
                          *((h0,) if ctx.has_h0 else ()))
    ctx.chunk = chunk


def _ssm_scan_backward(ctx, dy, dh):
    """Recompute the scan in plain torch and differentiate it (the JAX
    package's ``_ssm_vjp_bwd``); without h0 the scan starts from zeros and
    h0 gets no gradient."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        h0 = ins[4] if ctx.has_h0 else None
        y, h = _ss.ssm_scan_plain(*ins[:4], h0, chunk=ctx.chunk)
        outs, grads = zip(*[(o, g) for o, g in ((y, dy), (h, dh))
                            if g is not None])
        got = torch.autograd.grad(outs, ins, grads, allow_unused=True)
    got = [g if g is not None else torch.zeros_like(t)
           for g, t in zip(got, ins)]
    return (*got[:4], got[4] if ctx.has_h0 else None, None)


_ssm_scan_op.register_autograd(_ssm_scan_backward,
                               setup_context=_ssm_scan_setup)


# ---------------------------------------------------------------------------
# the public wrappers
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H,D).  Causal (+optional
    sliding window) GQA attention with q and k aligned at position 0.
    The Hopper kernel's tiles are fixed at compile time.  Differentiable:
    the backward recomputes through ``chunked_attention``."""
    return _flash_attention_op(q, k, v, bool(causal), int(window))


def flash_decode(q, k_cache, v_cache, length: int):
    """One-token decode attention against a KV cache (B,H,D) x
    (B,Smax,Hkv,D) -> (B,H,D).  ``length`` is a Python int (no device
    sync).  Inference-only: on CUDA, an input that requires grad
    raises."""
    if _needs_grad(q, k_cache, v_cache):
        if q.is_cuda:
            raise NotImplementedError(
                "flash_decode: the CUDA kernel is inference-only (the JAX "
                "package's decode kernel has no VJP either)")
        return _fd.flash_decode_plain(q, k_cache, v_cache, int(length))
    return _flash_decode_op(q, k_cache, v_cache, int(length))


def ssm_scan(xv, logdecay, Bmat, Cmat, h0=None, chunk: int = 256):
    """Chunkwise SSD scan.  xv (B,S,nh,hd), logdecay (B,S,nh), Bmat/Cmat
    (B,S,st), h0 (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd) in
    xv.dtype, h_final (B,nh,hd,st) fp32).  ``chunk`` is capped at S, as
    in the JAX wrapper.  Differentiable: the backward recomputes through
    ``ssm_scan_plain``."""
    c = min(int(chunk), xv.shape[1])
    return _ssm_scan_op(xv, logdecay, Bmat, Cmat, h0, c)


flash_attention.launches = 0
flash_decode.launches = 0
ssm_scan.launches = 0
