"""Public wrappers around the Hopper kernels.

Each kernel is a ``torch.library.custom_op`` (``repro_torch::
flash_attention``, ``repro_torch::flash_decode``, ``repro_torch::
ssm_scan``, ``repro_torch::moe_combine`` and its adjoint ``repro_torch::
moe_uncombine``) with two implementations: on a CUDA tensor it launches the
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
``moe_combine`` has no TPU kernel behind it and a backward kernel of its
own: its registered backward is ``moe_uncombine``, one launch.
``flash_decode`` is inference-only, as in the reference: a CUDA input
that requires grad raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels import decode_attention as _fd
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_combine as _mc
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


# the decode kernel with its log-sum-exp output (a cache split over its
# sequence merges the ranks' partial attentions by it): one launch of the
# same kernel, counted with ``flash_decode``'s
@torch.library.custom_op("repro_torch::flash_decode_lse", mutates_args=(),
                         device_types="cpu")
def _flash_decode_lse_op(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                         length: int) -> tuple[Tensor, Tensor]:
    return _fd.flash_decode_plain(q, k_cache, v_cache, length, with_lse=True)


@_flash_decode_lse_op.register_kernel("cuda")
def _(q, k_cache, v_cache, length):
    out = _fd.flash_decode_cuda(q, k_cache, v_cache, length, with_lse=True)
    flash_decode.launches += 1
    return out


@_flash_decode_lse_op.register_fake
def _(q, k_cache, v_cache, length):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


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


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=(),
                         device_types="cpu")
def _moe_combine_op(eo: Tensor, slot: Tensor, w: Tensor) -> Tensor:
    return _mc.moe_combine_plain(eo, slot, w)


@_moe_combine_op.register_kernel("cuda")
def _(eo, slot, w):
    out = _mc.moe_combine_cuda(eo, slot, w)
    moe_combine.launches += 1
    return out


@_moe_combine_op.register_fake
def _(eo, slot, w):
    return eo.new_empty((w.shape[0], eo.shape[1]), dtype=torch.float32)


def _combine_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _combine_backward(ctx, dy):
    """The combine's adjoint, a kernel of its own on the card."""
    eo, slot, w = ctx.saved_tensors
    d_eo, dw = moe_uncombine(dy, eo, slot, w)
    return d_eo, None, dw


_moe_combine_op.register_autograd(_combine_backward,
                                  setup_context=_combine_setup)


# the combine's adjoint; its name shares no substring with the combine's,
# since a kernel's interior binds to every custom-call whose name holds
# the kernel's
@torch.library.custom_op("repro_torch::moe_uncombine", mutates_args=(),
                         device_types="cpu")
def _moe_uncombine_op(dy: Tensor, eo: Tensor, slot: Tensor,
                      w: Tensor) -> tuple[Tensor, Tensor]:
    return _mc.moe_uncombine_plain(dy, eo, slot, w)


@_moe_uncombine_op.register_kernel("cuda")
def _(dy, eo, slot, w):
    out = _mc.moe_uncombine_cuda(dy, eo, slot, w)
    moe_uncombine.launches += 1
    return out


@_moe_uncombine_op.register_fake
def _(dy, eo, slot, w):
    return torch.empty_like(eo), torch.empty_like(w)


# ---------------------------------------------------------------------------
# the public wrappers
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k/v: (B,Sk,Hkv,D) -> (B,S,H,D).  Causal (+optional
    sliding window) GQA attention with q and k aligned at position 0.
    The Hopper kernel's tiles are fixed at compile time.  Differentiable:
    the backward recomputes through ``chunked_attention``."""
    return _flash_attention_op(q, k, v, bool(causal), int(window))


def flash_decode(q, k_cache, v_cache, length: int, with_lse: bool = False):
    """One-token decode attention against a KV cache (B,H,D) x
    (B,Smax,Hkv,D) -> (B,H,D).  ``length`` is a Python int (no device
    sync), 0 <= length <= Smax.  ``with_lse``: (out, the rows' (B,H) fp32
    log-sum-exp), for a merge across the ranks that hold parts of the
    sequence.  Inference-only: on CUDA, an input that requires grad
    raises."""
    if _needs_grad(q, k_cache, v_cache):
        if q.is_cuda:
            raise NotImplementedError(
                "flash_decode: the CUDA kernel is inference-only (the JAX "
                "package's decode kernel has no VJP either)")
        return _fd.flash_decode_plain(q, k_cache, v_cache, int(length),
                                      with_lse=with_lse)
    if with_lse:
        return _flash_decode_lse_op(q, k_cache, v_cache, int(length))
    return _flash_decode_op(q, k_cache, v_cache, int(length))


def ssm_scan(xv, logdecay, Bmat, Cmat, h0=None, chunk: int = 256):
    """Chunkwise SSD scan.  xv (B,S,nh,hd), logdecay (B,S,nh), Bmat/Cmat
    (B,S,st), h0 (B,nh,hd,st) or None.  Returns (y (B,S,nh,hd) in
    xv.dtype, h_final (B,nh,hd,st) fp32).  ``chunk`` is capped at S, as
    in the JAX wrapper.  Differentiable: the backward recomputes through
    ``ssm_scan_plain``."""
    c = min(int(chunk), xv.shape[1])
    return _ssm_scan_op(xv, logdecay, Bmat, Cmat, h0, c)


def moe_combine(eo, slot, w):
    """The MoE dispatch's gated combine: eo (R, d) the experts' output
    rows, slot (T*k,) int64 each assignment's row (R: the dump row, which
    adds nothing), w (T, k) fp32 the gates (0 where dropped) -> y (T, d)
    fp32, each token's slots summed in order.  Differentiable: the
    backward is ``moe_uncombine``."""
    return _moe_combine_op(eo, slot, w)


def moe_uncombine(dy, eo, slot, w):
    """The combine's adjoint: dy (T, d) fp32 and the combine's operands
    -> (d_eo (R, d) in eo's dtype, each kept slot's row written once,
    dw (T, k) fp32, 0 at the dump row)."""
    return _moe_uncombine_op(dy, eo, slot, w)


flash_attention.launches = 0
flash_decode.launches = 0
ssm_scan.launches = 0
moe_combine.launches = 0
moe_uncombine.launches = 0


# FLOPs of each kernel call as ``torch.utils.flop_counter`` counts them:
# the work the function needs (each module's ``work``), so a
# ``FlopCounterMode`` over a step counts the kernels beside the products
def _kernel_flops(schema: str):
    from repro_torch.kernels import call_shapes, work_of

    def formula(*args, out_shape=None, **kwargs):
        # the counter hands each tensor argument over as its shape
        name, sh = call_shapes(schema, args)
        return int(work_of(name)(**sh)[0])
    return formula


def _register_flop_formulas():
    from torch.utils.flop_counter import register_flop_formula
    for name in ("flash_attention", "flash_decode", "flash_decode_lse",
                 "ssm_scan", "moe_combine", "moe_uncombine"):
        register_flop_formula(getattr(torch.ops.repro_torch, name))(
            _kernel_flops(f"repro_torch::{name}"))


_register_flop_formulas()
