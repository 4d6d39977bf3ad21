"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) with
their plain torch versions and public wrappers (``ops``).

``kernel_structures`` recovers each kernel's interior (loops, inlined
scopes, source lines; ``core.kstruct``) from its CUDA source at a serving
path's shapes, for ``Profiler.register_kernel_structures`` to bind to the
kernel's ``custom-call`` op for fine-grained PC-sample attribution."""
from __future__ import annotations

import os

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


def kernel_structures(cfg, batch: int, prompt_len: int, max_len: int, *,
                      ssm_chunk: int = 64) -> tuple:
    """The interiors of the kernels a serving path of ``cfg`` runs, at its
    shapes: with attention layers, flash prefill over the prompt (the
    layers' window) and flash decode at a mid-generation length (a window
    layer's ring full); with mamba layers, the SSD scan of a prefill in
    chunks of ``ssm_chunk`` (``serve``'s default).  An xLSTM stack runs
    none of them."""
    from repro_torch.configs.base import ATTN, HYBRID, SWA
    from repro_torch.core.kstruct import KernelStructure
    from repro_torch.kernels import decode_attention, flash_attention, \
        ssm_scan
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window if any(k in (SWA, HYBRID) for k in cfg.blocks) \
        else 0
    length = prompt_len + (max_len - prompt_len) // 2
    if window:
        length = min(window, length)
    shapes, works = {}, {}
    if any(k in (ATTN, SWA, HYBRID) for k in cfg.blocks):
        shapes["flash_attention"] = dict(B=batch, S=prompt_len, H=h,
                                         Hkv=hkv, D=d, window=window)
        shapes["decode_attention"] = dict(B=batch, H=h, Hkv=hkv, D=d,
                                          length=length)
        works["flash_attention"] = flash_attention.work
        works["decode_attention"] = decode_attention.work
    if HYBRID in cfg.blocks:
        shapes["ssm_scan"] = dict(B=batch, S=prompt_len, nh=h, hd=d,
                                  st=cfg.ssm_state,
                                  chunk=min(ssm_chunk, prompt_len))
        works["ssm_scan"] = ssm_scan.work
    out = []
    for name, sh in shapes.items():
        flops, nbytes = works[name](**sh)
        out.append(KernelStructure.from_cuda_source(
            os.path.join(CSRC, f"{name}.cu"), name,
            dict(sh, flops=flops, bytes=nbytes)))
    return tuple(out)
