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
    layer's ring full); with mamba layers (HYBRID or MAMBA), the SSD scan
    of a prefill in chunks of ``ssm_chunk`` (``serve``'s default).  An
    xLSTM stack runs none of them."""
    from repro_torch.configs.base import ATTN, HYBRID, MAMBA, SWA
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
    if any(k in (HYBRID, MAMBA) for k in cfg.blocks):
        # a Mamba-2 mixer's heads are its own, Hymba's the attention's
        nh, hd = (cfg.mamba_heads, cfg.mamba_head_dim) if cfg.mamba2 \
            else (h, d)
        shapes["ssm_scan"] = dict(B=batch, S=prompt_len, nh=nh, hd=hd,
                                  st=cfg.ssm_state,
                                  chunk=min(ssm_chunk, prompt_len))
        works["ssm_scan"] = ssm_scan.work
    return tuple(_structure(name, sh, works[name])
                 for name, sh in shapes.items())


def _structure(name: str, sh: dict, work):
    from repro_torch.core.kstruct import KernelStructure
    flops, nbytes = work(**sh)
    return KernelStructure.from_cuda_source(
        os.path.join(CSRC, f"{name}.cu"), name,
        dict(sh, flops=flops, bytes=nbytes))


def call_shapes(schema: str, args) -> tuple:
    """(kernel name, its ``work`` shapes) of one call of a kernel's custom
    op (``schema``: ``repro_torch::flash_attention``, ``::flash_decode``,
    ``::flash_decode_lse`` or ``::ssm_scan``) whose arguments are
    ``args``, each tensor given by its shape; None for another op.
    ``::moe_combine`` and ``::moe_uncombine`` are kernels of their own
    names."""
    name = schema.split("::")[-1]
    if name == "flash_attention":
        (B, S, H, D), Hkv = args[0], args[1][2]
        return "flash_attention", dict(B=B, S=S, H=H, Hkv=Hkv, D=D,
                                       window=int(args[4]))
    if name in ("flash_decode", "flash_decode_lse"):
        (B, H, D), Hkv = args[0], args[1][2]
        return "decode_attention", dict(B=B, H=H, Hkv=Hkv, D=D,
                                        length=int(args[3]))
    if name == "ssm_scan":
        B, S, nh, hd = args[0]
        return "ssm_scan", dict(B=B, S=S, nh=nh, hd=hd, st=args[2][-1],
                                chunk=int(args[5]))
    if name in ("moe_combine", "moe_uncombine"):
        eo, w = (args[1], args[3]) if name == "moe_uncombine" else \
            (args[0], args[2])
        return name, dict(T=w[0], k=w[1], d=eo[1], R=eo[0])
    return None


def work_of(kernel: str):
    from repro_torch.kernels import decode_attention, flash_attention, \
        moe_combine, ssm_scan
    return {"flash_attention": flash_attention.work,
            "decode_attention": decode_attention.work,
            "ssm_scan": ssm_scan.work,
            "moe_combine": moe_combine.work,
            "moe_uncombine": moe_combine.uncombine_work}[kernel]


def graph_structures(gm) -> tuple:
    """The interiors of the kernels a traced step (a recorded or exported
    ``torch.fx`` graph) launches, each at the shapes of its custom-call
    nodes: on a mesh, a rank's heads and its slice of a cache.
    Every call of a kernel in one step has one shape (each layer's); a
    kernel called at two shapes raises, as its structure binds to every
    custom-call of its name."""
    import torch
    shapes: dict = {}
    for node in gm.graph.nodes:
        schema = getattr(getattr(node.target, "_schema", None), "name", "")
        if not schema.startswith("repro_torch::"):
            continue
        got = call_shapes(schema, [a.meta["val"].shape if isinstance(
            a, torch.fx.Node) and a.meta.get("val") is not None else a
            for a in node.args])
        if got is None:
            continue
        name, sh = got
        if shapes.setdefault(name, sh) != sh:
            raise ValueError(f"graph_structures: {name} at {sh} and "
                             f"{shapes[name]} in one step")
    return tuple(_structure(name, sh, work_of(name))
                 for name, sh in shapes.items())
