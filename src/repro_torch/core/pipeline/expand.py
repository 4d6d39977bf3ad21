"""Phase 3 — calling-context expansion (paper §6.1).

Flat GPU-op frames are expanded against hpcstruct-analogue structure
files (lines / loops / inlined scopes).  Profiles measured with runtime
expansion skip this (see profiler.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.cct import Frame
from repro_torch.core.profmt import ProfileData
from repro_torch.core.structure import HloModule


def make_expander(structures: Dict[str, HloModule]):
    """Returns expand(frame, prof) -> [Frame, ...] using structure files."""
    cache: Dict[Tuple[str, int], tuple] = {}

    def expand(frame: Frame, prof: ProfileData):
        mod = structures.get(frame.module)
        if mod is None:
            return (frame,)
        key = (frame.module, frame.line)   # line == op index for GPU_OP
        frames = cache.get(key)
        if frames is None:
            ops = mod.all_ops()
            if frame.line < len(ops):
                frames = tuple(mod.op_context(ops[frame.line]))
            else:
                frames = (frame,)
            cache[key] = frames
        return frames

    return expand
