"""Pre-raster trace filters (hpctraceviewer's filter dialog): keep only
selected ranks / threads / streams, a time window, and/or the events
whose calling context lies under a chosen subtree of the global CCT.

Filters narrow the line set and event arrays *before* sampling, so a
filtered raster of a 1M-event database costs only the surviving events.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.trace import TraceData
from repro_torch.traceview.raster import ancestors_at_depth, tree_depths


@dataclasses.dataclass
class TraceFilter:
    ranks: Optional[Set[int]] = None       # keep these ranks
    types: Optional[Set[str]] = None       # {"cpu", "gpu"}
    threads: Optional[Set[int]] = None     # CPU thread indices
    streams: Optional[Set[int]] = None     # GPU stream ids
    t0: Optional[int] = None               # window start (inclusive)
    t1: Optional[int] = None               # window end (exclusive)
    subtree: Optional[int] = None          # global ctx id: keep descendants

    def keeps_line(self, identity: dict) -> bool:
        if self.ranks is not None \
                and int(identity.get("rank", 0)) not in self.ranks:
            return False
        kind = identity.get("type", "cpu")
        if self.types is not None and kind not in self.types:
            return False
        if kind == "cpu" and self.threads is not None \
                and int(identity.get("thread", 0)) not in self.threads:
            return False
        if kind == "gpu" and self.streams is not None \
                and int(identity.get("stream", 0)) not in self.streams:
            return False
        return True


def subtree_mask(parents: np.ndarray, root_gid: int) -> np.ndarray:
    """Boolean (n_ctx,) — True for ``root_gid`` and its descendants,
    via the same vectorized ancestor projection the raster uses."""
    parents = np.asarray(parents, np.int64)
    depths = tree_depths(parents)
    anc = ancestors_at_depth(parents, depths, int(depths[root_gid]))
    return anc == root_gid


def apply_filter(lines: Sequence[TraceData], flt: TraceFilter,
                 parents: Optional[np.ndarray] = None) -> List[TraceData]:
    """Filtered per-line TraceData views.  Lines failing the identity
    predicates are dropped; events outside the window or subtree are
    masked out (a subtree filter needs ``parents``), and events
    straddling a window edge are *clipped* to [t0, t1) — so a
    downstream default-window ``summary``/``rasterize`` stays inside
    the filter window instead of expanding over a straddler's full
    extent (the pre-clip behavior silently counted out-of-window time).
    """
    keep_ctx = None
    if flt.subtree is not None:
        if parents is None:
            raise ValueError("subtree filter requires the CCT parents")
        keep_ctx = subtree_mask(parents, flt.subtree)
    out: List[TraceData] = []
    for td in lines:
        if not flt.keeps_line(td.identity):
            continue
        starts = np.asarray(td.starts, np.int64)
        ends = np.asarray(td.ends, np.int64)
        ctx = np.asarray(td.ctx, np.int64)
        sel = np.ones(len(starts), bool)
        if flt.t0 is not None:
            sel &= ends > flt.t0
        if flt.t1 is not None:
            sel &= starts < flt.t1
        if keep_ctx is not None:
            valid = (ctx >= 0) & (ctx < len(keep_ctx))
            sel &= valid & keep_ctx[np.clip(ctx, 0, len(keep_ctx) - 1)]
        clip_lo = flt.t0 if flt.t0 is not None else np.iinfo(np.int64).min
        clip_hi = flt.t1 if flt.t1 is not None else np.iinfo(np.int64).max
        if sel.all() and (not len(starts) or (
                starts.min() >= clip_lo and ends.max() <= clip_hi)):
            out.append(td)
        else:
            out.append(TraceData(td.identity,
                                 np.clip(starts[sel], clip_lo, clip_hi),
                                 np.clip(ends[sel], clip_lo, clip_hi),
                                 ctx[sel]))
    return out
