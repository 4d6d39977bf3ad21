"""hpctraceviewer-style rendering by *sampling* (paper §7).

The trace view never draws every event: for a W-pixel-wide window it
samples each trace line at W pixel-midpoint times and paints the calling
context active at that instant, projected to a chosen call-stack depth.
That makes rendering cost O(W log E) per line regardless of event count.

Everything here is vectorized: one ``np.searchsorted`` per line resolves
all W samples against the sorted event starts (the merge-time sort in
tracedb.py is what makes this legal), and the depth projection is a table
built once per raster with the same O(max_depth) parent-jump sweep the
aggregator uses — no per-event or per-sample Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cct import tree_depths
from repro_torch.core.trace import TraceData

__all__ = ["IDLE", "Raster", "ancestors_at_depth", "line_label",
           "rasterize", "sample_line", "tree_depths"]

IDLE = -1    # pixel value for "no event under this sample"


def sample_line(starts: np.ndarray, ends: np.ndarray, ctx: np.ndarray,
                samples: np.ndarray, *, emax: Optional[np.ndarray] = None,
                nested: Optional[bool] = None) -> np.ndarray:
    """Context id covering each sample midpoint (``IDLE`` where none) —
    the per-line sampling core shared by the per-event raster and the
    pyramid's exact mode.  ``emax`` (running max of ends) and ``nested``
    (whether any event overlaps an earlier one) are recomputed here when
    absent; the pyramid passes its stored copies so an exact re-render
    costs O(W log E) instead of O(E)."""
    starts = np.asarray(starts, np.int64)
    out = np.full(len(samples), IDLE, np.int64)
    if not len(starts):
        return out
    ends = np.asarray(ends, np.int64)
    cur = np.searchsorted(starts, samples, side="right") - 1
    if emax is None:
        emax = np.maximum.accumulate(ends)
    if nested is None:
        nested = len(starts) > 1 and bool((starts[1:] < emax[:-1]).any())
    if nested:
        # nested/overlapping events: when the latest-starting event has
        # ended, walk back to the latest-starting one still covering
        # the sample (the enclosing scope).  emax bounds the walk: no
        # cover exists once samples >= max end of all earlier events.
        while True:
            safe = np.maximum(cur, 0)
            need = (cur >= 0) & (samples >= ends[safe]) \
                & (samples < emax[safe])
            if not need.any():
                break
            cur[need] -= 1
    safe = np.maximum(cur, 0)
    covered = (cur >= 0) & (samples < ends[safe])
    gids = np.asarray(ctx, np.int64)[safe]
    out[covered] = gids[covered]
    return out


def ancestors_at_depth(parents: np.ndarray, depths: np.ndarray,
                       depth: int) -> np.ndarray:
    """gid -> its ancestor at the requested depth.  Nodes at or above the
    requested depth map to themselves — the same projection
    ``viewer.trace_statistic`` applies (chain[-depth], else the node)."""
    parents = np.asarray(parents, np.int64)
    cur = np.arange(len(parents), dtype=np.int64)
    while True:
        mask = depths[cur] > depth
        if not mask.any():
            break
        cur[mask] = parents[cur[mask]]
    return cur


def line_label(identity: dict) -> str:
    kind = identity.get("type", "cpu")
    idx = identity.get("thread" if kind == "cpu" else "stream", 0)
    return f"r{identity.get('rank', 0)}.{'t' if kind == 'cpu' else 's'}{idx}"


@dataclasses.dataclass
class Raster:
    pixels: np.ndarray          # (n_lines, width) int64 gid; IDLE = no event
    times: np.ndarray           # (width,) sample midpoints (ns)
    labels: List[str]           # per rendered line
    line_ids: np.ndarray        # rendered line -> source line index
    t0: int
    t1: int
    depth: int


def _pick_rows(n_lines: int, height: int) -> np.ndarray:
    """Row sampling under a pixel budget: the viewer draws at most
    ``height`` lines, evenly spaced over the identity-ordered lines."""
    if n_lines <= height:
        return np.arange(n_lines)
    return np.unique(np.linspace(0, n_lines - 1, height).round()
                     .astype(np.int64))


def rasterize(lines: Sequence[TraceData], parents: np.ndarray, *,
              t0: Optional[int] = None, t1: Optional[int] = None,
              width: int = 120, height: int = 32, depth: int = 2,
              depths: Optional[np.ndarray] = None) -> Raster:
    """Sample ``lines`` into a (height, width) grid of global ctx ids at
    the given call-stack depth.

    ``lines`` must be start-sorted per line (TraceDB views are); within a
    line, overlapping events resolve to the latest-starting one covering
    the sample, matching a per-thread timeline where nesting is reported
    by the innermost frame (enclosing events show through the gaps after
    a nested event ends).
    """
    parents = np.asarray(parents, np.int64)
    if t0 is None:
        # min, not starts[0]: pre-merge TraceData lines may be unsorted
        t0 = min((int(np.min(td.starts)) for td in lines if len(td.starts)),
                 default=0)
    if t1 is None:
        t1 = max((int(td.ends.max()) for td in lines if len(td.ends)),
                 default=t0 + 1)
    if t1 <= t0:
        t1 = t0 + 1
    if depths is None:
        depths = tree_depths(parents)
    anc = ancestors_at_depth(parents, depths, depth)
    rows = _pick_rows(len(lines), height)
    samples = t0 + (np.arange(width, dtype=np.float64) + 0.5) \
        * (t1 - t0) / width
    pixels = np.full((len(rows), width), IDLE, np.int64)
    for out_row, li in enumerate(rows):
        td = lines[li]
        if not len(td.starts):
            continue
        gids = sample_line(td.starts, td.ends, td.ctx, samples)
        valid = (gids >= 0) & (gids < len(parents))
        pixels[out_row, valid] = anc[gids[valid]]
    return Raster(pixels, samples, [line_label(lines[i].identity)
                                    for i in rows],
                  rows, int(t0), int(t1), depth)
