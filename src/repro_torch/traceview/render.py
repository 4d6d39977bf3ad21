"""Text-mode hpctraceviewer (paper §7): the depth×time trace view, a
depth selector line, and the Statistic panel, rendered as aligned text so
tests and examples can assert on it (same philosophy as core/viewer.py).

Each distinct context in the raster gets a glyph, assigned by descending
on-screen area so ``a`` is always the dominant context; idle pixels are
``.``.  The legend doubles as the Statistic panel when ``summary`` rows
are attached.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.trace import TraceData
from repro_torch.traceview.raster import IDLE, Raster, rasterize

GLYPHS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
OTHER = "#"       # contexts beyond the glyph alphabet


def _glyph_map(pixels: np.ndarray) -> dict:
    """gid -> glyph, by descending pixel area (ties: ascending gid)."""
    gids, counts = np.unique(pixels[pixels != IDLE], return_counts=True)
    order = np.lexsort((gids, -counts))
    return {int(gids[i]): (GLYPHS[rank] if rank < len(GLYPHS) else OTHER)
            for rank, i in enumerate(order)}


def render(raster: Raster, db, *, legend: bool = True,
           max_legend: int = 12) -> str:
    """The trace view: one row per line, one glyph per sample."""
    glyphs = _glyph_map(raster.pixels)
    span = raster.t1 - raster.t0
    lines = [f"TRACEVIEW  [{raster.t0}, {raster.t1})  span={span}ns  "
             f"depth={raster.depth}  {raster.pixels.shape[0]}x"
             f"{raster.pixels.shape[1]}"]
    label_w = max((len(s) for s in raster.labels), default=0)
    for row, label in enumerate(raster.labels):
        body = "".join(glyphs.get(int(g), ".") for g in raster.pixels[row])
        lines.append(f"{label:>{label_w}} |{body}|")
    if legend and glyphs:
        total = int((raster.pixels != IDLE).sum()) or 1
        lines.append("legend:")
        by_area = sorted(glyphs.items(),
                         key=lambda kv: (kv[1] == OTHER, GLYPHS.find(kv[1])))
        for gid, g in by_area[:max_legend]:
            area = int((raster.pixels == gid).sum())
            name = (db.frames[gid].pretty() if 0 <= gid < len(db.frames)
                    else f"ctx{gid}")
            lines.append(f"  {g} {area / total * 100:5.1f}%  {name}")
    return "\n".join(lines)


def depth_selector(max_depth: int, depth: int) -> str:
    """The depth selector widget: ``depth: 0 1 [2] 3 ...``."""
    cells = [f"[{d}]" if d == depth else f" {d} "
             for d in range(max_depth + 1)]
    return "depth: " + "".join(cells)


def statistic_panel(rows: Sequence[Tuple[str, float]],
                    title: str = "Statistic") -> str:
    """The trace view's Statistic tab as text (name, % of trace area)."""
    lines = [f"{title}:"]
    for name, frac in rows:
        lines.append(f"  {frac * 100:5.1f}%  {name}")
    return "\n".join(lines)


def render_view(lines: Sequence[TraceData], db, *,
                t0: Optional[int] = None, t1: Optional[int] = None,
                width: int = 120, height: int = 32, depth: int = 2,
                top: int = 8, max_depth: Optional[int] = None,
                pyramid=None, mode: str = "auto") -> str:
    """One-stop view: depth selector + raster + Statistic panel, the text
    analogue of one hpctraceviewer screen.

    With ``pyramid`` (a ``pyramid.TracePyramid``), both the raster and
    the Summary rows come from the tiles — O(tiles-touched) per
    zoom/pan instead of O(events) — and ``lines`` is ignored (pass
    None).  ``mode`` selects the raster estimator (``auto`` / ``exact``
    / ``dominant``, see ``TracePyramid.rasterize``)."""
    from repro_torch.traceview.raster import tree_depths
    from repro_torch.traceview.stats import summary
    depths = db.depths() if hasattr(db, "depths") else \
        tree_depths(np.asarray(db.parents, np.int64))
    if pyramid is not None:
        raster = pyramid.rasterize(db.parents, t0=t0, t1=t1, width=width,
                                   height=height, depth=depth,
                                   depths=depths, mode=mode)
    else:
        raster = rasterize(lines, db.parents, t0=t0, t1=t1, width=width,
                           height=height, depth=depth, depths=depths)
    if max_depth is None:
        max_depth = int(depths.max()) if len(depths) else 0
    rows = summary(lines, db, t0=raster.t0, t1=raster.t1, depth=depth,
                   top=top, depths=depths, pyramid=pyramid)
    return "\n".join([depth_selector(max_depth, depth),
                      render(raster, db),
                      statistic_panel(rows, title="Statistic (Summary)")])
