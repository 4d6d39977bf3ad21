"""Multi-resolution trace tile pyramid — O(tile) zoom/pan over a merged
``trace.db`` (ISSUE 9 tentpole; "Preparing for Performance Analysis at
Exascale" and the exascale-diagnostics framework paper make interactivity
at extreme event counts the design goal).

Every traceview query used to re-scan the merged event arrays per render
— O(events) work repeated on every zoom/pan, untenable at billion-event
databases.  The pyramid precomputes, per trace line, depth x time mip
levels over power-of-two time bins and stores them in one mmap-backed
``trace.pyr`` file next to the ``trace.db`` it summarizes:

- **context-profile tiles** (per level, per bin): sparse
  ``(ctx, busy-ns)`` pairs — each event's overlap clipped at bin edges.
  Because per-context occupied time is *additive over any partition of
  the time axis* (and durations are integer ns, exact in float64), any
  ``[t0, t1)`` window decomposes into O(log) whole tiles plus two
  sub-bin residuals refined per-event at the finest level — the answers
  are **bitwise-equal** to the per-event scan.
- **busy tiles** (per level, per bin): union-coverage ns of the line's
  events per bin — the ``stats.occupancy`` / idle-fraction primitive,
  additive the same way.
- **dominant-context tiles** (per call-stack depth, per level, per bin):
  the context (projected to that depth) with the most covered time in
  the bin, or idle — the O(1)-per-pixel overview raster.
- **finest-level refinement data** (per line): the running-max event end
  (``emax``) and the nested-overlap flag, which is exactly the per-render
  O(events) precomputation ``raster.rasterize`` used to redo every call.
  With it stored, *exact* midpoint-sample rasters cost O(width log E).

Determinism contract: ``trace.pyr`` bytes are a pure function of the
``trace.db`` bytes and the CCT parent array (canonical header JSON +
canonically ordered tiles; rebuild == rebuild, pinned in
tests/test_pyramid.py), matching every other artifact in the repo.  The
header records digests of both inputs, so the lazy cache
(``ensure_pyramid``) detects staleness without touching event data.

Layout::

    MAGIC "RPYR" | u32 version | u64 header_len | header JSON | pad to 64
    int64 data[]   (per line: emax, then per level: busy | tile offsets |
                    ctx pairs | ns pairs | dominant[depth x bins])

Exactness contract (docs/traceview.md): ``interval_profile`` / ``summary``
/ ``occupancy`` tile answers are bitwise-equal to the per-event path for
*any* window; rasters are bitwise-equal in ``exact`` mode (and in
``auto`` mode once a pixel is narrower than the finest bin), while
coarse ``auto``/``dominant`` rasters paint the dominant context per
pixel — a deliberate, documented estimator change for zoomed-out views.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cct import tree_depths
from repro_torch.traceview.raster import (IDLE, Raster, ancestors_at_depth,
                                    _pick_rows, line_label, sample_line)
from repro_torch.traceview.tracedb import TraceDB, _HDR as _DB_HDR

MAGIC = b"RPYR"
VERSION = 1
_ALIGN = 64
_HDR = struct.Struct("<4sIQ")    # magic, version, header json length

# default finest-level sizing: one bin per ~TARGET_EVENTS_PER_BIN events,
# clamped to [MIN_BINS, MAX_BINS] — a pure function of the database
TARGET_EVENTS_PER_BIN = 256
MIN_BINS_LOG2 = 4                # 16 bins
MAX_BINS_LOG2 = 12               # 4096 bins
MAX_DOMINANT_DEPTH = 32          # deeper trees fall back to exact rasters


# --------------------------------------------------------------------------
# build helpers
# --------------------------------------------------------------------------
def _default_bins(n_events: int) -> int:
    k = max(1, n_events // TARGET_EVENTS_PER_BIN).bit_length()
    return 1 << max(MIN_BINS_LOG2, min(MAX_BINS_LOG2, k))


def _group_sum(keys_a: np.ndarray, keys_b: np.ndarray, vals: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sum ``vals`` grouped by the (a, b) key pair; groups come back
    lexsorted by (a, b) — the canonical tile order."""
    order = np.lexsort((keys_b, keys_a))
    a, b, v = keys_a[order], keys_b[order], vals[order]
    if not len(a):
        return a, b, v.astype(np.int64)
    new = np.ones(len(a), bool)
    new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    idx = np.flatnonzero(new)
    return a[idx], b[idx], np.add.reduceat(v, idx).astype(np.int64)


def _event_bin_segments(starts: np.ndarray, ends: np.ndarray,
                        ctx: np.ndarray, t_min: int, w0: int, n_bins: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split events at finest-bin boundaries: (bin, ctx, overlap-ns)
    per segment, overlaps clipped at bin edges."""
    dur = ends - starts
    keep = dur > 0
    s, e, c = starts[keep], ends[keep], ctx[keep]
    if not len(s):
        z = np.zeros(0, np.int64)
        return z, z, z
    b_first = (s - t_min) // w0
    b_last = (e - 1 - t_min) // w0
    b_first = np.clip(b_first, 0, n_bins - 1)
    b_last = np.clip(b_last, 0, n_bins - 1)
    counts = b_last - b_first + 1
    total = int(counts.sum())
    rep = np.repeat(np.arange(len(s)), counts)
    base = np.zeros(len(s), np.int64)
    np.cumsum(counts[:-1], out=base[1:])
    seg_bin = b_first[rep] + (np.arange(total) - base[rep])
    bin_lo = t_min + seg_bin * w0
    ov = np.minimum(e[rep], bin_lo + w0) - np.maximum(s[rep], bin_lo)
    sel = ov > 0
    return seg_bin[sel], c[rep][sel], ov[sel]


def _merged_coverage(starts: np.ndarray, ends: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint union intervals of start-sorted events (the
    ``stats.merge_intervals`` sweep without the re-sort)."""
    if not len(starts):
        return starts, ends
    emax = np.maximum.accumulate(ends)
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > emax[:-1]
    idx = np.flatnonzero(new)
    return starts[idx], np.maximum.reduceat(ends, idx)


def _coverage_per_bin(m_s: np.ndarray, m_e: np.ndarray,
                      edges: np.ndarray) -> np.ndarray:
    """Union-covered ns between consecutive ``edges`` (int64 exact)."""
    if not len(m_s):
        return np.zeros(len(edges) - 1, np.int64)
    dur = m_e - m_s
    cum = np.concatenate([[0], np.cumsum(dur)])
    idx = np.searchsorted(m_s, edges, side="right")
    safe = np.maximum(idx - 1, 0)
    partial = np.clip(edges - m_s[safe], 0, dur[safe]) * (idx > 0)
    return np.diff(cum[safe] * (idx > 0) + partial).astype(np.int64)


def _dominant_tiles(bins: np.ndarray, proj: np.ndarray, ns: np.ndarray,
                    busy: np.ndarray, spans: np.ndarray) -> np.ndarray:
    """Per bin: the projected context with the most covered ns, ties to
    the smallest ctx id; ``IDLE`` when the bin's idle time
    (in-data-range span minus union busy) beats every context."""
    n_bins = len(busy)
    dom = np.full(n_bins, IDLE, np.int64)
    best = np.zeros(n_bins, np.int64)
    if len(bins):
        b, p, v = _group_sum(bins, proj, ns)
        first = np.ones(len(b), bool)
        first[1:] = b[1:] != b[:-1]
        starts_idx = np.flatnonzero(first)
        bmax = np.maximum.reduceat(v, starts_idx)
        ub = b[starts_idx]
        best[ub] = bmax
        # winner: first (smallest-proj) group reaching its bin's max
        pos = np.searchsorted(ub, b)
        win = np.flatnonzero(v == bmax[pos])
        wb, wfirst = np.unique(b[win], return_index=True)
        dom[wb] = p[win[wfirst]]
    idle = np.maximum(spans - busy, 0)
    dom[idle > best] = IDLE
    return dom


def _tile_cover(b0: int, b1: int, n_levels: int) -> List[Tuple[int, int]]:
    """Maximal aligned power-of-two tiles covering finest-bin range
    [b0, b1): at most 2*(n_levels-1) tiles, greedily by alignment."""
    out: List[Tuple[int, int]] = []
    while b0 < b1:
        lev = (b0 & -b0).bit_length() - 1 if b0 else n_levels - 1
        lev = min(lev, n_levels - 1)
        while (1 << lev) > b1 - b0:
            lev -= 1
        out.append((lev, b0 >> lev))
        b0 += 1 << lev
    return out


def _db_header_sha(db_path: str) -> str:
    """Digest of the trace.db header block (magic + version + canonical
    JSON): changes whenever the line set, counts, offsets, or time range
    change — the cheap staleness signal for the lazy cache."""
    with open(db_path, "rb") as f:
        raw = f.read(_DB_HDR.size)
        _, _, hdr_len = _DB_HDR.unpack(raw)
        return hashlib.sha256(raw + f.read(hdr_len)).hexdigest()


def _parents_sha(parents: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(parents, np.int64)
                             .astype("<i8")).tobytes()).hexdigest()


# --------------------------------------------------------------------------
# builder
# --------------------------------------------------------------------------
def pyramid_path_for(db_path: str) -> str:
    base, _ = os.path.splitext(db_path)
    return base + ".pyr"


def build_pyramid(source: Union[str, TraceDB], parents: np.ndarray,
                  out_path: Optional[str] = None, *,
                  bins: Optional[int] = None) -> "TracePyramid":
    """Build ``trace.pyr`` from a merged ``trace.db`` and the database's
    CCT parent array.  Output bytes are a pure function of the two
    inputs (staged temp + atomic rename, like every artifact)."""
    own = isinstance(source, str)
    tdb = TraceDB(source) if own else source
    try:
        parents = np.asarray(parents, np.int64)
        depths = tree_depths(parents)
        max_depth = int(depths.max()) if len(depths) else 0
        dom_depth = min(max_depth, MAX_DOMINANT_DEPTH)
        anc = np.stack([ancestors_at_depth(parents, depths, d)
                        for d in range(dom_depth + 1)]) \
            if len(parents) else np.zeros((1, 0), np.int64)

        t_min, t_max = tdb.t_min, tdb.t_max
        n_bins = bins if bins else _default_bins(tdb.n_events)
        if n_bins & (n_bins - 1):
            raise ValueError(f"bins must be a power of two, got {n_bins}")
        w0 = max(1, -((t_min - t_max) // n_bins))     # ceil(span / n_bins)
        n_levels = n_bins.bit_length()                # levels 0..log2(B0)
        edges0 = t_min + np.arange(n_bins + 1, dtype=np.int64) * w0
        spans0 = np.diff(np.clip(edges0, t_min, max(t_max, t_min)))

        chunks: List[np.ndarray] = []
        offset = 0

        def put(arr: np.ndarray) -> int:
            nonlocal offset
            arr = np.ascontiguousarray(arr, np.int64)
            chunks.append(arr)
            off = offset
            offset += arr.size
            return off

        line_index = []
        n_ctx = len(parents)
        for i in range(len(tdb)):
            s = np.asarray(tdb.starts(i), np.int64)
            e = np.asarray(tdb.ends(i), np.int64)
            c = np.asarray(tdb.ctx(i), np.int64)
            emax = np.maximum.accumulate(e) if len(e) else e
            nested = len(s) > 1 and bool((s[1:] < emax[:-1]).any())
            entry = {
                "identity": tdb.lines[i].identity,
                "count": len(s),
                "t0": int(s[0]) if len(s) else 0,
                "t1": int(emax[-1]) if len(e) else 0,
                "nested": nested,
                "emax": put(emax),
                "levels": [],
            }
            seg_bin, seg_ctx, seg_ns = _event_bin_segments(
                s, e, c, t_min, w0, n_bins)
            pb, pc, pv = _group_sum(seg_bin, seg_ctx, seg_ns)
            m_s, m_e = _merged_coverage(s, e)
            busy = _coverage_per_bin(m_s, m_e, edges0)
            # per-depth projected pairs, coarsened level by level
            valid = (pc >= 0) & (pc < n_ctx)
            dom_pairs = [(pb[valid], anc[d][pc[valid]], pv[valid])
                         for d in range(dom_depth + 1)]
            spans = spans0
            n_l = n_bins
            for lev in range(n_levels):
                if lev:
                    n_l //= 2
                    pb, pc, pv = _group_sum(pb // 2, pc, pv)
                    busy = busy[0::2] + busy[1::2]
                    spans = spans[0::2] + spans[1::2]
                    dom_pairs = [_group_sum(db_ // 2, dc, dv)
                                 for db_, dc, dv in dom_pairs]
                toff = np.zeros(n_l + 1, np.int64)
                np.cumsum(np.bincount(pb, minlength=n_l), out=toff[1:])
                dom = np.concatenate(
                    [_dominant_tiles(db_, dc, dv, busy, spans)
                     for db_, dc, dv in dom_pairs]) \
                    if dom_pairs else np.zeros(0, np.int64)
                entry["levels"].append({
                    "bins": n_l,
                    "busy": put(busy),
                    "toff": put(toff),
                    "ctx": put(pc),
                    "ns": put(pv),
                    "pairs": int(len(pc)),
                    "dom": put(dom),
                })
            line_index.append(entry)

        header = json.dumps(
            {"version": VERSION, "t_min": t_min, "t_max": t_max,
             "bin_ns": int(w0), "n_bins": int(n_bins),
             "n_levels": int(n_levels), "max_depth": int(dom_depth),
             "n_ctx": int(n_ctx),
             "source": {"db_header_sha256": _db_header_sha(tdb.path),
                        "n_events": tdb.n_events},
             "parents_sha256": _parents_sha(parents),
             "lines": line_index},
            sort_keys=True, separators=(",", ":")).encode()
        if out_path is None:
            out_path = pyramid_path_for(tdb.path)
        tmp = out_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(MAGIC, VERSION, len(header)))
            f.write(header)
            pos = _HDR.size + len(header)
            f.write(b"\0" * (-pos % _ALIGN))
            for arr in chunks:
                f.write(arr.astype("<i8").tobytes())
        os.replace(tmp, out_path)
    finally:
        if own:
            tdb.close()
    return TracePyramid(out_path)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PyramidLine:
    identity: dict
    count: int
    t0: int
    t1: int
    nested: bool
    emax: int                 # element offset of the running-max array
    levels: List[dict]


class TracePyramid:
    """Memory-mapped ``trace.pyr`` reader + the tile-backed query layer.

    Opens the sibling ``trace.db`` lazily (only the sub-bin residual
    refinements and exact rasters touch event data).  Context manager:
    ``close()`` releases both mappings."""

    def __init__(self, path: str, tracedb: Optional[TraceDB] = None):
        self.path = path
        with open(path, "rb") as f:
            magic, version, hdr_len = _HDR.unpack(f.read(_HDR.size))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a trace.pyr (bad magic)")
            if version != VERSION:
                raise ValueError(f"{path}: unsupported version {version}")
            hdr = json.loads(f.read(hdr_len))
        data_offset = (_HDR.size + hdr_len + _ALIGN - 1) // _ALIGN * _ALIGN
        self.t_min: int = hdr["t_min"]
        self.t_max: int = hdr["t_max"]
        self.bin_ns: int = hdr["bin_ns"]
        self.n_bins: int = hdr["n_bins"]
        self.n_levels: int = hdr["n_levels"]
        self.max_depth: int = hdr["max_depth"]
        self.n_ctx: int = hdr["n_ctx"]
        self.source: dict = hdr["source"]
        self.parents_sha256: str = hdr["parents_sha256"]
        self.lines: List[PyramidLine] = [
            PyramidLine(ln["identity"], ln["count"], ln["t0"], ln["t1"],
                        ln["nested"], ln["emax"], ln["levels"])
            for ln in hdr["lines"]]
        n_elems = (os.path.getsize(path) - data_offset) // 8
        self._data: Optional[np.ndarray] = np.memmap(
            path, np.int64, mode="r", offset=data_offset,
            shape=(n_elems,)) if n_elems else np.zeros(0, np.int64)
        self._tdb = tracedb
        self._own_tdb = tracedb is None
        self._cum_busy: Dict[int, np.ndarray] = {}
        self._occ_idx: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        data, self._data = self._data, None
        if isinstance(data, np.memmap):
            data._mmap.close()
        if self._own_tdb and self._tdb is not None:
            self._tdb.close()
        self._tdb = None
        self._cum_busy.clear()
        self._occ_idx.clear()

    def __enter__(self) -> "TracePyramid":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.lines)

    @property
    def tdb(self) -> TraceDB:
        if self._tdb is None:
            if self._data is None:
                raise ValueError(f"{self.path}: pyramid is closed")
            self._tdb = TraceDB(os.path.splitext(self.path)[0] + ".db")
        return self._tdb

    def line_index(self, identity: dict) -> int:
        """Pyramid line index of a trace-line identity (KeyError when
        the identity is not in this pyramid)."""
        idx = getattr(self, "_line_idx", None)
        if idx is None:
            idx = {json.dumps(ln.identity, sort_keys=True): i
                   for i, ln in enumerate(self.lines)}
            self._line_idx = idx
        return idx[json.dumps(identity, sort_keys=True)]

    def _arr(self, off: int, n: int) -> np.ndarray:
        if self._data is None:
            raise ValueError(f"{self.path}: pyramid is closed")
        return self._data[off:off + n]

    # -- raw tile access ---------------------------------------------------
    def emax(self, i: int) -> np.ndarray:
        ln = self.lines[i]
        return self._arr(ln.emax, ln.count)

    def busy_tiles(self, i: int, level: int) -> np.ndarray:
        lv = self.lines[i].levels[level]
        return self._arr(lv["busy"], lv["bins"])

    def ctx_tiles(self, i: int, level: int, b0: int,
                  b1: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse (ctx, ns) pairs of the tile range [b0, b1) (one tile
        when ``b1`` is omitted) — one contiguous slice of the level's
        pair arrays."""
        lv = self.lines[i].levels[level]
        toff = self._arr(lv["toff"], lv["bins"] + 1)
        lo, hi = int(toff[b0]), int(toff[b0 + 1 if b1 is None else b1])
        return (self._arr(lv["ctx"] + lo, hi - lo),
                self._arr(lv["ns"] + lo, hi - lo))

    def dominant_tiles(self, i: int, level: int, depth: int) -> np.ndarray:
        lv = self.lines[i].levels[level]
        d = min(max(depth, 0), self.max_depth)
        return self._arr(lv["dom"] + d * lv["bins"], lv["bins"])

    # -- selection ---------------------------------------------------------
    def select(self, flt=None, parents=None
               ) -> Tuple[List[int], Optional[np.ndarray],
                          Optional[int], Optional[int]]:
        """Compose a ``TraceFilter`` with tile selection: line indices
        surviving the identity predicates, the subtree ctx mask (or
        None), and the filter's time window — whole lines and whole tile
        ranges are pruned before any event is touched."""
        if flt is None:
            return list(range(len(self.lines))), None, None, None
        line_ids = [i for i, ln in enumerate(self.lines)
                    if flt.keeps_line(ln.identity)]
        ctx_mask = None
        if flt.subtree is not None:
            from repro_torch.traceview.filter import subtree_mask
            if parents is None:
                raise ValueError("subtree filter requires the CCT parents")
            ctx_mask = subtree_mask(parents, flt.subtree)
        return line_ids, ctx_mask, flt.t0, flt.t1

    def line_range(self, lines: Optional[Sequence[int]] = None
                   ) -> Tuple[int, int]:
        """Default query window over the selected lines: (min first
        start, max end) — what the per-event default windows compute."""
        ids = range(len(self.lines)) if lines is None else lines
        t0 = min((self.lines[i].t0 for i in ids if self.lines[i].count),
                 default=0)
        t1 = max((self.lines[i].t1 for i in ids if self.lines[i].count),
                 default=t0)
        return t0, t1

    # -- window decomposition ---------------------------------------------
    def _window_tiles(self, t0: int, t1: int
                      ) -> Tuple[List[Tuple[int, int]],
                                 List[Tuple[int, int]]]:
        """Decompose [t0, t1) into aligned tiles + sub-bin residual
        ranges.  Clips to the grid; returns (tiles, residuals)."""
        grid_end = self.t_min + self.n_bins * self.bin_ns
        t0 = max(int(t0), self.t_min)
        t1 = min(int(t1), grid_end)
        if t1 <= t0:
            return [], []
        w0 = self.bin_ns
        b_lo = -((self.t_min - t0) // w0)             # ceil
        b_hi = (t1 - self.t_min) // w0                # floor
        if b_lo > b_hi:                                # inside one bin
            return [], [(t0, t1)]
        residuals = []
        a = self.t_min + b_lo * w0
        b = self.t_min + b_hi * w0
        if t0 < a:
            residuals.append((t0, a))
        if b < t1:
            residuals.append((b, t1))
        # coalesce same-level neighbours into runs: one contiguous
        # (ctx, ns) slice per run instead of one read per tile
        runs: List[List[int]] = []
        for lev, tb in _tile_cover(b_lo, b_hi, self.n_levels):
            if runs and runs[-1][0] == lev and runs[-1][2] == tb:
                runs[-1][2] = tb + 1
            else:
                runs.append([lev, tb, tb + 1])
        return [tuple(r) for r in runs], residuals

    def _refine_profile(self, i: int, a: int, b: int, out: np.ndarray,
                        ctx_mask: Optional[np.ndarray]) -> None:
        """Per-event scatter-add of overlaps with [a, b) — the finest-
        level refinement, pruned by the stored running-max ends."""
        tdb = self.tdb
        s = tdb.starts(i)
        if not len(s):
            return
        hi = int(np.searchsorted(s, b, side="left"))
        lo = int(np.searchsorted(self.emax(i)[:hi], a, side="right"))
        e = tdb.ends(i)[lo:hi]
        ov = np.minimum(e, b) - np.maximum(s[lo:hi], a)
        sel = ov > 0
        ctx = tdb.ctx(i)[lo:hi][sel]
        n_ctx = len(out)
        valid = (ctx >= 0) & (ctx < n_ctx)
        if ctx_mask is not None:
            keep = valid & ctx_mask[np.clip(ctx, 0, n_ctx - 1)]
            np.add.at(out, ctx[keep], ov[sel][keep].astype(np.float64))
        else:
            np.add.at(out, np.where(valid, ctx, 0),
                      ov[sel].astype(np.float64))

    # -- queries -----------------------------------------------------------
    def interval_profile(self, n_ctx: int, t0: int, t1: int, *,
                         lines: Optional[Sequence[int]] = None,
                         ctx_mask: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """(n_ctx,) time-weighted ns per context over [t0, t1) —
        bitwise-equal to ``stats.interval_profile`` on the same lines
        (integer ns are exact in float64, so the tile decomposition sums
        to the per-event answer).  ``ctx_mask`` composes the subtree
        filter at the tile level: non-matching pairs are skipped and
        refinement drops masked events, matching ``apply_filter``."""
        out = np.zeros(n_ctx, np.float64)
        tiles, residuals = self._window_tiles(t0, t1)
        ids = range(len(self.lines)) if lines is None else lines
        for i in ids:
            if not self.lines[i].count:
                continue
            for lev, b0, b1 in tiles:
                ctx, ns = self.ctx_tiles(i, lev, b0, b1)
                if not len(ctx):
                    continue
                valid = (ctx >= 0) & (ctx < n_ctx)
                if ctx_mask is not None:
                    keep = valid & ctx_mask[np.clip(ctx, 0, n_ctx - 1)]
                    np.add.at(out, ctx[keep], ns[keep].astype(np.float64))
                else:
                    # out-of-range ctx attributes to root, matching
                    # stats.interval_profile
                    np.add.at(out, np.where(valid, ctx, 0),
                              np.asarray(ns, np.float64))
            for a, b in residuals:
                self._refine_profile(i, a, b, out, ctx_mask)
        return out

    def _cum_busy_line(self, i: int) -> np.ndarray:
        cum = self._cum_busy.get(i)
        if cum is None:
            cum = np.concatenate(
                [[0], np.cumsum(self.busy_tiles(i, 0))]).astype(np.int64)
            self._cum_busy[i] = cum
        return cum

    def _coverage_many(self, i: int, ts: np.ndarray) -> np.ndarray:
        """C(t) per edge: union-covered ns of line ``i`` in [t_min, t) —
        busy-tile cumsum at the nearest finest-bin edge below each t,
        plus per-event refinement inside the single bin containing it.
        All edges refine in one vectorized sweep: segment expansion of
        the (emax-pruned) candidate events per edge, then one
        ``_merged_coverage`` pass over per-edge offset blocks."""
        grid_end = self.t_min + self.n_bins * self.bin_ns
        ts = np.clip(np.asarray(ts, np.int64), self.t_min, grid_end)
        k = (ts - self.t_min) // self.bin_ns
        edge = self.t_min + k * self.bin_ns
        out = self._cum_busy_line(i)[np.minimum(k, self.n_bins)].copy()
        if not self.lines[i].count:
            return out
        idx = np.flatnonzero(ts > edge)
        if not len(idx):
            return out
        t_n, e_n = ts[idx], edge[idx]
        tdb = self.tdb
        s = np.asarray(tdb.starts(i), np.int64)
        e = np.asarray(tdb.ends(i), np.int64)
        hi = np.searchsorted(s, t_n, side="left")
        # emax is nondecreasing, so the prune lower bound vectorizes on
        # the full array (capped at hi — the scalar path's emax[:hi])
        lo = np.minimum(np.searchsorted(self.emax(i), e_n, side="right"),
                        hi)
        counts = hi - lo
        total = int(counts.sum())
        if not total:
            return out
        grp = np.repeat(np.arange(len(idx)), counts)
        base = np.zeros(len(idx), np.int64)
        np.cumsum(counts[:-1], out=base[1:])
        pos = lo[grp] + (np.arange(total) - base[grp])
        cs = np.clip(s[pos], e_n[grp], t_n[grp]) - self.t_min
        ce = np.clip(e[pos], e_n[grp], t_n[grp]) - self.t_min
        # offset trick: shift each edge's block by grp*BIG so one merged-
        # coverage sweep unions per-edge without merging across edges
        big = (grid_end - self.t_min) + self.bin_ns + 1
        m_s, m_e = _merged_coverage(cs + grp * big, ce + grp * big)
        add = np.bincount(m_s // big, weights=m_e - m_s,
                          minlength=len(idx)).astype(np.int64)
        out[idx] += add
        return out

    def _coverage_before(self, i: int, t: int) -> int:
        """C(t): union-covered ns of line ``i`` in [t_min, t)."""
        return int(self._coverage_many(i, np.asarray([t], np.int64))[0])

    def _occ_index_line(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Cached per-line refinement index: candidate events for an
        edge inside finest bin ``b`` are ``[ev_lo[b], ev_hi[b])``.
        ``ev_hi`` is relaxed to the bin *end* — events starting between
        the edge and the bin end clip to zero length and contribute
        nothing — so occupancy refinement needs no per-query
        searchsorted, only gathers from this table."""
        cached = self._occ_idx.get(i)
        if cached is None:
            edges = self.t_min + np.arange(self.n_bins + 1,
                                           dtype=np.int64) * self.bin_ns
            ev_hi = np.searchsorted(self.tdb.starts(i), edges[1:],
                                    side="left")
            ev_lo = np.minimum(
                np.searchsorted(self.emax(i), edges[:-1], side="right"),
                ev_hi)
            cached = (ev_lo, ev_hi)
            self._occ_idx[i] = cached
        return cached

    def occupancy(self, t0: int, t1: int, nbins: int, *,
                  lines: Optional[Sequence[int]] = None) -> np.ndarray:
        """(n_lines, nbins) busy ns per bin — bitwise-equal to
        ``stats.occupancy`` on the same lines (differences of the exact
        cumulative coverage).  Batched across lines: per line only the
        two pruning searchsorteds run; gathering candidate events (one
        fancy index into the db's raw data region), clipping, the union
        sweep, and the per-edge sums happen once over every
        (line, edge) segment."""
        ids = list(range(len(self.lines))) if lines is None else list(lines)
        edges = int(t0) + (int(t1) - int(t0)) \
            * np.arange(nbins + 1, dtype=np.int64) // nbins
        grid_end = self.t_min + self.n_bins * self.bin_ns
        ts = np.clip(edges, self.t_min, grid_end)
        k = (ts - self.t_min) // self.bin_ns
        edge_lo = self.t_min + k * self.bin_ns
        kk = np.minimum(k, self.n_bins)
        cov = np.zeros((len(ids), nbins + 1), np.int64)
        for row, i in enumerate(ids):
            cov[row] = self._cum_busy_line(i)[kk]
        idx = np.flatnonzero(ts > edge_lo)    # edges inside a finest bin
        live = [row for row, i in enumerate(ids) if self.lines[i].count]
        if len(idx) and live:
            kb = k[idx]                       # finest bin per edge
            t_n, e_n = ts[idx], edge_lo[idx]
            tdb = self.tdb
            raw = tdb.raw()
            n_e = len(idx)
            hi = np.empty((len(live), n_e), np.int64)
            lo = np.empty_like(hi)
            for j, row in enumerate(live):
                ev_lo, ev_hi = self._occ_index_line(ids[row])
                lo[j] = ev_lo[kb]
                hi[j] = ev_hi[kb]
            counts = (hi - lo).ravel()
            total = int(counts.sum())
            if total:
                s_off = np.array([tdb.lines[ids[r]].offset for r in live],
                                 np.int64)
                cnt = np.array([tdb.lines[ids[r]].count for r in live],
                               np.int64)
                seg = np.repeat(np.arange(len(live) * n_e), counts)
                base = np.zeros(len(live) * n_e, np.int64)
                np.cumsum(counts[:-1], out=base[1:])
                pos = lo.ravel()[seg] + (np.arange(total) - base[seg])
                line_of = seg // n_e
                gpos = s_off[line_of] + pos
                a, b = e_n[seg % n_e], t_n[seg % n_e]
                cs = np.clip(raw[gpos], a, b) - self.t_min
                ce = np.clip(raw[gpos + cnt[line_of]], a, b) - self.t_min
                # offset trick: shift each (line, edge) block by seg*BIG
                # so one merged-coverage sweep unions per-segment
                # without merging across segments
                big = (grid_end - self.t_min) + self.bin_ns + 1
                m_s, m_e = _merged_coverage(cs + seg * big, ce + seg * big)
                add = np.bincount(m_s // big, weights=m_e - m_s,
                                  minlength=len(live) * n_e)
                cov[np.asarray(live, np.int64)[:, None], idx[None, :]] += \
                    add.reshape(len(live), n_e).astype(np.int64)
        return np.diff(cov).astype(np.float64)

    def rasterize(self, parents: np.ndarray, *,
                  t0: Optional[int] = None, t1: Optional[int] = None,
                  width: int = 120, height: int = 32, depth: int = 2,
                  depths: Optional[np.ndarray] = None,
                  lines: Optional[Sequence[int]] = None,
                  mode: str = "auto") -> Raster:
        """Tile-backed raster.  ``mode``:

        - ``"exact"`` — midpoint sampling, bitwise-equal to
          ``raster.rasterize`` on the same lines, O(width log E) per
          line via the stored ``emax``/nested refinement data;
        - ``"dominant"`` — each pixel paints the dominant context of the
          nearest-resolution tile under its midpoint, O(width) per line
          with no event touched;
        - ``"auto"`` — dominant while a pixel spans at least one finest
          bin, exact once zoomed past the finest level.
        """
        parents = np.asarray(parents, np.int64)
        ids = list(range(len(self.lines))) if lines is None else list(lines)
        if t0 is None or t1 is None:
            d0, d1 = self.line_range(ids)
            t0 = d0 if t0 is None else t0
            t1 = d1 if t1 is None else t1
        t0, t1 = int(t0), int(t1)
        if t1 <= t0:
            t1 = t0 + 1
        if depths is None:
            depths = tree_depths(parents)
        rows = _pick_rows(len(ids), height)
        samples = t0 + (np.arange(width, dtype=np.float64) + 0.5) \
            * (t1 - t0) / width
        pixel_ns = (t1 - t0) / width
        use_dom = mode == "dominant" or \
            (mode == "auto" and pixel_ns >= self.bin_ns)
        if use_dom and depth > self.max_depth \
                and self.max_depth < int(depths.max() if len(depths) else 0):
            use_dom = False          # tree deeper than the stored tiles
        if mode not in ("auto", "exact", "dominant"):
            raise ValueError(f"unknown raster mode {mode!r}")
        pixels = np.full((len(rows), width), IDLE, np.int64)
        if use_dom:
            # largest level whose bins are no wider than a pixel (level
            # 0 when forced dominant on a zoomed-in window)
            lev = min(max(int(pixel_ns // self.bin_ns).bit_length() - 1, 0),
                      self.n_levels - 1)
            w_lev = self.bin_ns << lev
            bins = ((samples - self.t_min) // w_lev).astype(np.int64)
            n_lev = self.lines[0].levels[lev]["bins"] if self.lines else 0
            inside = (bins >= 0) & (bins < n_lev) & (samples >= self.t_min)
            safe = np.clip(bins, 0, max(n_lev - 1, 0))
            for out_row, r in enumerate(rows):
                i = ids[r]
                if not self.lines[i].count:
                    continue
                dom = self.dominant_tiles(i, lev, depth)
                vals = dom[safe]
                pixels[out_row, inside & (vals != IDLE)] = \
                    vals[inside & (vals != IDLE)]
        else:
            tdb = self.tdb
            anc = ancestors_at_depth(parents, depths, depth)
            for out_row, r in enumerate(rows):
                i = ids[r]
                ln = self.lines[i]
                if not ln.count:
                    continue
                gids = sample_line(tdb.starts(i), tdb.ends(i), tdb.ctx(i),
                                   samples, emax=self.emax(i),
                                   nested=ln.nested)
                valid = (gids >= 0) & (gids < len(parents))
                pixels[out_row, valid] = anc[gids[valid]]
        return Raster(pixels, samples,
                      [line_label(self.lines[ids[r]].identity)
                       for r in rows],
                      np.asarray([ids[r] for r in rows], np.int64),
                      t0, t1, depth)


# --------------------------------------------------------------------------
# lazy cache
# --------------------------------------------------------------------------
def ensure_pyramid(db, parents: Optional[np.ndarray] = None, *,
                   rebuild: bool = False) -> TracePyramid:
    """Open the ``trace.pyr`` next to a database's ``trace.db``,
    building (or rebuilding) it when missing or stale.  ``db`` is a
    ``pipeline.Database`` (parents implied) or a ``trace.db`` path with
    explicit ``parents``.  Staleness = the recorded trace.db header
    digest or parents digest no longer matches — checked without
    touching event data."""
    if hasattr(db, "trace_db_path"):
        db_path = db.trace_db_path()
        if parents is None:
            parents = db.parents
    else:
        db_path = db
        if parents is None:
            raise ValueError("ensure_pyramid needs the CCT parents when "
                             "given a bare trace.db path")
    pyr_path = pyramid_path_for(db_path)
    if not rebuild and os.path.exists(pyr_path):
        pyr = TracePyramid(pyr_path)
        if (pyr.source.get("db_header_sha256") == _db_header_sha(db_path)
                and pyr.parents_sha256 == _parents_sha(parents)):
            return pyr
        pyr.close()
    return build_pyramid(db_path, parents, pyr_path)
