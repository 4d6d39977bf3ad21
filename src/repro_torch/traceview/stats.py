"""Interval statistics over trace windows (paper §7; THAPI-style timeline
summarization).

Three views, all over an arbitrary ``[t0, t1)`` window:

- **Summary** (`summary`, `interval_profile`): the trace view's Summary
  tab — a time-weighted profile of the window.  Each event contributes
  its overlap with the window to its context, projected to a call-stack
  depth.  Over the full time range this reproduces
  ``viewer.trace_statistic`` exactly (event durations are integer ns, so
  float64 accumulation is order-independent) while staying vectorized.
- **Idleness / blame over time** (`blame_over_time`): per rank, the
  fraction of GPU streams idle in each of N bins, plus all-streams-idle
  time split equally across the CPU contexts active during it — the
  binned generalization of ``core.blame.blame_gpu_idleness``; per-context
  totals summed over bins equal the unbinned sweep's output.
- **Top-k kernels** (`top_kernels`): largest GPU contexts by busy time in
  the window.

Per-line occupancy (`occupancy`) exposes the busy-time-per-bin primitive:
for every line, busy + idle sums to the window length (the property test
in tests/test_traceview.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blame import blame_gpu_idleness, idle_segments
from repro_torch.core.trace import TraceData, sorted_by_start
from repro_torch.traceview.raster import ancestors_at_depth, tree_depths


# --------------------------------------------------------------------------
# coverage primitives
# --------------------------------------------------------------------------
def merge_intervals(starts: np.ndarray, ends: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Union of (possibly overlapping) intervals, as disjoint sorted
    intervals — fully vectorized (sort + running max + group reduce)."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    if not len(starts):
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    emax = np.maximum.accumulate(e)
    new_group = np.ones(len(s), bool)
    new_group[1:] = s[1:] > emax[:-1]
    m_start = s[new_group]
    m_end = np.maximum.reduceat(e, np.flatnonzero(new_group))
    return m_start, m_end


def coverage_at(m_start: np.ndarray, m_end: np.ndarray,
                t: np.ndarray) -> np.ndarray:
    """C(t) = total covered time in [-inf, t) for disjoint sorted
    intervals, evaluated at many ``t`` at once."""
    if not len(m_start):
        return np.zeros(len(np.atleast_1d(t)), np.int64)
    dur = m_end - m_start
    cum = np.concatenate([[0], np.cumsum(dur)])
    idx = np.searchsorted(m_start, t, side="right")
    safe = np.maximum(idx - 1, 0)
    partial = np.clip(t - m_start[safe], 0, dur[safe]) * (idx > 0)
    return cum[safe] * (idx > 0) + partial


def occupancy(lines: Sequence[TraceData], t0: int, t1: int,
              nbins: int, *, pyramid=None,
              line_ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """(n_lines, nbins) busy ns per bin.  Busy time is the *union* of the
    line's events, so for any line busy + idle == t1 - t0 exactly.

    With ``pyramid`` (a ``pyramid.TracePyramid``), bin sums come from the
    precomputed busy-ns tiles — bitwise-equal (docs/traceview.md) but
    O(tiles) instead of O(events); ``line_ids`` selects pyramid lines
    (all when None) and ``lines`` is ignored."""
    if pyramid is not None:
        return pyramid.occupancy(t0, t1, nbins, lines=line_ids)
    edges = int(t0) + (int(t1) - int(t0)) \
        * np.arange(nbins + 1, dtype=np.int64) // nbins
    out = np.zeros((len(lines), nbins), np.float64)
    for i, td in enumerate(lines):
        m_s, m_e = merge_intervals(np.clip(td.starts, t0, t1),
                                   np.clip(td.ends, t0, t1))
        out[i] = np.diff(coverage_at(m_s, m_e, edges))
    return out


# --------------------------------------------------------------------------
# Summary view
# --------------------------------------------------------------------------
def interval_profile(lines: Sequence[TraceData], n_ctx: int,
                     t0: int, t1: int) -> np.ndarray:
    """(n_ctx,) time-weighted ns per context over the window — each
    event's overlap with [t0, t1) scatter-added onto its context.

    Lines are expected start-sorted (TraceDB views are); unsorted lines
    are sorted here so pre-merge TraceData gives the same answer.  Both
    window edges prune: events are sliced to [lo, hi) where ``hi`` bounds
    starts < t1 and ``lo`` drops the prefix whose running-max end <= t0,
    so a narrow window touches few events."""
    out = np.zeros(n_ctx, np.float64)
    for td in lines:
        td = sorted_by_start(td)
        starts = td.starts
        if not len(starts):
            continue
        hi = int(np.searchsorted(starts, t1, side="left"))
        lo = int(np.searchsorted(
            np.maximum.accumulate(td.ends[:hi]), t0, side="right"))
        ends = td.ends[lo:hi]
        overlap = np.minimum(ends, t1) - np.maximum(starts[lo:hi], t0)
        sel = overlap > 0
        ctx = td.ctx[lo:hi][sel]
        # out-of-range ctx attributes to root, like viewer.trace_statistic
        # (and aggregate's phase-5 handling of the same condition)
        ctx = np.where((ctx >= 0) & (ctx < n_ctx), ctx, 0)
        np.add.at(out, ctx, overlap[sel].astype(np.float64))
    return out


def summary(lines: Sequence[TraceData], db, *, t0: Optional[int] = None,
            t1: Optional[int] = None, depth: int = 2, top: int = 10,
            depths: Optional[np.ndarray] = None, pyramid=None,
            flt=None) -> List[Tuple[str, float]]:
    """The Summary tab: fraction of window trace-area per routine at the
    given depth.  With the full window this matches
    ``viewer.trace_statistic`` on the same lines.

    With ``pyramid`` (a ``pyramid.TracePyramid``), the profile comes from
    the context tiles — bitwise-equal to the per-event path on the same
    window (docs/traceview.md) — and ``lines`` is ignored (pass None).
    ``flt`` (a ``filter.TraceFilter``) composes at the tile level: line
    predicates prune whole lines, the subtree mask prunes tile entries,
    and the default window is the selected lines' extent intersected
    with the filter window."""
    parents = np.asarray(db.parents, np.int64)
    if pyramid is not None:
        line_ids, ctx_mask, ft0, ft1 = pyramid.select(flt, parents)
        d0, d1 = pyramid.line_range(line_ids)
        t0 = d0 if t0 is None else t0
        t1 = d1 if t1 is None else t1
        if ft0 is not None:
            t0 = max(t0, ft0)
        if ft1 is not None:
            t1 = min(t1, ft1)
        prof = pyramid.interval_profile(len(db.frames), t0, t1,
                                        lines=line_ids, ctx_mask=ctx_mask)
    else:
        if t0 is None:
            # min, not starts[0]: pre-merge lines may be unsorted
            t0 = min((int(np.min(td.starts)) for td in lines
                      if len(td.starts)), default=0)
        if t1 is None:
            t1 = max((int(td.ends.max()) for td in lines if len(td.ends)),
                     default=t0)
        prof = interval_profile(lines, len(db.frames), t0, t1)
    if depths is None:   # aggregate.Database caches its depth array
        depths = db.depths() if hasattr(db, "depths") else \
            tree_depths(parents)
    anc = ancestors_at_depth(parents, depths, depth)
    by_anc = np.zeros(len(prof))
    np.add.at(by_anc, anc, prof)
    # distinct contexts can project to the same routine (one function,
    # many call paths): group by name, like trace_statistic
    area: Dict[str, float] = {}
    for g in np.flatnonzero(by_anc):
        name = db.frames[g].pretty()
        area[name] = area.get(name, 0.0) + by_anc[g]
    total = sum(area.values())
    rows = sorted(area.items(), key=lambda kv: -kv[1])[:top]
    return [(n, v / total if total else 0.0) for n, v in rows]


def top_kernels(lines: Sequence[TraceData], db, *, t0: int, t1: int,
                k: int = 5) -> List[Tuple[str, float]]:
    """Top-k GPU contexts by busy ns inside the window (GPU lines only)."""
    gpu = [td for td in lines if td.identity.get("type") == "gpu"]
    prof = interval_profile(gpu, len(db.frames), t0, t1)
    order = np.argsort(-prof, kind="stable")[:k]
    return [(db.frames[g].pretty(), float(prof[g]))
            for g in order if prof[g] > 0]


def top_kernel_counters(lines: Sequence[TraceData], db, *, t0: int, t1: int,
                        k: int = 5, stat: str = "sum"
                        ) -> List[Tuple[str, float, Dict[str, float]]]:
    """Top-k kernels by windowed busy time, joined with the database's
    hardware-counter derived columns (paper §6; repro.counters): each row
    is ``(name, busy_ns, {occupancy, flop_eff, bytes_per_flop,
    replay_passes})``.  Counter stats are whole-run aggregates (counters
    are kernel-granularity, not time-binned), while busy_ns respects the
    window — the same join the hpcviewer trace view's kernel table shows.
    Requires a ``Database`` with the ``gpu_counter`` kind; rows without
    counter data carry zeros (the derived zero-division policy)."""
    from repro_torch.core.derived import (ACHIEVED_OCCUPANCY, BYTES_PER_FLOP,
                                    FLOP_EFFICIENCY, REPLAY_PASS_COUNT,
                                    database_columns)
    gpu = [td for td in lines if td.identity.get("type") == "gpu"]
    prof = interval_profile(gpu, len(db.frames), t0, t1)
    order = np.argsort(-prof, kind="stable")[:k]
    cols = database_columns(db, stat)
    if "gpu_counter/elapsed_ns" not in cols:
        return [(db.frames[g].pretty(), float(prof[g]), {})
                for g in order if prof[g] > 0]
    derived = {"occupancy": ACHIEVED_OCCUPANCY.evaluate(cols),
               "flop_eff": FLOP_EFFICIENCY.evaluate(cols),
               "bytes_per_flop": BYTES_PER_FLOP.evaluate(cols),
               "replay_passes": REPLAY_PASS_COUNT.evaluate(cols)}
    return [(db.frames[g].pretty(), float(prof[g]),
             {name: float(vals[g]) for name, vals in derived.items()})
            for g in order if prof[g] > 0]


def top_hot_loops(lines: Sequence[TraceData], db, *, t0: Optional[int] = None,
                  t1: Optional[int] = None, k: int = 10, stat: str = "sum"
                  ) -> List[Tuple[str, str, str, str, float, float]]:
    """Kernel-interior hot spots joined with windowed trace time
    (repro.core.kstruct; the traceview face of ``viewer.top_hot_loops``):
    rows ``(kernel, loop, file:line, op, samples, est_busy_ns)``.

    Sample stats are whole-run aggregates (PC samples are not
    time-binned); ``est_busy_ns`` prorates the enclosing GPU placeholder
    context's busy ns inside [t0, t1) over its interior leaves by sample
    share — the same whole-run-stats x windowed-busy join as
    ``top_kernel_counters``."""
    from repro_torch.core.cct import GPU_FUNC, GPU_LOOP, GPU_OP, PLACEHOLDER
    try:
        cols = db.stats[stat]
        samp = cols[:, db.metric_id("gpu_inst/samples")]
    except (KeyError, ValueError):
        return []
    gpu = [td for td in lines if td.identity.get("type") == "gpu"]
    if t0 is None:
        # min, not starts[0]: pre-merge lines may be unsorted
        t0 = min((int(np.min(td.starts)) for td in gpu if len(td.starts)),
                 default=0)
    if t1 is None:
        t1 = max((int(td.ends.max()) for td in gpu if len(td.ends)),
                 default=t0)
    prof = interval_profile(gpu, len(db.frames), t0, t1)
    parents = np.asarray(db.parents, np.int64)
    kids: Dict[int, List[int]] = {}
    for gid, par in enumerate(parents):
        if par >= 0:
            kids.setdefault(int(par), []).append(gid)

    def subtree_sum(vals: np.ndarray, g: int) -> float:
        total, stack = 0.0, [g]
        while stack:
            i = stack.pop()
            total += float(vals[i])
            stack.extend(kids.get(i, []))
        return total

    roots = [g for g, f in enumerate(db.frames)
             if f.kind == GPU_FUNC and parents[g] >= 0
             and db.frames[int(parents[g])].kind == GPU_OP]
    rows: Dict[tuple, float] = {}
    busy_of: Dict[tuple, float] = {}
    for r in roots:
        kernel = db.frames[r].name
        p = int(parents[r])
        while p >= 0 and db.frames[p].kind != PLACEHOLDER:
            p = int(parents[p])
        busy = subtree_sum(prof, p) if p >= 0 else 0.0
        ktotal = samp[r] or 1.0
        stack = [(c, "-") for c in kids.get(r, [])]
        while stack:
            g, loop = stack.pop()
            f = db.frames[g]
            if f.kind == GPU_LOOP:
                loop = f.name
            if f.kind == GPU_OP:
                key = (kernel, loop, f"{f.module}:{f.line}", f.name)
                rows[key] = rows.get(key, 0.0) + float(samp[g])
                busy_of[key] = busy_of.get(key, 0.0) \
                    + busy * float(samp[g]) / float(ktotal)
            stack.extend((c, loop) for c in kids.get(g, []))
    out = [(kk[0], kk[1], kk[2], kk[3], v, busy_of[kk])
           for kk, v in rows.items()]
    out.sort(key=lambda row: (-row[4], row[:4]))
    return out[:k]


# --------------------------------------------------------------------------
# Idleness / blame over time
# --------------------------------------------------------------------------
def _clip_line(td: TraceData, t0: int, t1: int) -> TraceData:
    starts = np.asarray(td.starts, np.int64)
    ends = np.asarray(td.ends, np.int64)
    sel = (starts < t1) & (ends > t0)
    return TraceData(td.identity, np.clip(starts[sel], t0, t1),
                     np.clip(ends[sel], t0, t1),
                     np.asarray(td.ctx, np.int64)[sel])


def split_by_rank(lines: Sequence[TraceData]
                  ) -> Dict[int, List[TraceData]]:
    by_rank: Dict[int, List[TraceData]] = {}
    for td in lines:
        by_rank.setdefault(int(td.identity.get("rank", 0)), []).append(td)
    return by_rank


def blame_over_time(lines: Sequence[TraceData], t0: int, t1: int,
                    nbins: int, *, pyramid=None) -> Dict[int, dict]:
    """Per rank: ``streams_idle_frac`` (nbins,) — 1 - mean busy fraction
    of the rank's GPU streams per bin; ``idle_ns`` (nbins,) — all-streams
    -idle time per bin; ``blame`` {cpu ctx: (nbins,) ns} — idle time split
    equally across CPU contexts active during it, prorated onto the bins
    each idle segment spans.  Summing ``blame`` over bins reproduces
    ``core.blame.blame_gpu_idleness`` on the same (clipped) lines.
    Ranks with no GPU lines are omitted (no streams to be idle).

    With ``pyramid``, the per-stream busy sums come from the busy-ns
    tiles (bitwise-equal); the idle-segment blame split still walks the
    window's clipped events — it needs the set of CPU contexts active
    during each segment, which no additive tile carries.
    """
    edges = t0 + (t1 - t0) * np.arange(nbins + 1, dtype=np.int64) // nbins
    out: Dict[int, dict] = {}
    for rank, rlines in sorted(split_by_rank(lines).items()):
        cpu = [_clip_line(td, t0, t1) for td in rlines
               if td.identity.get("type", "cpu") == "cpu"]
        gpu = [_clip_line(td, t0, t1) for td in rlines
               if td.identity.get("type") == "gpu"]
        if not gpu:
            # no streams -> "fraction of streams idle" is undefined, and
            # blaming the rank's whole CPU runtime would be wrong
            continue
        ids = [pyramid.line_index(td.identity) for td in gpu] \
            if pyramid is not None else None
        busy = occupancy(gpu, t0, t1, nbins, pyramid=pyramid,
                         line_ids=ids)
        widths = np.diff(edges).astype(np.float64)
        frac = 1.0 - busy.sum(0) / np.maximum(widths * max(len(gpu), 1), 1)
        idle_ns = np.zeros(nbins)
        blame: Dict[int, np.ndarray] = {}
        for seg_t0, seg_t1, active in idle_segments(cpu, gpu):
            lo = int(np.searchsorted(edges, seg_t0, side="right")) - 1
            hi = int(np.searchsorted(edges, seg_t1, side="left"))
            for b in range(max(lo, 0), min(hi, nbins)):
                part = min(seg_t1, int(edges[b + 1])) \
                    - max(seg_t0, int(edges[b]))
                if part <= 0:
                    continue
                idle_ns[b] += part
                share = part / len(active)
                for c in active:
                    blame.setdefault(
                        c, np.zeros(nbins))[b] += share
        out[rank] = {"streams_idle_frac": frac, "idle_ns": idle_ns,
                     "blame": blame}
    return out


def windowed_blame(lines: Sequence[TraceData], t0: int, t1: int
                   ) -> Tuple[Dict[int, float], float]:
    """Exact §7.2 blame restricted to a window: clip every line to
    [t0, t1) and delegate to ``core.blame.blame_gpu_idleness``."""
    cpu = [_clip_line(td, t0, t1) for td in lines
           if td.identity.get("type", "cpu") == "cpu"]
    gpu = [_clip_line(td, t0, t1) for td in lines
           if td.identity.get("type") == "gpu"]
    return blame_gpu_idleness(cpu, gpu)


# --------------------------------------------------------------------------
# Per-request attribution (repro.serving measurement windows)
# --------------------------------------------------------------------------
def window_labels(db) -> Tuple[List[Optional[str]], List[Optional[str]]]:
    """Per-context ``(request_id, phase)``: each context inherits the
    nearest enclosing serving-window frames (the ``request:<id>`` /
    ``phase:<p>`` scheme of repro.serving.window).  Contexts outside any
    window carry ``(None, None)``."""
    from repro_torch.serving.window import window_label
    parents = np.asarray(db.parents, np.int64)
    n = len(db.frames)
    req: List[Optional[str]] = [None] * n
    ph: List[Optional[str]] = [None] * n
    done = np.zeros(n, bool)
    for start in range(n):
        if done[start]:
            continue
        chain = []
        i = start
        while i >= 0 and not done[i]:
            chain.append(i)
            i = int(parents[i])
        r, p = (req[i], ph[i]) if i >= 0 else (None, None)
        for j in reversed(chain):
            fr, fp = window_label(db.frames[j])
            if fr is not None:
                r, p = fr, None     # a new request window resets the phase
            if fp is not None:
                p = fp
            req[j], ph[j] = r, p
            done[j] = True
    return req, ph


def request_attribution(lines: Sequence[TraceData], db, *,
                        t0: Optional[int] = None, t1: Optional[int] = None,
                        gpu_only: bool = True
                        ) -> List[Tuple[str, float, Dict[str, float]]]:
    """Which request burned the GPU: time-weighted busy ns per request id
    over the window, split by phase — rows ``(request_id, total_ns,
    {phase: ns})`` sorted by total descending.  ``gpu_only`` restricts to
    GPU stream lines (the question the serving operator asks); pass
    False to attribute host lines too."""
    sel = [td for td in lines
           if not gpu_only or td.identity.get("type") == "gpu"]
    if t0 is None:
        # min, not starts[0]: pre-merge lines may be unsorted
        t0 = min((int(np.min(td.starts)) for td in sel if len(td.starts)),
                 default=0)
    if t1 is None:
        t1 = max((int(td.ends.max()) for td in sel if len(td.ends)),
                 default=t0)
    prof = interval_profile(sel, len(db.frames), t0, t1)
    req, ph = window_labels(db)
    rows: Dict[str, Dict[str, float]] = {}
    for g in np.flatnonzero(prof):
        r = req[g]
        if r is None:
            continue
        by = rows.setdefault(r, {})
        p = ph[g] or "other"
        by[p] = by.get(p, 0.0) + float(prof[g])
    out = [(r, sum(by.values()), by) for r, by in rows.items()]
    out.sort(key=lambda row: (-row[1], row[0]))
    return out


def request_spans(lines: Sequence[TraceData], db
                  ) -> Dict[Tuple[str, str], Tuple[int, int]]:
    """Per ``(request_id, phase)``: the ``[min start, max end)`` envelope
    of every trace event attributed to it — the trace-derived request
    latency (GPU time the request actually occupied, across streams)."""
    req, ph = window_labels(db)
    spans: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for td in lines:
        ctx = np.asarray(td.ctx, np.int64)
        if not len(ctx):
            continue
        starts = np.asarray(td.starts, np.int64)
        ends = np.asarray(td.ends, np.int64)
        valid = (ctx >= 0) & (ctx < len(req))
        ctx_v = ctx[valid]
        if not len(ctx_v):
            continue
        # one group-reduce per line (argsort + reduceat) instead of the
        # old per-unique-ctx re-scan, which was O(unique x events)
        order = np.argsort(ctx_v, kind="stable")
        cs = ctx_v[order]
        grp = np.flatnonzero(np.concatenate(([True], cs[1:] != cs[:-1])))
        gmin = np.minimum.reduceat(starts[valid][order], grp)
        gmax = np.maximum.reduceat(ends[valid][order], grp)
        for g, s0, e1 in zip(cs[grp], gmin, gmax):
            r = req[int(g)]
            if r is None:
                continue
            key = (r, ph[int(g)] or "other")
            cur = spans.get(key)
            s0, e1 = int(s0), int(e1)
            spans[key] = ((min(cur[0], s0), max(cur[1], e1)) if cur
                          else (s0, e1))
    return spans


def request_latency_percentiles(lines: Sequence[TraceData], db, *,
                                qs: Sequence[float] = (50.0, 99.0)
                                ) -> Dict[str, Dict[float, float]]:
    """Per phase: latency percentiles in ms over per-request trace spans
    — the post-hoc cross-check of the live ``ServingStats`` percentiles
    (those are wall-clock windows; these are trace envelopes)."""
    by_phase: Dict[str, List[int]] = {}
    for (_, p), (s, e) in request_spans(lines, db).items():
        by_phase.setdefault(p, []).append(e - s)
    return {p: {float(q): float(np.percentile(
                np.asarray(d, np.int64), q)) / 1e6 for q in qs}
            for p, d in sorted(by_phase.items())}
