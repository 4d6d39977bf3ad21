"""Text-mode hpcviewer (paper §7): profile views (top-down / bottom-up /
flat), thread-centric plots (as columns), and the trace Statistic tab.

The GUI renders a database; we render the same content as aligned text so
tests and examples can assert on it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.aggregate import Database
from repro_torch.core.trace import TraceData


def _fmt(v: float) -> str:
    if v == 0:
        return "."
    if abs(v) >= 1e6 or 0 < abs(v) < 1e-2:
        return f"{v:.3e}"
    return f"{v:,.2f}"


def top_down(db: Database, metric: str, *, stat: str = "sum",
             max_depth: int = 8, min_frac: float = 0.01,
             max_children: int = 8) -> str:
    """Costs in full calling context (inclusive metrics)."""
    mid = db.metric_id(metric)
    col = db.stats[stat][:, mid]
    total = col[0] if col[0] else max(col.max(), 1e-30)
    kids: Dict[int, List[int]] = {}
    for gid, par in enumerate(db.parents):
        if par >= 0:
            kids.setdefault(int(par), []).append(gid)
    lines = [f"TOP-DOWN  metric={metric} [{stat}]  total={_fmt(total)}"]

    def rec(gid: int, depth: int):
        if depth > max_depth:
            return
        cs = sorted(kids.get(gid, []), key=lambda c: -col[c])
        shown = 0
        for c in cs:
            if col[c] / total < min_frac or shown >= max_children:
                break
            shown += 1
            lines.append("  " * depth
                         + f"{col[c] / total * 100:5.1f}% {_fmt(col[c]):>12} "
                         + db.frames[c].pretty())
            rec(c, depth + 1)

    rec(0, 0)
    return "\n".join(lines)


def _exclusive(db: Database, col: np.ndarray) -> np.ndarray:
    """Inclusive -> exclusive: subtract children sums."""
    ex = col.copy()
    for gid, par in enumerate(db.parents):
        if par >= 0:
            ex[par] -= col[gid]
    return np.maximum(ex, 0.0)


def flat(db: Database, metric: str, *, stat: str = "sum",
         top: int = 15) -> str:
    """Aggregate costs by frame, independent of calling context."""
    mid = db.metric_id(metric)
    ex = _exclusive(db, db.stats[stat][:, mid])
    agg: Dict[str, float] = {}
    for gid, f in enumerate(db.frames):
        agg[f.pretty()] = agg.get(f.pretty(), 0.0) + ex[gid]
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    total = sum(agg.values()) or 1.0
    lines = [f"FLAT  metric={metric} [{stat}]"]
    for name, v in rows:
        if v <= 0:
            continue
        lines.append(f"{v / total * 100:5.1f}% {_fmt(v):>12}  {name}")
    return "\n".join(lines)


def bottom_up(db: Database, metric: str, *, stat: str = "sum",
              top: int = 10, caller_depth: int = 3) -> str:
    """Apportion each frame's exclusive cost to its callers."""
    mid = db.metric_id(metric)
    ex = _exclusive(db, db.stats[stat][:, mid])
    by_frame: Dict[str, Dict[Tuple[str, ...], float]] = {}
    for gid in range(1, len(db.frames)):
        v = ex[gid]
        if v <= 0:
            continue
        name = db.frames[gid].pretty()
        chain = []
        p = int(db.parents[gid])
        while p > 0 and len(chain) < caller_depth:
            chain.append(db.frames[p].pretty())
            p = int(db.parents[p])
        by_frame.setdefault(name, {})
        key = tuple(chain)
        by_frame[name][key] = by_frame[name].get(key, 0.0) + v
    totals = sorted(((sum(c.values()), n) for n, c in by_frame.items()),
                    reverse=True)[:top]
    lines = [f"BOTTOM-UP  metric={metric} [{stat}]"]
    for v, name in totals:
        lines.append(f"{_fmt(v):>12}  {name}")
        for chain, cv in sorted(by_frame[name].items(),
                                key=lambda kv: -kv[1])[:4]:
            lines.append("              <- " + " <- ".join(chain) if chain
                         else "              <- (root)")
    return "\n".join(lines)


def counter_table(db: Database, *, stat: str = "sum", top: int = 10,
                  by: str = "gpu_kernel/time_ns") -> str:
    """Per-kernel hardware-counter table (paper §6; repro.counters): one
    row per GPU-kernel placeholder context, raw counter columns plus the
    derived occupancy / efficiency columns of ``core.derived``."""
    from repro_torch.core.derived import (ACHIEVED_OCCUPANCY, BYTES_PER_FLOP,
                                    FLOP_EFFICIENCY, REPLAY_PASS_COUNT,
                                    database_columns)
    cols = database_columns(db, stat)
    if "gpu_counter/elapsed_ns" not in cols:
        return "COUNTERS  (no gpu_counter kind in this database)"
    rows = [g for g, f in enumerate(db.frames)
            if f.kind == "placeholder" and f.name.startswith("kernel:")
            and cols["gpu_kernel/invocations"][g] > 0]
    rows.sort(key=lambda g: -cols[by][g])
    rows = rows[:top]
    derived = {
        "occupancy": ACHIEVED_OCCUPANCY.evaluate(cols),
        "flop_eff": FLOP_EFFICIENCY.evaluate(cols),
        "bytes/flop": BYTES_PER_FLOP.evaluate(cols),
        "passes": REPLAY_PASS_COUNT.evaluate(cols),
    }
    header = ["kernel", "invocs", "time_ns", "flops", "hbm_bytes",
              "occupancy", "flop_eff", "bytes/flop", "passes"]
    table = [[db.frames[g].pretty(),
              _fmt(cols["gpu_kernel/invocations"][g]),
              _fmt(cols["gpu_kernel/time_ns"][g]),
              _fmt(cols["gpu_counter/flops"][g]),
              _fmt(cols["gpu_counter/hbm_bytes"][g]),
              f"{derived['occupancy'][g]:.3f}",
              f"{derived['flop_eff'][g]:.3e}",
              f"{derived['bytes/flop'][g]:.3f}",
              f"{derived['passes'][g]:.1f}"] for g in rows]
    widths = [max(len(header[i]), *(len(r[i]) for r in table)) if table
              else len(header[i]) for i in range(len(header))]
    lines = [f"COUNTERS  [{stat}]  ({len(rows)} kernel context(s))",
             "  ".join(h.ljust(widths[i]) for i, h in enumerate(header))]
    for r in table:
        lines.append("  ".join(v.ljust(widths[i]) for i, v in enumerate(r)))
    return "\n".join(lines)


def top_hot_loops(db: Database, *, stat: str = "sum", top: int = 15) -> str:
    """Kernel-interior hot-spot table (paper §7 PC sampling inside GPU
    binaries; repro.core.kstruct): kernel -> loop -> source line with
    the stall-class breakdown.

    Interior contexts are found *structurally*: a GPU_FUNC frame whose
    parent is a GPU_OP frame is a kstruct kernel root (the HLO structure
    path never hangs children under GPU_OP), so no new frame kind — and
    no file-format change — is needed."""
    from repro_torch.core.cct import GPU_FUNC, GPU_LOOP, GPU_OP
    try:
        cols = {m: db.stats[stat][:, db.metric_id(f"gpu_inst/{m}")]
                for m in ("samples", "stall_compute", "stall_memory",
                          "stall_collective")}
    except (KeyError, ValueError):
        return "HOT LOOPS  (no gpu_inst kind in this database)"
    kids: Dict[int, List[int]] = {}
    for gid, par in enumerate(db.parents):
        if par >= 0:
            kids.setdefault(int(par), []).append(gid)
    roots = [g for g, f in enumerate(db.frames)
             if f.kind == GPU_FUNC and db.parents[g] >= 0
             and db.frames[int(db.parents[g])].kind == GPU_OP]
    rows: Dict[tuple, List[float]] = {}
    for r in roots:
        kernel = db.frames[r].name
        stack = [(c, "-") for c in kids.get(r, [])]
        while stack:
            g, loop = stack.pop()
            f = db.frames[g]
            if f.kind == GPU_LOOP:
                loop = f.name
            if f.kind == GPU_OP:
                key = (kernel, loop, f"{f.module}:{f.line}", f.name)
                acc = rows.setdefault(key, [0.0, 0.0, 0.0, 0.0])
                acc[0] += cols["samples"][g]
                acc[1] += cols["stall_compute"][g]
                acc[2] += cols["stall_memory"][g]
                acc[3] += cols["stall_collective"][g]
            stack.extend((c, loop) for c in kids.get(g, []))
    ordered = sorted(rows.items(), key=lambda kv: (-kv[1][0], kv[0]))[:top]
    total = sum(v[0] for v in rows.values()) or 1.0
    header = ["kernel", "loop", "line", "op", "samples", "%",
              "compute", "memory", "collective"]
    table = [[k[0], k[1], k[2], k[3], _fmt(v[0]),
              f"{v[0] / total * 100:.1f}",
              _fmt(v[1]), _fmt(v[2]), _fmt(v[3])]
             for k, v in ordered]
    widths = [max(len(header[i]), *(len(r[i]) for r in table)) if table
              else len(header[i]) for i in range(len(header))]
    lines = [f"HOT LOOPS  [{stat}]  ({len(roots)} kernel context(s), "
             f"{len(rows)} interior line(s))",
             "  ".join(h.ljust(widths[i]) for i, h in enumerate(header))]
    for r in table:
        lines.append("  ".join(v.ljust(widths[i]) for i, v in enumerate(r)))
    return "\n".join(lines)


def thread_plot(db: Database, cms_reader, ctx: int, metric: str,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(profile ids, values) for one CCT node across profiles — the
    thread-centric view (plot of a metric for a selected node)."""
    return cms_reader.metric_values(ctx, db.metric_id(metric))


def trace_statistic(traces: Sequence[TraceData], db: Database,
                    depth: int = 2, top: int = 10) -> List[Tuple[str, float]]:
    """The trace-view Statistic tab: fraction of total trace area occupied
    by each routine at the given call-stack depth."""
    area: Dict[str, float] = {}
    total = 0.0
    for tr in traces:
        for s, e, c in zip(tr.starts, tr.ends, tr.ctx):
            dur = float(e - s)
            total += dur
            # walk up to requested depth
            gid = int(c)
            chain = []
            while gid > 0 and gid < len(db.frames):
                chain.append(gid)
                gid = int(db.parents[gid])
            pick = chain[-depth] if len(chain) >= depth else chain[0] \
                if chain else 0
            name = db.frames[pick].pretty()
            area[name] = area.get(name, 0.0) + dur
    rows = sorted(area.items(), key=lambda kv: -kv[1])[:top]
    return [(n, v / total if total else 0.0) for n, v in rows]
