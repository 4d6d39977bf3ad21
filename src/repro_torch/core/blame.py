"""GPU-idleness blame analysis (paper §7.2, §8.5 — the Nyx case study).

Identify intervals where *all* GPU streams are idle while at least one CPU
thread is active; partition the idle time equally across the active CPU
contexts.  CPU routines with high blame are optimization candidates (the
paper removes a cuCtxSynchronize and a JIT-compile stall this way).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.trace import TraceData


def idle_segments(cpu_traces: Sequence[TraceData],
                  gpu_traces: Sequence[TraceData]):
    """Yield (t0, t1, active cpu ctx set) for every elementary segment
    where zero GPU streams are active and >= 1 CPU thread is.

    Sweep-line over all interval boundaries; ``blame_gpu_idleness`` folds
    the segments, and ``traceview.stats.blame_over_time`` bins them — one
    sweep, one set of boundary semantics.
    """
    events: List[Tuple[int, int, int, int]] = []  # (t, kind, delta, ctx)
    GPU, CPU = 0, 1
    for tr in gpu_traces:
        for s, e in zip(tr.starts, tr.ends):
            events.append((int(s), GPU, +1, -1))
            events.append((int(e), GPU, -1, -1))
    for tr in cpu_traces:
        for s, e, c in zip(tr.starts, tr.ends, tr.ctx):
            events.append((int(s), CPU, +1, int(c)))
            events.append((int(e), CPU, -1, int(c)))
    if not events:
        return
    events.sort()
    gpu_active = 0
    cpu_active: Dict[int, int] = {}
    t_prev = events[0][0]
    for t, kind, delta, ctx in events:
        if t > t_prev and gpu_active == 0 and cpu_active:
            yield t_prev, t, set(cpu_active)
        t_prev = t
        if kind == GPU:
            gpu_active += delta
        else:
            n = cpu_active.get(ctx, 0) + delta
            if n <= 0:
                cpu_active.pop(ctx, None)
            else:
                cpu_active[ctx] = n


def blame_gpu_idleness(cpu_traces: Sequence[TraceData],
                       gpu_traces: Sequence[TraceData],
                       ) -> Tuple[Dict[int, float], float]:
    """Returns ({cpu ctx id: blamed idle ns}, total idle ns).

    Each all-streams-idle segment's length is split evenly among the CPU
    contexts active during it (normalized blame, §7.2).
    """
    blame: Dict[int, float] = {}
    total_idle = 0.0
    for t0, t1, active in idle_segments(cpu_traces, gpu_traces):
        seg = t1 - t0
        total_idle += seg
        share = seg / len(active)
        for c in active:
            blame[c] = blame.get(c, 0.0) + share
    return blame, total_idle


def blame_report(blame: Dict[int, float], total_idle: float, db,
                 top: int = 10) -> List[Tuple[str, float]]:
    """Ranked (context name, normalized blame) list, §7.2 style."""
    rows = []
    for ctx, ns in blame.items():
        name = (db.frames[ctx].pretty() if ctx < len(db.frames)
                else f"ctx{ctx}")
        rows.append((name, ns / total_idle if total_idle else 0.0))
    rows.sort(key=lambda r: -r[1])
    return rows[:top]
