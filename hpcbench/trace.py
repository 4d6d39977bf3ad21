"""The traced run's reading of a torch.profiler trace.

A traced segment is a few whole units (prefill batches, train steps) of
the measured window under ``torch.profiler`` with host and device
activity.  Its chrome trace is reduced here to what the per-layer
readers take (``summarize``): the device's busy time (the union of its
kernels, copies and fills), the segment's length, device seconds and
records by kernel name, the device seconds of each named scope (a
``record_function`` range of the program, such as the train step's
``fwd_bwd`` and ``optimizer``), the device operations that took most
time and the longest idle gaps by what the host was doing (the
``LABELLED`` longest, by the latest-started host event that spans each).

The segment runs after the measured window, so that the profiler's own
cost (large on a host-bound step) stays out of the window's numbers.
torch.profiler has been seen to drop device records on the H100 once
the port's profiler has drawn PC samples in the process.  So a segment
is accepted only when, for each kernel the traffic names, its device
records equal the launches that the port's own counter saw in the
segment; otherwise the next units are traced again (``Segments``), and a
run with no accepted segment after ``attempts`` fails.  It never reads
from a short trace.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
TOP = 10
LABELLED = 500           # idle gaps labelled by the host's activity
WALK = 64                # host events a gap's label search walks back


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float,
                                                                 float]]:
    """The idle gaps (start, end) between the union's pieces."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def _label_gaps(host_s, host_e, host_n, names, idle) -> Dict[str, float]:
    """Seconds of the ``LABELLED`` longest idle gaps (microseconds), by
    the name of the host event that spans each gap's middle and started
    last: with host events sorted by start, the search walks back from
    the last one that starts before the middle to the first that has not
    ended by then (at most ``WALK`` events, then all of them)."""
    by_name: Dict[str, float] = {}
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:LABELLED]
    order = np.argsort(host_s, kind="stable")
    starts, ends, who = host_s[order], host_e[order], host_n[order]
    for s, e in idle:
        t = (s + e) / 2
        j = int(np.searchsorted(starts, t, side="right"))
        lo = max(j - WALK, 0)
        inside = np.flatnonzero(ends[lo:j] >= t) + lo
        if not inside.size and lo:
            inside = np.flatnonzero(ends[:lo] >= t)
        name = names[who[inside[-1]]] if inside.size else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return by_name


def scope_seconds(events: list, scopes: Sequence[str]) -> Dict[str, float]:
    """Device seconds by named scope: each kernel, copy or fill goes to
    the range named in ``scopes`` that holds the host call which launched
    it (matched by correlation id), whatever thread made the call (the
    autograd engine runs a backward in a thread of its own, inside the
    scope that called it).  Work launched outside every range is
    ``none``."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in scopes and "dur" in e)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = dict.fromkeys(tuple(scopes) + ("none",), 0.0)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        hit = next((name for s, end, name in ranges
                    if ts is not None and s <= ts <= end), "none")
        out[hit] += float(e["dur"]) / 1e6
    return out


def summarize(events: list, scopes: Sequence[str] = ()) -> dict:
    """Reduce chrome-trace events (times in microseconds) to seconds:
    ``busy_s``; ``kernels`` {name: [seconds, records]}; ``scopes``
    {scope: device seconds} (``scope_seconds``, with ``scopes`` given);
    ``device_ops`` and ``idle_gaps``, the ``TOP`` largest [name,
    seconds]."""
    spans = []
    kernels: Dict[str, list] = {}
    host_s, host_e, host_n = [], [], []
    name_ix: Dict[str, int] = {}
    for e in events:
        cat = e.get("cat")
        if "dur" not in e or cat is None:
            continue
        ts = float(e["ts"])
        end = ts + float(e["dur"])
        if cat in DEVICE_CATS:
            spans.append((ts, end))
            k = kernels.setdefault(e.get("name", "?"), [0.0, 0])
            k[0] += (end - ts) / 1e6
            k[1] += 1
        elif cat in HOST_CATS:
            host_s.append(ts)
            host_e.append(end)
            host_n.append(name_ix.setdefault(e["name"], len(name_ix)))
    names = list(name_ix)
    by_gap = _label_gaps(np.array(host_s), np.array(host_e),
                         np.array(host_n, dtype=np.int64), names,
                         gaps(spans)) if host_s else {}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"busy_s": union_seconds(spans) / 1e6,
            "kernels": kernels,
            "scopes": scope_seconds(events, scopes) if scopes else {},
            "device_ops": [[n, v[0]] for n, v in top],
            "idle_gaps": sorted(([n, s] for n, s in by_gap.items()),
                                key=lambda x: -x[1])[:TOP]}


def records_matching(summary: dict, pattern: str) -> Tuple[float, int]:
    """(device seconds, records) of the kernels whose name matches."""
    rx = re.compile(pattern)
    secs, n = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if rx.search(name):
            secs += s
            n += c
    return secs, n


class Segments:
    """Traces ``units`` consecutive units at a time, after the measured
    window, until one segment's device records agree with the port's
    launch counters or ``attempts`` segments are spent.

    ``checks``: [(kernel-name pattern, launch counter callable)].
    ``result`` holds the accepted segment's summary with ``window_s``
    (host seconds of the segment, synchronised at both ends), ``units``,
    ``launches`` and ``records`` {pattern: count} and ``costs`` (seconds
    spent stopping the profiler, exporting, loading and reducing the
    trace); ``rejected`` lists the segments whose records fell short.
    ``scopes``: the named scopes whose device seconds the summary
    carries."""

    def __init__(self, units: int, attempts: int,
                 checks: Sequence[Tuple[str, Callable]], trace_dir: str,
                 sync: Callable[[], None], scopes: Sequence[str] = ()):
        self.units = units
        self.scopes = tuple(scopes)
        self.attempts = attempts
        self.checks = list(checks)
        self.trace_dir = trace_dir
        self.sync = sync
        self.result: Optional[dict] = None
        self.rejected: List[dict] = []

    def take(self, run_unit: Callable[[int], object], first: int) -> int:
        """Run units ``first``, ``first + 1``, ... under torch.profiler
        until a segment is accepted; returns the next unit's index."""
        from torch.profiler import ProfilerActivity, profile
        i = first
        for _ in range(self.attempts):
            c0 = [fn() for _, fn in self.checks]
            self.sync()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
            for _ in range(self.units):
                run_unit(i)
                i += 1
            self.sync()
            t1 = time.perf_counter()
            prof.__exit__(None, None, None)
            t2 = time.perf_counter()
            launched = {pat: fn() - c
                        for (pat, fn), c in zip(self.checks, c0)}
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, "segment.json")
            prof.export_chrome_trace(path)
            del prof
            nbytes = os.path.getsize(path)
            t3 = time.perf_counter()
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(path)
            t4 = time.perf_counter()
            summary = summarize(events, self.scopes)
            del events
            found = {pat: records_matching(summary, pat)[1]
                     for pat in launched}
            summary.update(window_s=t1 - t0, units=self.units,
                           launches=launched, records=found,
                           costs={"stop": t2 - t1, "export": t3 - t2,
                                  "load": t4 - t3,
                                  "reduce": time.perf_counter() - t4,
                                  "trace_bytes": nbytes})
            if all(found[p] == n for p, n in launched.items()):
                self.result = summary
                break
            self.rejected.append({"launches": launched, "records": found})
        return i
