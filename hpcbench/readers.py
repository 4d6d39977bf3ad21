"""Arithmetic the per-layer readers (``metrics/<name>.py``) share.

Each takes the record a driver hands the readers and returns a number or
None where the record holds nothing to read: ``rec["window"]`` the
measured window's units and seconds, ``rec["trace"]`` the accepted
traced segment after it (``trace.Segments``), ``rec["work"]`` the frozen
work counts of one unit and of each kernel call (``reference/work.py``),
``rec["counters"]`` and ``rec["spans"]`` what the program reported.  A
share is in percent and is never clamped: a reading above 100 means the
work is counted too high or the time leaves part of it out.
"""
from __future__ import annotations

from typing import Optional

from hpcbench import trace as trace_mod
from hpcbench.reference import work


def mfu(rec: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the measured window's units over (its seconds x the
    card's bf16 peak), in percent."""
    win = rec.get("window")
    if rec.get("kind") != kind or not win or win["seconds"] <= 0:
        return None
    flops = rec["work"]["unit_flops"] * win["units"]
    return 100.0 * flops / (win["seconds"] * work.PEAK_FLOPS)


def idle_share(rec: dict, kind: str) -> Optional[float]:
    """The share of the measured window in which nothing ran on the
    device: 1 - (device busy seconds a unit in the traced segment) / (the
    window's seconds a unit).  The tracer slows the host, not the
    device, so busy time comes from the trace and the time a unit from
    the untraced window."""
    seg, win = rec.get("trace"), rec.get("window")
    if rec.get("kind") != kind or not seg or not win or win["units"] <= 0 \
            or win["seconds"] <= 0 or seg["busy_s"] <= 0:
        return None
    per_unit = win["seconds"] / win["units"]
    return 100.0 * (1.0 - seg["busy_s"] / seg["units"] / per_unit)


def scope_ms(rec: dict, kind: str, scope: str) -> Optional[float]:
    """Device ms a unit under the program's named scope ``scope`` in the
    traced segment; None where the segment holds no device time there."""
    seg = rec.get("trace")
    if rec.get("kind") != kind or not seg:
        return None
    secs = seg.get("scopes", {}).get(scope, 0.0)
    if secs <= 0:
        return None
    return 1e3 * secs / seg["units"]


def roofline(rec: dict, kind: str, pattern: str) -> Optional[float]:
    """The kernel's bound time (frozen work at the card's peaks) over its
    mean device time a call, in percent; None without records."""
    seg = rec.get("trace")
    per_call = rec.get("work", {}).get("kernels", {}).get(pattern)
    if rec.get("kind") != kind or not seg or per_call is None:
        return None
    secs, n = trace_mod.records_matching(seg, pattern)
    if n == 0 or secs <= 0:
        return None
    return 100.0 * work.bound_seconds(*per_call) / (secs / n)
