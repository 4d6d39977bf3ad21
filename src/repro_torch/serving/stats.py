"""Rolling-window live serving telemetry (ISSUE 7 tentpole).

``ServingStats`` is the in-process view of a serving host's health:
request/phase latency percentiles, token throughput, the profiler's
measured overhead, the governor's throttle state, and the fleet
producer's backpressure — everything ``status()`` surfaces and the
``TelemetryExporter`` ships as epoch-tagged shards.

The window is time-based (default 60s of requests, bounded by
``maxlen``): ``record()`` is O(1), snapshots prune lazily.  All numbers
are plain floats so a snapshot serializes straight into the fixed
``SERVING_METRICS`` telemetry columns (repro.serving.telemetry).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.window import DECODE, PREFILL

# (wall_s, request_id, phase, duration_ns, tokens)
_Row = Tuple[float, str, str, int, int]


class ServingStats:
    """Rolling window over per-request phase records."""

    def __init__(self, *, window_s: float = 60.0, maxlen: int = 8192,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.clock = clock
        self._rows: Deque[_Row] = collections.deque(maxlen=maxlen)
        self.total_requests = 0
        self.total_tokens = 0

    # -- ingestion ----------------------------------------------------------
    def record(self, request_id, phase: str, duration_ns: int,
               tokens: int = 0) -> None:
        self._rows.append((self.clock(), str(request_id), str(phase),
                           int(duration_ns), int(tokens)))
        if phase == PREFILL:
            self.total_requests += 1
        self.total_tokens += int(tokens)

    def record_window(self, window, tokens: int = 0) -> None:
        """Record a closed ``RequestWindow`` directly."""
        self.record(window.request_id, window.phase or "serve",
                    window.duration_ns, tokens)

    # -- the window ---------------------------------------------------------
    def _live(self) -> List[_Row]:
        cutoff = self.clock() - self.window_s
        while self._rows and self._rows[0][0] < cutoff:
            self._rows.popleft()
        return list(self._rows)

    def latencies_ns(self, phase: str) -> np.ndarray:
        return np.asarray([r[3] for r in self._live() if r[2] == phase],
                          np.int64)

    def percentile_ms(self, phase: str, q: float) -> float:
        lat = self.latencies_ns(phase)
        if not len(lat):
            return 0.0
        return float(np.percentile(lat, q)) / 1e6

    def tok_s(self) -> float:
        rows = self._live()
        if not rows:
            return 0.0
        tokens = sum(r[4] for r in rows)
        span = max(rows[-1][0] - rows[0][0], 1e-9)
        # a single-record window has no span; fall back to its duration
        if len(rows) == 1:
            span = max(rows[0][3] / 1e9, 1e-9)
        return tokens / span

    def requests_in_window(self) -> int:
        return len({r[1] for r in self._live()})

    # -- the status surface -------------------------------------------------
    def snapshot(self, *, governor=None, profiler=None, producer=None
                 ) -> Dict[str, float]:
        """One flat numeric snapshot — the ``status()`` payload and the
        telemetry shard row.  Keys match ``SERVING_METRICS`` (plus a few
        extras ``status()`` shows but telemetry need not ship)."""
        snap = {
            "requests": float(self.requests_in_window()),
            "tokens": float(sum(r[4] for r in self._live())),
            "tok_s": self.tok_s(),
            "prefill_p50_ms": self.percentile_ms(PREFILL, 50),
            "prefill_p99_ms": self.percentile_ms(PREFILL, 99),
            "decode_p50_ms": self.percentile_ms(DECODE, 50),
            "decode_p99_ms": self.percentile_ms(DECODE, 99),
            "overhead_frac": 0.0,
            "governor_level": 0.0,
            "samples_kept": 0.0,
            "samples_dropped": 0.0,
            "spool_depth": 0.0,
            "throttled": 0.0,
        }
        if profiler is not None:
            c = profiler.overhead_counters()
            snap["overhead_frac"] = c["tool_ns"] / max(c["app_ns"], 1)
            snap["samples_kept"] = float(c["samples_kept"])
            snap["samples_dropped"] = float(c["samples_dropped"])
        if governor is not None:
            st = governor.state()
            snap["governor_level"] = float(st["level"])
            snap["overhead_frac"] = st["overhead_total"]
        if producer is not None:
            snap["throttled"] = 1.0 if producer.throttled else 0.0
            depth = getattr(producer, "daemon_spool_depth", None)
            if depth is not None:
                snap["spool_depth"] = float(depth)
        return snap
