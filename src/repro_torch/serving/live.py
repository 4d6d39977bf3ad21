"""The always-on serving profiler (ISSUE 7 tentpole): one object a
serving process keeps next to its model.

Wraps the measurement ``Profiler`` with the three production layers:

- **windows** — ``request(rid, phase)`` stamps per-request/per-phase
  identities into every dispatch (repro.serving.window) and feeds the
  latency stats;
- **governor** — an ``OverheadGovernor`` throttles sampling fidelity to
  the configured overhead budget, fed per request by ``tick()``
  (repro.serving.governor), with fleet backpressure composed in;
- **telemetry** — a ``TelemetryExporter`` periodically ships
  epoch-tagged ``ServingStats`` snapshots through a ``ShardProducer``
  for exactly-once fleet aggregation (repro.serving.telemetry).

Minimal loop::

    sp = ServingProfiler(out_dir, producer=producer)
    with sp:
        for rid, prompt in requests:
            with sp.request(rid, "prefill", tokens=len(prompt)):
                with sp.profiler.dispatch("kernel", "prefill", ...):
                    ...
    print(sp.status())
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Union

from repro_torch.core.profiler import Profiler
from repro_torch.serving.governor import GovernorConfig, OverheadGovernor
from repro_torch.serving.stats import ServingStats
from repro_torch.serving.telemetry import TelemetryExporter
from repro_torch.serving.window import DECODE, PREFILL, RequestWindow


class ServingProfiler:
    def __init__(self, out_dir: str, *,
                 governor: Union[bool, GovernorConfig] = True,
                 producer=None, export_every_s: float = 5.0,
                 stats_window_s: float = 60.0, rank: int = 0,
                 tag: Optional[str] = None, rng_seed: Optional[int] = 0,
                 wall: Callable[[], float] = time.monotonic,
                 **profiler_kwargs):
        self.profiler = Profiler(out_dir, tracing=True, rank=rank,
                                 tag=tag, rng_seed=rng_seed,
                                 **profiler_kwargs)
        self.stats = ServingStats(window_s=stats_window_s, clock=wall)
        self.governor: Optional[OverheadGovernor] = None
        if governor:
            cfg = governor if isinstance(governor, GovernorConfig) else None
            self.governor = OverheadGovernor(self.profiler, cfg)
        self.producer = producer
        self.exporter = (TelemetryExporter(producer, rank=rank)
                         if producer is not None else None)
        self.export_every_s = export_every_s
        self.wall = wall
        self._last_export = wall()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingProfiler":
        self.profiler.start()
        return self

    def stop(self) -> None:
        self.profiler.flush()
        self.profiler.stop()

    def __enter__(self) -> "ServingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def write(self):
        return self.profiler.write()

    # -- the per-request surface --------------------------------------------
    def request(self, request_id, phase: str, *, tokens: int = 0
                ) -> "_TrackedWindow":
        """A measurement window that also records latency/throughput and
        runs one governor/export tick on close."""
        return _TrackedWindow(self, request_id, phase, tokens)

    def tick(self) -> None:
        """One cheap control step: poll backpressure into the governor,
        run a governor observation, export telemetry when due.  Called
        automatically when a ``request()`` window closes; long-running
        loops without windows may call it directly."""
        if self.producer is not None:
            poll = getattr(self.producer, "poll_backpressure", None)
            if poll is not None:
                poll()
            if self.governor is not None:
                self.governor.note_backpressure(self.producer.throttled)
        if self.governor is not None:
            # SLO feed: the worst current rolling p99 across phases (0.0
            # — no requests in the window yet — means no signal)
            p99 = max(self.stats.percentile_ms(PREFILL, 99),
                      self.stats.percentile_ms(DECODE, 99))
            self.governor.observe(p99_ms=p99 if p99 > 0 else None)
        if self.exporter is not None and \
                self.wall() - self._last_export >= self.export_every_s:
            self.export_now()

    def export_now(self) -> Optional[str]:
        """Export one telemetry epoch immediately; returns the shard id
        (None without a producer)."""
        if self.exporter is None:
            return None
        self._last_export = self.wall()
        return self.exporter.export(self.status())

    # -- the status surface -------------------------------------------------
    def status(self) -> dict:
        """The live health snapshot (ServingStats columns + governor
        state + export progress)."""
        snap = self.stats.snapshot(governor=self.governor,
                                   profiler=self.profiler,
                                   producer=self.producer)
        snap["epochs_exported"] = float(
            self.exporter.exported if self.exporter else 0)
        return snap


class _TrackedWindow(RequestWindow):
    """RequestWindow that reports into the owning ServingProfiler."""

    def __init__(self, owner: ServingProfiler, request_id, phase: str,
                 tokens: int):
        super().__init__(owner.profiler, request_id, phase)
        self._owner = owner
        self.tokens = tokens

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        self._owner.stats.record_window(self, tokens=self.tokens)
        self._owner.tick()
