"""Overhead-budgeted adaptive sampling (ISSUE 7 tentpole).

The paper's worst-case overhead (§8.1: 1.85x-2.24x) is the *unthrottled*
figure; always-on production profiling needs the tool to measure its own
dispatch-path cost and throttle itself to a budget.  The profiler
already self-accounts (``Profiler.overhead_counters``: tool ns vs app ns
per dispatch); the governor closes the loop.

Control law (docs/serving.md):

- fidelity is a discrete ladder of ``GovernorLevel``s, from full
  measurement (deep unwinds, unthrottled PC sampling) down to a *floor*
  that still measures every dispatch (coarse timing + tracing + one PC
  sample) — measurement is **never fully disabled**;
- every ``interval`` dispatches the governor reads the overhead of the
  window just passed: ``(tool_ns + deferred_ns) / app_ns``.  With the
  wait-free dispatch path the PC-sample draw and attribution run on the
  monitor thread (``deferred_ns``), not on the dispatch path
  (``tool_ns``) — but they still burn a core, so the budget governs the
  tool's *total* measurement cost, and the sampling knobs still have a
  signal to act on.  Over budget -> step one level down (less fidelity)
  immediately.  Under ``budget * headroom`` for ``patience`` consecutive
  windows -> step one level up (hysteresis, so the controller doesn't
  hunt on noise);
- **SLO shed**: ``observe(p99_ms=...)`` optionally carries the serving
  loop's rolling p99 latency.  The governor keeps an EMA baseline of it
  (``slo_alpha``); a window whose p99 exceeds the baseline by more than
  ``slo_degradation`` (fractional) sheds one level even when the
  overhead budget is met — measurement cost that doesn't show up in
  tool/app (cache pressure, monitor-core contention) still shows up in
  tail latency.  Fidelity never rises while degraded, and the baseline
  only learns from non-degraded windows (the incident doesn't poison
  the reference);
- fleet backpressure composes: while ``note_backpressure(True)`` is in
  effect (the ShardProducer's ``throttled`` flag, fed by the daemon's
  spool depth), the governor will not raise fidelity and steps down one
  extra level — a deep aggregation spool means the fleet wants *less*
  telemetry, not more.

Levels mutate only the profiler's runtime knobs (``sample_scale``,
``sample_cap``, ``unwind_depth``) — no restart, no data loss, and the
knobs are read per dispatch so a decision takes effect on the very next
one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GovernorLevel:
    """One rung of the fidelity ladder."""
    name: str
    sample_scale: float            # multiplies Profiler.sample_rate_hz
    sample_cap: Optional[int]      # max PC samples per dispatch
    unwind_depth: int              # host unwind depth (0 = <app> frame)


# Fidelity ladder, full -> floor.  The floor still times and traces
# every dispatch and draws one PC sample (the sample budget never
# rounds below one) — the "never off" contract.
#
# Rung costs, re-tuned for the wait-free dispatch path: sample_scale /
# sample_cap shed *monitor-side* cost (the deferred draw + attribution,
# the dominant term), while unwind_depth trims the dispatch-side
# context-memo key walk — cheap once cached, so the middle rungs keep
# deeper unwinds than they used to and lean on tighter caps instead.
LEVELS: Tuple[GovernorLevel, ...] = (
    GovernorLevel("full", 1.0, None, 64),
    GovernorLevel("sampled-1/4", 0.25, 2048, 64),
    GovernorLevel("sampled-1/16", 1.0 / 16, 512, 32),
    GovernorLevel("sampled-1/64", 1.0 / 64, 64, 16),
    GovernorLevel("coarse", 0.0, 1, 0),
)


@dataclasses.dataclass
class GovernorConfig:
    budget: float = 0.05        # max (tool+deferred) ns / app ns
    headroom: float = 0.5       # raise fidelity only below budget*headroom
    interval: int = 64          # dispatches per control window
    patience: int = 3           # consecutive low windows before stepping up
    start_level: int = 0
    slo_degradation: float = 0.5   # shed when p99 > baseline * (1 + this)
    slo_alpha: float = 0.2         # EMA weight for the p99 baseline

    def __post_init__(self):
        if not 0 < self.budget:
            raise ValueError("budget must be positive")
        if not 0 <= self.headroom <= 1:
            raise ValueError("headroom must be in [0, 1]")
        if self.interval < 1 or self.patience < 1:
            raise ValueError("interval and patience must be >= 1")
        if not self.slo_degradation > 0:
            raise ValueError("slo_degradation must be positive")
        if not 0 < self.slo_alpha <= 1:
            raise ValueError("slo_alpha must be in (0, 1]")


@dataclasses.dataclass
class Decision:
    """One control decision (the ``history`` record tests pin)."""
    dispatches: int             # cumulative dispatch count at decision
    overhead: float             # tool/app over the window just closed
    level: int                  # level in effect AFTER the decision


class OverheadGovernor:
    """Feedback controller keeping the profiler's measured dispatch
    overhead under ``config.budget`` by walking the ``LEVELS`` ladder.

    ``observe()`` is designed to be called once per dispatch (or per
    request) from the serving loop — it is a counter compare until a
    control window of ``interval`` dispatches has passed, then one
    decision.  The governor holds no timing state of its own; the
    profiler's cumulative counters are the single source of truth, so
    any number of observers stay consistent.
    """

    def __init__(self, profiler, config: Optional[GovernorConfig] = None,
                 levels: Tuple[GovernorLevel, ...] = LEVELS):
        if not levels:
            raise ValueError("need at least one governor level")
        self.profiler = profiler
        self.config = config or GovernorConfig()
        self.levels = tuple(levels)
        self.level = min(self.config.start_level, len(self.levels) - 1)
        self.history: List[Decision] = []
        self.backpressured = False
        self.throttle_downs = 0
        self.throttle_ups = 0
        self._low_streak = 0
        self._last = dict(profiler.overhead_counters())
        self.slo_baseline_ms: Optional[float] = None
        self.slo_degraded = False
        self.slo_sheds = 0
        self._apply()

    # -- knob application ---------------------------------------------------
    def _apply(self) -> None:
        lv = self.levels[self.level]
        self.profiler.sample_scale = lv.sample_scale
        self.profiler.sample_cap = lv.sample_cap
        self.profiler.unwind_depth = lv.unwind_depth

    def _step(self, delta: int) -> None:
        new = min(max(self.level + delta, 0), len(self.levels) - 1)
        if new != self.level:
            if delta > 0:
                self.throttle_downs += 1
            else:
                self.throttle_ups += 1
            self.level = new
            self._apply()

    # -- feedback -----------------------------------------------------------
    def note_backpressure(self, throttled: bool) -> None:
        """Feed the fleet's backpressure signal (ShardProducer.throttled,
        itself fed by FleetDaemon spool depth).  Taking effect at the
        next decision: never raise fidelity while backpressured, and
        shed one extra level on the transition to throttled."""
        if throttled and not self.backpressured:
            self._step(+1)
        self.backpressured = bool(throttled)

    @staticmethod
    def _tool_total(c: dict) -> int:
        # dispatch-path cost + the monitor-side deferred draw/attribution
        # cost (absent from stub profilers that predate deferral)
        return c["tool_ns"] + c.get("deferred_ns", 0)

    def overhead(self) -> float:
        """Cumulative measured tool overhead, (tool + deferred)/app."""
        c = self.profiler.overhead_counters()
        return self._tool_total(c) / max(c["app_ns"], 1)

    def _slo_check(self, p99_ms: Optional[float]) -> bool:
        """Update the SLO state for one closed window; True = degraded."""
        if p99_ms is None or p99_ms <= 0:
            # no latency signal this window: keep the baseline, and a
            # prior degraded verdict stands until a healthy p99 clears it
            return self.slo_degraded
        cfg = self.config
        base = self.slo_baseline_ms
        if base is not None and p99_ms > base * (1.0 + cfg.slo_degradation):
            self.slo_degraded = True
            return True
        self.slo_degraded = False
        # learn only from non-degraded windows
        self.slo_baseline_ms = p99_ms if base is None else \
            (1.0 - cfg.slo_alpha) * base + cfg.slo_alpha * p99_ms
        return False

    def observe(self, p99_ms: Optional[float] = None) -> Optional[Decision]:
        """One control step; returns the Decision when a window closed
        (every ``config.interval`` dispatches), else None.

        ``p99_ms``: the serving loop's current rolling p99 latency
        (ServingStats), when it has one — the SLO-shed input."""
        counters = self.profiler.overhead_counters()
        dn = counters["dispatches"] - self._last["dispatches"]
        if dn < self.config.interval:
            return None
        tool = self._tool_total(counters) - self._tool_total(self._last)
        app = counters["app_ns"] - self._last["app_ns"]
        self._last = dict(counters)
        overhead = tool / max(app, 1)
        cfg = self.config
        degraded = self._slo_check(p99_ms)
        if degraded:
            # tail latency blew past the rolling baseline: shed even
            # under budget, and reset the step-up streak
            self._low_streak = 0
            self.slo_sheds += 1
            self._step(+1)
        elif overhead > cfg.budget:
            self._low_streak = 0
            self._step(+1)
        elif overhead < cfg.budget * cfg.headroom and not self.backpressured:
            self._low_streak += 1
            if self._low_streak >= cfg.patience:
                self._low_streak = 0
                self._step(-1)
        else:
            self._low_streak = 0
        decision = Decision(counters["dispatches"], overhead, self.level)
        self.history.append(decision)
        return decision

    # -- introspection ------------------------------------------------------
    def state(self) -> dict:
        """Live governor state for ``ServingStats``/telemetry export."""
        last = self.history[-1] if self.history else None
        return {
            "level": self.level,
            "level_name": self.levels[self.level].name,
            "n_levels": len(self.levels),
            "budget": self.config.budget,
            "overhead": last.overhead if last else 0.0,
            "overhead_total": self.overhead(),
            "decisions": len(self.history),
            "throttle_downs": self.throttle_downs,
            "throttle_ups": self.throttle_ups,
            "backpressured": self.backpressured,
            "slo_baseline_ms": self.slo_baseline_ms or 0.0,
            "slo_degraded": self.slo_degraded,
            "slo_sheds": self.slo_sheds,
        }
