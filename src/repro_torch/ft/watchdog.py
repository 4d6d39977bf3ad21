"""Fault tolerance: straggler watchdog, restart policy, elastic re-mesh.

At 1000+ nodes the failure model is: hosts disappear (hardware), hosts
straggle (thermal / network / noisy neighbors), and the job must resume
from the last atomic checkpoint on whatever healthy capacity remains.

- ``StragglerWatchdog`` consumes per-host step heartbeats (in production:
  a side channel or the coordination service; in tests: direct calls) and
  flags hosts whose progress lags the fleet median by more than a
  threshold, or whose heartbeat went stale.
- ``RestartPolicy`` is exponential-backoff with a restart budget per
  rolling window — the supervisor decides *whether* to relaunch.
- ``plan_elastic_mesh`` maps surviving device counts to the largest
  supported (pod, data, model) mesh <= capacity, keeping the model axis
  fixed (TP degree is baked into layer shapes) and shrinking data/pod —
  with the checkpoint manager's elastic restore, training resumes on the
  new mesh with a reduced global batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Heartbeat:
    host: str
    step: int
    t: float


class StragglerWatchdog:
    def __init__(self, *, stale_s: float = 300.0, lag_steps: int = 10,
                 clock=time.monotonic):
        self.stale_s = stale_s
        self.lag_steps = lag_steps
        self.clock = clock
        self._last: Dict[str, Heartbeat] = {}
        self._step_times: Dict[str, List[float]] = {}

    def beat(self, host: str, step: int, t: Optional[float] = None):
        t = self.clock() if t is None else t
        prev = self._last.get(host)
        if prev is not None and step > prev.step:
            self._step_times.setdefault(host, []).append(
                (t - prev.t) / (step - prev.step))
            self._step_times[host] = self._step_times[host][-32:]
        self._last[host] = Heartbeat(host, step, t)

    def median_step(self) -> int:
        steps = sorted(h.step for h in self._last.values())
        return steps[len(steps) // 2] if steps else 0

    def stragglers(self, now: Optional[float] = None) -> List[str]:
        """Hosts stale or >= lag_steps behind the fleet median."""
        now = self.clock() if now is None else now
        med = self.median_step()
        out = []
        for host, hb in self._last.items():
            if now - hb.t > self.stale_s:
                out.append(host)
            elif med - hb.step >= self.lag_steps:
                out.append(host)
        return sorted(out)

    def slow_hosts(self, factor: float = 1.5) -> List[str]:
        """Hosts whose mean step time exceeds factor x fleet median —
        the mitigation driver (e.g. exclude from the next elastic plan)."""
        means = {h: sum(v) / len(v) for h, v in self._step_times.items() if v}
        if not means:
            return []
        med = sorted(means.values())[len(means) // 2]
        return sorted(h for h, m in means.items() if m > factor * med)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 10
    window_s: float = 3600.0
    backoff_base_s: float = 10.0
    backoff_max_s: float = 600.0

    def __post_init__(self):
        self._events: List[float] = []

    def record_failure(self, t: float) -> None:
        self._events.append(t)

    def should_restart(self, t: float) -> bool:
        recent = [e for e in self._events if t - e <= self.window_s]
        return len(recent) <= self.max_restarts

    def backoff_s(self) -> float:
        n = len(self._events)
        return min(self.backoff_base_s * (2 ** max(n - 1, 0)),
                   self.backoff_max_s)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    excluded_hosts: Tuple[str, ...]
    global_batch_scale: float        # new_global_batch / old_global_batch
    resume_step: Optional[int]


def plan_elastic_mesh(n_devices: int, *, model: int = 16,
                      devices_per_host: int = 4,
                      excluded_hosts: Sequence[str] = (),
                      old_data: int = 16, pods: int = 1,
                      resume_step: Optional[int] = None) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits the surviving devices.

    The model axis stays fixed (TP degree is shape-baked); data shrinks to
    the largest power of two <= capacity / (model * pods); if even data=1
    does not fit, pods collapse first.
    """
    assert n_devices >= model, "cannot keep TP degree on surviving devices"
    while pods > 1 and n_devices < pods * model:
        pods //= 2
    data = 1
    while pods * model * data * 2 <= n_devices:
        data *= 2
    shape: Tuple[int, ...]
    if pods > 1:
        shape, axes = (pods, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    return ElasticPlan(
        mesh_shape=shape, mesh_axes=axes,
        excluded_hosts=tuple(sorted(excluded_hosts)),
        global_batch_scale=(pods * data) / max(old_data, 1),
        resume_step=resume_step,
    )
