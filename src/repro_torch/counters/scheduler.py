"""Counter group scheduling (paper §6; CUPTI/PAPI multiplexing model).

A request for counters that exceeds some hardware domain's register
budget cannot be satisfied in one pass.  The scheduler packs the
requested counters into *compatible groups* — each group fits every
domain's per-pass capacity — and the collector then either

- **replays** the kernel once per group (the paper's serialized kernel
  replay: deterministic, every counter measured on every kernel
  execution), or
- **multiplexes** groups round-robin across successive kernel
  invocations in single-pass best-effort mode, scaling each reading by
  the group count so long-run totals remain unbiased estimates of the
  replay totals (the PAPI multiplexing convention).

Packing is first-fit in request order, which is deterministic and
optimal for per-domain capacities: the number of groups equals
``max_d ceil(n_requested_in_domain_d / capacity_d)`` (asserted by
tests/test_counters.py), so every requested counter is covered in at
most that many passes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

from repro_torch.counters.taxonomy import (Counter, DOMAIN_CAPACITY, resolve)


@dataclasses.dataclass(frozen=True)
class CounterGroup:
    """One compatible set: collectible together in a single pass."""
    index: int
    counters: Tuple[str, ...]

    def __len__(self) -> int:
        return len(self.counters)


@dataclasses.dataclass(frozen=True)
class MultiplexSchedule:
    """The pass plan for one request."""
    requested: Tuple[str, ...]          # schedulable counters, request order
    free: Tuple[str, ...]               # tool-domain: collected every pass
    groups: Tuple[CounterGroup, ...]

    @property
    def n_passes(self) -> int:
        """Replay passes needed to cover every requested counter."""
        return max(len(self.groups), 1)

    @property
    def multiplexed(self) -> bool:
        return len(self.groups) > 1

    def group_for(self, invocation: int) -> CounterGroup:
        """Round-robin group for the i-th kernel invocation
        (single-pass best-effort mode)."""
        if not self.groups:
            return CounterGroup(0, ())
        return self.groups[invocation % len(self.groups)]

    def coverage(self) -> frozenset:
        out = set(self.free)
        for g in self.groups:
            out.update(g.counters)
        return frozenset(out)

    def describe(self) -> str:
        lines = [f"schedule: {len(self.requested)} counters -> "
                 f"{len(self.groups)} group(s), {self.n_passes} pass(es)"]
        for g in self.groups:
            lines.append(f"  pass {g.index}: {', '.join(g.counters)}")
        if self.free:
            lines.append(f"  every pass: {', '.join(self.free)}")
        return "\n".join(lines)


def build_schedule(names: Iterable[str],
                   capacity: Dict[str, int] = DOMAIN_CAPACITY
                   ) -> MultiplexSchedule:
    """Pack requested counters into compatible groups (first-fit in
    request order against per-domain capacities)."""
    counters = resolve(names)
    free = tuple(c.name for c in counters if not c.schedulable)
    sched = [c for c in counters if c.schedulable]

    packs: List[List[Counter]] = []
    remaining: List[Dict[str, int]] = []    # per group: domain -> left
    for c in sched:
        for gi, left in enumerate(remaining):
            if left.get(c.domain, capacity.get(c.domain, 1)) > 0:
                left[c.domain] = left.get(
                    c.domain, capacity.get(c.domain, 1)) - 1
                packs[gi].append(c)
                break
        else:
            packs.append([c])
            remaining.append(
                {c.domain: capacity.get(c.domain, 1) - 1})

    groups = tuple(CounterGroup(i, tuple(c.name for c in pack))
                   for i, pack in enumerate(packs))
    return MultiplexSchedule(tuple(c.name for c in sched), free, groups)


def optimal_passes(names: Sequence[str],
                   capacity: Dict[str, int] = DOMAIN_CAPACITY) -> int:
    """Lower bound on passes: the tightest domain's ceil(n / cap).
    First-fit meets this bound (test_counters asserts equality)."""
    per_domain: Dict[str, int] = {}
    for c in resolve(names):
        if c.schedulable:
            per_domain[c.domain] = per_domain.get(c.domain, 0) + 1
    if not per_domain:
        return 1
    return max(-(-n // capacity.get(d, 1)) for d, n in per_domain.items())
