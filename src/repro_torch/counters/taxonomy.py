"""Backend-neutral hardware-counter taxonomy (paper §6; THAPI
arXiv:2504.03683 motivates one uniform counter vocabulary across
heterogeneous backends).

On NVIDIA GPUs HPCToolkit collects kernel-granularity counters through
CUPTI's profiling API: each *counter* is sourced by one hardware *domain*
(SM, L2, DRAM, NVLink, ...), and each domain has a small number of
physical counter registers, so a request that exceeds a domain's register
budget must be split into *groups* collected over multiple passes
(serialized kernel replay, or statistical multiplexing across
invocations).  PAPI exposes the same model one level up.

This module is the backend-neutral half of that design: a catalog of
named counters, each tagged with the domain that sources it, the
per-domain register capacities, and units/descriptions for reporting.
The TPU/Pallas *backend* half (how a counter value is actually produced
from ``compiled.cost_analysis()`` + the HLO structure parse) lives in
``repro.counters.collector``; the group packing lives in
``repro.counters.scheduler``.

The counter *names* double as the member metrics of the ``gpu_counter``
metric kind (``repro.core.metrics.GPU_COUNTER_METRICS``) so that counter
values land in profiles as one more sparse kind and survive aggregation
unchanged; the catalog validates itself against that tuple at import
time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

from repro_torch.core.metrics import GPU_COUNTER_KIND, GPU_COUNTER_METRICS

# The tool domain is never multiplexed: its "counters" (elapsed time,
# replay bookkeeping) are available on every pass for free.
TOOL_DOMAIN = "tool"


@dataclasses.dataclass(frozen=True)
class Counter:
    """One catalog entry: a backend-neutral counter name plus the
    hardware domain whose registers source it."""
    name: str
    domain: str
    unit: str
    description: str

    @property
    def schedulable(self) -> bool:
        return self.domain != TOOL_DOMAIN


# Physical counter registers per domain and pass — the constraint the
# group scheduler packs against.  (CUPTI exposes exactly this shape:
# ``maxEventsPerGroup`` per domain.)
DOMAIN_CAPACITY: Dict[str, int] = {
    "compute": 2,
    "memory": 2,
    "collective": 1,
    "scheduler": 2,
    TOOL_DOMAIN: 1 << 30,
}

_CATALOG_ROWS: Tuple[Tuple[str, str, str, str], ...] = (
    ("flops", "compute", "flop",
     "floating-point operations executed (trip-count scaled)"),
    ("mxu_flops", "compute", "flop",
     "matrix-unit flops (dot/convolution ops)"),
    ("transcendental_ops", "compute", "op",
     "transcendental-function element evaluations"),
    ("hbm_read_bytes", "memory", "byte",
     "bytes read from device memory (operand traffic)"),
    ("hbm_write_bytes", "memory", "byte",
     "bytes written to device memory (result traffic)"),
    ("hbm_bytes", "memory", "byte",
     "total device-memory traffic (read + write)"),
    ("ici_wire_bytes", "collective", "byte",
     "bytes crossing the interconnect (ring-model wire bytes)"),
    ("collective_invocations", "collective", "op",
     "collective operations executed"),
    ("inst_executed", "scheduler", "inst",
     "executed 'instructions' (HLO ops, trip-count scaled)"),
    ("active_ns", "scheduler", "ns",
     "modeled busy time (roofline max-term per op, summed)"),
    ("elapsed_ns", TOOL_DOMAIN, "ns",
     "kernel wall time (always collected)"),
    ("replay_passes", TOOL_DOMAIN, "pass",
     "measurement passes taken for this kernel execution"),
)

CATALOG: Dict[str, Counter] = {
    name: Counter(name, domain, unit, desc)
    for name, domain, unit, desc in _CATALOG_ROWS
}

# kind-local index of every counter, in GPU_COUNTER_METRICS order
COUNTER_INDEX: Dict[str, int] = {n: i
                                 for i, n in enumerate(GPU_COUNTER_METRICS)}

assert tuple(CATALOG) == GPU_COUNTER_METRICS, \
    "counter catalog out of sync with metrics.GPU_COUNTER_METRICS"
assert all(c.domain in DOMAIN_CAPACITY for c in CATALOG.values())

ALL_COUNTERS: Tuple[str, ...] = tuple(CATALOG)
KIND_NAME = GPU_COUNTER_KIND


def resolve(names: Iterable[str]) -> List[Counter]:
    """Validate and resolve counter names (order-preserving, deduped)."""
    out: List[Counter] = []
    seen = set()
    for n in names:
        if n not in CATALOG:
            raise KeyError(f"unknown counter {n!r}; catalog: "
                           f"{', '.join(ALL_COUNTERS)}")
        if n not in seen:
            seen.add(n)
            out.append(CATALOG[n])
    return out


def describe() -> str:
    """Aligned text catalog (used by docs/examples)."""
    w = max(len(c.name) for c in CATALOG.values())
    lines = []
    for c in CATALOG.values():
        cap = DOMAIN_CAPACITY[c.domain]
        cap_s = "free" if not c.schedulable else f"cap={cap}"
        lines.append(f"{c.name:<{w}}  {c.domain:<10} {cap_s:<6} "
                     f"[{c.unit}] {c.description}")
    return "\n".join(lines)
