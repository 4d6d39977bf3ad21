"""Kernel-granularity hardware-counter measurement (paper §6).

The paper supplements fine-grained PC sampling with *hardware performance
counters* read at kernel granularity.  This package is that measurement
mode for the JAX/Pallas stack:

- ``taxonomy``  — backend-neutral counter catalog + hardware domains and
  per-domain register capacities (THAPI-style uniform vocabulary);
- ``scheduler`` — packs requested counters into compatible groups and
  plans serialized-replay or round-robin multiplex passes (CUPTI/PAPI);
- ``collector`` — produces per-kernel-execution counter readings from
  ``compiled.cost_analysis()`` + the HLO structure parse, riding the
  existing wait-free activity channels into the CCT as the sparse
  ``gpu_counter`` metric kind.

Typical flow::

    prof = Profiler(out_dir)
    prof.enable_counters(["flops", "hbm_bytes", "active_ns"])  # replay
    mid = prof.register_module("step", compiled.as_text(),
                               cost=compiled.cost_analysis())
    with prof, prof.dispatch("kernel", "step", module_id=mid):
        step(...)

then aggregate as usual; ``viewer.counter_table`` and
``traceview.stats.top_kernel_counters`` surface the derived columns
(``core.derived``: achieved occupancy, flop efficiency, bytes/flop,
replay passes).  See docs/counters.md.
"""
from repro_torch.counters.collector import CounterCollector, static_counters
from repro_torch.counters.scheduler import (CounterGroup, MultiplexSchedule,
                                      build_schedule, optimal_passes)
from repro_torch.counters.taxonomy import (ALL_COUNTERS, CATALOG, COUNTER_INDEX,
                                     Counter, DOMAIN_CAPACITY, KIND_NAME,
                                     describe, resolve)

__all__ = [
    "Counter", "CATALOG", "ALL_COUNTERS", "COUNTER_INDEX",
    "DOMAIN_CAPACITY", "KIND_NAME", "describe", "resolve",
    "CounterGroup", "MultiplexSchedule", "build_schedule", "optimal_passes",
    "CounterCollector", "static_counters",
]
