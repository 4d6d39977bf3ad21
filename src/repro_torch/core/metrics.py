"""Metric kinds and the sparse per-node metric representation (paper §4.6).

HPCToolkit measures well over 100 metrics, most zero at most CCT nodes, so
``hpcrun`` partitions metrics into *kinds* (GPU kernel info kind, GPU
instruction-stall kind, CPU time kind, ...).  Each CCT node carries a list
of only the kinds it actually has, each kind a dense array of its member
metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MetricKind:
    name: str
    metrics: Tuple[str, ...]      # member metric names, in kind-local order
    kind_id: int = -1


class MetricRegistry:
    """Assigns global metric ids; kinds are contiguous id ranges."""

    def __init__(self):
        self.kinds: List[MetricKind] = []
        self._kind_by_name: Dict[str, MetricKind] = {}
        self._global_ids: Dict[Tuple[str, str], int] = {}
        self.metric_names: List[str] = []

    def register_kind(self, name: str, metrics: Tuple[str, ...]) -> MetricKind:
        if name in self._kind_by_name:
            k = self._kind_by_name[name]
            assert k.metrics == tuple(metrics), f"kind {name} redefined"
            return k
        kind = MetricKind(name, tuple(metrics), kind_id=len(self.kinds))
        self.kinds.append(kind)
        self._kind_by_name[name] = kind
        for m in metrics:
            self._global_ids[(name, m)] = len(self.metric_names)
            self.metric_names.append(f"{name}/{m}")
        return kind

    def kind(self, name: str) -> MetricKind:
        return self._kind_by_name[name]

    def global_id(self, kind: str, metric: str) -> int:
        return self._global_ids[(kind, metric)]

    @property
    def n_metrics(self) -> int:
        return len(self.metric_names)


# Kernel-granularity hardware-counter kind (paper §6 "supplement
# fine-grained measurements with hardware performance counters").  The
# member layout is owned here so every profile agrees on the columns; the
# counter *taxonomy* (domains, units, multiplex capacities) lives in
# repro.counters.taxonomy and validates itself against this tuple.
GPU_COUNTER_KIND = "gpu_counter"
GPU_COUNTER_METRICS = (
    # compute domain
    "flops", "mxu_flops", "transcendental_ops",
    # memory domain
    "hbm_read_bytes", "hbm_write_bytes", "hbm_bytes",
    # collective domain
    "ici_wire_bytes", "collective_invocations",
    # scheduler domain
    "inst_executed", "active_ns",
    # tool domain (always collected, never multiplexed)
    "elapsed_ns", "replay_passes",
)

# The default registry mirrors the paper's examples (§4.5, §4.6, §7.1).
DEFAULT_KINDS = (
    ("cpu", ("time_ns", "samples")),
    # raw GPU-operation metrics: op count / time; copies carry bytes
    ("gpu_kernel", ("invocations", "time_ns", "registers_sum",
                    "static_smem_sum", "occupancy_sum")),
    ("gpu_copy", ("invocations", "time_ns", "bytes")),
    ("gpu_sync", ("invocations", "time_ns")),
    # fine-grained (PC-sampling analogue) metrics per GPU "instruction"
    ("gpu_inst", ("samples", "stall_compute", "stall_memory",
                  "stall_collective", "flops", "bytes")),
    # kernel-granularity hardware counters (repro.counters)
    (GPU_COUNTER_KIND, GPU_COUNTER_METRICS),
)


def default_registry() -> MetricRegistry:
    reg = MetricRegistry()
    for name, metrics in DEFAULT_KINDS:
        reg.register_kind(name, metrics)
    return reg


class NodeMetrics:
    """Sparse metric store for one CCT node: a metric-kind list."""

    __slots__ = ("_kinds",)

    def __init__(self):
        self._kinds: Dict[int, np.ndarray] = {}

    def add(self, kind: MetricKind, metric: str, value: float) -> None:
        arr = self._kinds.get(kind.kind_id)
        if arr is None:
            arr = np.zeros(len(kind.metrics), np.float64)
            self._kinds[kind.kind_id] = arr
        arr[kind.metrics.index(metric)] += value

    def add_vec(self, kind: MetricKind, values: np.ndarray) -> None:
        arr = self._kinds.get(kind.kind_id)
        if arr is None:
            self._kinds[kind.kind_id] = np.asarray(values, np.float64).copy()
        else:
            arr += values

    def merge_from(self, other: "NodeMetrics") -> None:
        """Fold another node's metrics into this one, kind by kind —
        the shadow-CCT graft (profiler flush) merging monitor-side
        attribution into the application thread's tree."""
        for kid, arr in other._kinds.items():
            mine = self._kinds.get(kid)
            if mine is None:
                self._kinds[kid] = arr.copy()
            else:
                mine += arr

    def get(self, kind: MetricKind, metric: str) -> float:
        arr = self._kinds.get(kind.kind_id)
        if arr is None:
            return 0.0
        return float(arr[kind.metrics.index(metric)])

    def kinds(self) -> Dict[int, np.ndarray]:
        return self._kinds

    @property
    def empty(self) -> bool:
        return not self._kinds

    def nonzero_items(self, registry: MetricRegistry):
        """Yields (global_metric_id, value) for non-zero metrics."""
        for kid, arr in sorted(self._kinds.items()):
            kind = registry.kinds[kid]
            base = registry.global_id(kind.name, kind.metrics[0])
            for i, v in enumerate(arr):
                if v != 0.0:
                    yield base + i, float(v)
