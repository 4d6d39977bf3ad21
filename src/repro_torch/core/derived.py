"""Derived metrics (paper §4.5, §7.1).

hpcviewer lets the user author spreadsheet-like formulas over measured
metrics; hpcprof provides the built-in cross-profile statistics
(sum/min/mean/max/stddev/CoV — computed in aggregate.py).  This module is
the formula half: a safe AST-walking evaluator over named metric columns.

Paper examples reproduced here and in examples/:

- Warp issue rate   W = S / (S + S_stall)
- sync diff         diff = sync_count - kernel_count   (PeleC, §8.4.1)
- registers used    regs = registers_sum / invocations (the "odd raw
  metrics then divide" trick of §4.5)
"""
from __future__ import annotations

import ast
import math
from typing import Dict, Mapping

import numpy as np

_ALLOWED_FUNCS = {
    "sqrt": np.sqrt, "log": np.log, "log2": np.log2, "exp": np.exp,
    "abs": np.abs, "min": np.minimum, "max": np.maximum,
    "where": np.where,
}
_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Name, ast.Load, ast.Call,
    ast.Constant, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Pow, ast.USub,
    ast.UAdd, ast.Compare, ast.Gt, ast.GtE, ast.Lt, ast.LtE, ast.Eq,
    ast.NotEq, ast.IfExp,
)


def sanitize(name: str) -> str:
    """Metric names like ``gpu_kernel/time_ns`` -> identifier."""
    return name.replace("/", "__").replace("-", "_").replace(".", "_")


class DerivedMetric:
    def __init__(self, name: str, formula: str):
        self.name = name
        self.formula = formula
        self._tree = ast.parse(formula, mode="eval")
        for node in ast.walk(self._tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"disallowed syntax {type(node).__name__} in formula")
            if isinstance(node, ast.Call):
                if not (isinstance(node.func, ast.Name)
                        and node.func.id in _ALLOWED_FUNCS):
                    raise ValueError("only whitelisted functions allowed")

    def evaluate(self, columns: Mapping[str, np.ndarray]) -> np.ndarray:
        env = {sanitize(k): v for k, v in columns.items()}

        def ev(node):
            if isinstance(node, ast.Expression):
                return ev(node.body)
            if isinstance(node, ast.Constant):
                return node.value
            if isinstance(node, ast.Name):
                if node.id in env:
                    return env[node.id]
                raise KeyError(f"unknown metric {node.id!r}")
            if isinstance(node, ast.BinOp):
                a, b = ev(node.left), ev(node.right)
                op = type(node.op)
                with np.errstate(divide="ignore", invalid="ignore"):
                    if op is ast.Add:
                        return a + b
                    if op is ast.Sub:
                        return a - b
                    if op is ast.Mult:
                        return a * b
                    if op is ast.Div:
                        return np.where(np.asarray(b) != 0,
                                        np.divide(a, np.where(
                                            np.asarray(b) != 0, b, 1)), 0.0)
                    if op is ast.Pow:
                        return a ** b
                raise ValueError(op)
            if isinstance(node, ast.UnaryOp):
                v = ev(node.operand)
                return -v if isinstance(node.op, ast.USub) else +v
            if isinstance(node, ast.Call):
                args = [ev(a) for a in node.args]
                return _ALLOWED_FUNCS[node.func.id](*args)
            if isinstance(node, ast.Compare):
                a = ev(node.left)
                b = ev(node.comparators[0])
                op = type(node.ops[0])
                table = {ast.Gt: np.greater, ast.GtE: np.greater_equal,
                         ast.Lt: np.less, ast.LtE: np.less_equal,
                         ast.Eq: np.equal, ast.NotEq: np.not_equal}
                return table[op](a, b)
            if isinstance(node, ast.IfExp):
                return np.where(ev(node.test), ev(node.body), ev(node.orelse))
            raise ValueError(type(node))

        return ev(self._tree)


def database_columns(db, stat: str = "sum") -> Dict[str, np.ndarray]:
    """Per-context metric columns from a Database for formula evaluation."""
    mat = db.stats[stat]
    return {name: mat[:, i] for i, name in enumerate(db.metrics)}


# paper-example formulas, ready to use
WARP_ISSUE_RATE = DerivedMetric(
    "warp_issue_rate",
    "gpu_inst__samples / (gpu_inst__samples + gpu_inst__stall_compute"
    " + gpu_inst__stall_memory + gpu_inst__stall_collective)")
SYNC_DIFF = DerivedMetric(
    "sync_minus_kernels",
    "gpu_sync__invocations - gpu_kernel__invocations")
REGISTERS_USED = DerivedMetric(
    "registers_used",
    "gpu_kernel__registers_sum / gpu_kernel__invocations")
GPU_UTILIZATION = DerivedMetric(
    "gpu_utilization",
    "gpu_kernel__time_ns / (cpu__time_ns + gpu_kernel__time_ns)")

# ---------------------------------------------------------------------------
# Hardware-counter derived metrics (paper §6; repro.counters).  All are
# ratios of gpu_counter columns, so the zero-division policy (0) makes
# them vanish at contexts with no counter data.
# ---------------------------------------------------------------------------
from repro_torch.core.sampling import PEAK_FLOPS as _PEAK_FLOPS  # noqa: E402

# modeled busy time over elapsed time, clamped into [0, 1]
ACHIEVED_OCCUPANCY = DerivedMetric(
    "achieved_occupancy",
    "min(gpu_counter__active_ns / gpu_counter__elapsed_ns, 1.0)")
# fraction of the chip's peak FLOP/s actually achieved
FLOP_EFFICIENCY = DerivedMetric(
    "flop_efficiency",
    f"gpu_counter__flops / (gpu_counter__elapsed_ns * {_PEAK_FLOPS * 1e-9})")
# arithmetic-intensity inverse: memory traffic per flop
BYTES_PER_FLOP = DerivedMetric(
    "bytes_per_flop",
    "gpu_counter__hbm_bytes / gpu_counter__flops")
# mean measurement passes per kernel launch (1 unless replay-multiplexed)
REPLAY_PASS_COUNT = DerivedMetric(
    "replay_pass_count",
    "gpu_counter__replay_passes / gpu_kernel__invocations")

COUNTER_DERIVED = (ACHIEVED_OCCUPANCY, FLOP_EFFICIENCY, BYTES_PER_FLOP,
                   REPLAY_PASS_COUNT)
