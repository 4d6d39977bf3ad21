"""Heterogeneous calling context trees (paper §3, §4.1, §4.6).

A CCT node identifies a *frame*.  In HPCToolkit a frame is a
(load module, offset) machine-instruction pair; in the JAX/TPU adaptation a
frame is one of:

- ``host``        — a Python stack frame (file, line, function) on an
                    application thread;
- ``placeholder`` — a GPU operation placeholder `P` (kernel launch, copy,
                    sync) inserted under the host context that invoked it;
- ``gpu_op``      — an HLO op / Pallas block inside a compiled module
                    (module id + op index), the "GPU instruction" analogue;
- ``gpu_func``    — a GPU-side function/scope (inline scope, loop or
                    computation recovered by hpcstruct-analogue analysis).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import MetricRegistry, NodeMetrics

HOST = "host"
PLACEHOLDER = "placeholder"
GPU_OP = "gpu_op"
GPU_FUNC = "gpu_func"
GPU_LOOP = "gpu_loop"


def tree_depths(parents: np.ndarray) -> np.ndarray:
    """Per-node depth (root = 0) for a parent-id array, via vectorized
    parent jumps: O(max_depth) passes.  The one implementation behind
    ``GlobalTree.depths``, ``Database.depths``, and the traceview
    raster's depth projection."""
    parents = np.asarray(parents, np.int64)
    depth = np.zeros(len(parents), np.int64)
    cur = parents.copy()
    while True:
        mask = cur >= 0
        if not mask.any():
            break
        depth[mask] += 1
        cur[mask] = parents[cur[mask]]
    return depth


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: str
    name: str               # function name / op name / placeholder label
    module: str = ""        # file or load-module name
    line: int = 0           # source line or op index

    def pretty(self) -> str:
        if self.kind == HOST:
            return f"{self.name} @ {self.module}:{self.line}"
        if self.kind == PLACEHOLDER:
            return f"<gpu op {self.name}>"
        if self.kind == GPU_LOOP:
            return f"loop at {self.module}:{self.line}"
        return self.name


class CCTNode:
    __slots__ = ("frame", "parent", "children", "metrics", "node_id")

    def __init__(self, frame: Frame, parent: Optional["CCTNode"],
                 node_id: int):
        self.frame = frame
        self.parent = parent
        self.children: Dict[Frame, CCTNode] = {}
        self.metrics = NodeMetrics()
        self.node_id = node_id

    def walk(self) -> Iterator["CCTNode"]:
        yield self
        for c in self.children.values():
            yield from c.walk()

    def path(self) -> List[Frame]:
        out = []
        node = self
        while node.parent is not None:
            out.append(node.frame)
            node = node.parent
        return out[::-1]


class CCT:
    """One calling context tree (per CPU thread or GPU stream profile)."""

    ROOT = Frame("root", "<program root>")

    def __init__(self):
        self._next_id = 0
        self.root = self._new_node(self.ROOT, None)

    def _new_node(self, frame: Frame, parent) -> CCTNode:
        node = CCTNode(frame, parent, self._next_id)
        self._next_id += 1
        return node

    def get_or_insert(self, parent: CCTNode, frame: Frame) -> CCTNode:
        child = parent.children.get(frame)
        if child is None:
            child = self._new_node(frame, parent)
            parent.children[frame] = child
        return child

    def insert_path(self, frames: List[Frame],
                    parent: Optional[CCTNode] = None) -> CCTNode:
        node = parent if parent is not None else self.root
        for f in frames:
            node = self.get_or_insert(node, f)
        return node

    def nodes(self) -> List[CCTNode]:
        return list(self.root.walk())

    @property
    def n_nodes(self) -> int:
        return self._next_id

    def node_by_id(self) -> Dict[int, CCTNode]:
        return {n.node_id: n for n in self.root.walk()}


def unwind_host_stack(skip: int = 0, max_depth: int = 64,
                      prune_modules: Tuple[str, ...] = ("repro_torch/core",
                                                        "threading.py"),
                      ) -> List[Frame]:
    """Unwind the current Python call stack into host frames, innermost
    last.  Frames from the tool itself are pruned (the paper prunes helper
    threads and tool frames the same way, §4.4)."""
    import sys
    frames: List[Frame] = []
    try:
        f = sys._getframe(skip + 1)
    except ValueError:
        return frames
    depth = 0
    while f is not None and depth < max_depth:
        fname = f.f_code.co_filename
        if not any(p in fname for p in prune_modules):
            frames.append(Frame(HOST, f.f_code.co_name, fname, f.f_lineno))
        f = f.f_back
        depth += 1
    return frames[::-1]
