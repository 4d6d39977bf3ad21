"""hpcrun-analogue: the user-facing measurement API (paper §3, §4).

Usage::

    prof = Profiler(out_dir, tracing=True)
    module = export.module_from_export("step", export.export_step(
        step_fn, args))                     # core.export: the GPU binary
    mid = prof.register_structure("step", module, export.cost(module))
    prof.start()
    with prof.dispatch("kernel", "step", stream=0, module_id=mid):
        out = step_fn(...)            # timed; samples synthesized on exit
    prof.flush()
    paths = prof.write()              # per-thread + per-stream profiles

Every dispatch unwinds the *calling* Python stack, inserts a placeholder P
in the thread's CCT, and appends OP/ACTIVITY records to its wait-free
per-thread record ring (channels.RecordRing).  Everything else — the
PC-sample draw (sampling.py), hardware-counter reads, and fine-grained
attribution below P (§4.2) — is **deferred**: the monitor thread
(monitor.py) drains the rings in batches and attributes into per-thread
*shadow* CCTs, which graft into the application threads' trees at flush.
The dispatch path itself is a handful of integer stores and two ring
appends, each publishing one cursor.

Determinism with the draw off-thread: the rng is keyed by the
dispatching thread's stable index and its per-thread dispatch sequence
number (sampling.KeyedRng), never by drain order, so the drawn samples
— and therefore the database bytes — are invariant under any monitor
batching or thread interleaving (given ``bind_thread`` pinning thread
indices when more than one thread dispatches).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import sampling, scope
from repro_torch.core.cct import (CCT, CCTNode, Frame, HOST, PLACEHOLDER,
                            unwind_host_stack)
from repro_torch.core.channels import RingSet
from repro_torch.core.metrics import MetricRegistry, default_registry
from repro_torch.core.monitor import (ACTIVITY, OP, GpuActivity, GpuOperation,
                                MonitorThread)
from repro_torch.core.profmt import write_profile
from repro_torch.core.structure import HloModule
from repro_torch.core.trace import TraceWriter, pack_dispatch_ctx

# tool frames pruned from host unwinds (matches unwind_host_stack)
_PRUNE = ("repro_torch/core", "threading.py")


class _ThreadState:
    """Everything one application thread owns.

    Single-writer discipline: the app thread writes ``cct`` (host
    contexts, placeholders), ``seq``, ``counts``, and ``trace`` (cpu
    regions); the monitor thread writes ``shadow``/``shadow_cct``,
    ``trace_chunks``, and ``mon_counts``.  The two meet only at flush,
    when the app threads are quiescent and the shadow grafts into
    ``cct``.  The counter tuples are published with a single reference
    store, so any observer reads a consistent snapshot (the
    ``overhead_counters`` race fix).  ``open`` (the app thread's, one
    store at each dispatch's entry and exit) is read by the monitor
    alone, to tell its work between dispatches from its work during
    one."""

    __slots__ = ("cct", "trace", "trace_chunks", "ring", "seq", "index",
                 "counts", "mon_counts", "ctx_cache", "ph_cache",
                 "app_node", "shadow", "shadow_cct", "snode_cache", "open")

    def __init__(self, cct: CCT, ring, index: int):
        self.cct = cct
        self.trace: List[tuple] = []     # (t0, t1, ctx_id) cpu regions
        self.trace_chunks: List[np.ndarray] = []   # monitor drain batches
        self.ring = ring
        self.seq = 0                     # per-thread dispatch sequence
        self.index = index               # stable thread index (bindable)
        self.counts = (0, 0, 0)          # (tool_ns, app_ns, dispatches)
        # (kept, dropped, deferred_ns, deferred_between_ns)
        self.mon_counts = (0, 0, 0, 0)
        self.open = False                # a dispatch is open on the thread
        self.ctx_cache: Dict[tuple, CCTNode] = {}   # unwind key -> ctx
        self.ph_cache: Dict[tuple, CCTNode] = {}    # placeholder memo
        self.app_node: Optional[CCTNode] = None     # unwind-off context
        self.shadow: Dict[CCTNode, CCTNode] = {}    # placeholder -> shadow
        self.shadow_cct = CCT()
        # (shadow placeholder, module, op, leaf) -> resolved sample node;
        # monitor-only, cleared with the shadow at graft
        self.snode_cache: Dict[tuple, CCTNode] = {}


class Profiler:
    def __init__(self, out_dir: str, *, registry: Optional[MetricRegistry]
                 = None, tracing: bool = True, n_tracing_threads: int = 1,
                 sample_rate_hz: float = 1e6, instrument: bool = False,
                 rank: int = 0, clock: Callable[[], int] = time.monotonic_ns,
                 rng_seed: Optional[int] = None, unwind: bool = True,
                 tag: Optional[str] = None):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.registry = registry or default_registry()
        self.tracing = tracing
        self.sample_rate_hz = sample_rate_hz
        self.instrument = instrument
        self.rank = rank
        self.clock = clock
        self.unwind = unwind
        # continuous profiling (ISSUE 4): an optional measurement tag
        # (epoch / job segment) that lands in every profile & trace
        # identity and in the file names, so successive measurement
        # windows of one rank stay distinct through aggregation,
        # incremental merge, and the trace.db line index
        self.tag = tag
        # always-on serving knobs (ISSUE 7; repro.serving.governor): the
        # effective PC-sampling rate is sample_rate_hz * sample_scale,
        # capped at sample_cap samples per dispatch, and host unwinds
        # stop at unwind_depth frames (0 = single <app> frame).  All
        # three are safe to mutate between dispatches, which is how the
        # overhead governor throttles measurement at run time without
        # ever turning it off (coarse dispatch timing + tracing stay).
        # With the draw deferred, sample_scale/sample_cap shed
        # *monitor-side* cost (deferred_ns) while unwind_depth and the
        # per-record fixed cost are what remain on the dispatch path.
        self.sample_scale = 1.0
        self.sample_cap: Optional[int] = None
        self.unwind_depth = 64
        self._windows = threading.local()
        # deferred-draw rng: keyed per (thread index, dispatch seq), so
        # sampled values are a pure function of the dispatch identity,
        # not of the monitor's drain order (None = the deterministic
        # expectation-rounding path, as before)
        self._keyed = (sampling.KeyedRng(rng_seed)
                       if rng_seed is not None else None)
        self._rings = RingSet()
        self._monitor = MonitorThread(self._rings, self._on_records,
                                      tracing=tracing,
                                      n_tracing_threads=n_tracing_threads)
        self._threads: Dict[int, _ThreadState] = {}
        # a thread's key into ``_threads`` and its ring: drawn once per
        # thread and kept in a thread-local, never ``get_ident`` (which an
        # ended thread passes on to the next one started)
        self._local = threading.local()
        self._keys = itertools.count(1)
        self._threads_lock = threading.Lock()
        self._next_index = 0
        self._bound_indices: set = set()
        self._modules: Dict[int, HloModule] = {}
        self._module_names: Dict[int, str] = {}
        self._module_costs: Dict[int, dict] = {}
        self._counters = None        # CounterCollector when enabled
        self._op_ctx_cache: Dict[tuple, tuple] = {}   # monitor-thread only
        # precomputed attribution tables (the registry is fixed at init;
        # name->index lookups per record were a measurable monitor cost)
        reg = self.registry
        self._gpu_kinds = {"kernel": reg.kind("gpu_kernel"),
                           "copy": reg.kind("gpu_copy"),
                           "sync": reg.kind("gpu_sync")}
        ikind = reg.kind("gpu_inst")
        midx = {m: i for i, m in enumerate(ikind.metrics)}
        self._ikind = ikind
        self._inst_cols = (midx["samples"], midx["flops"], midx["bytes"],
                           {s: midx[f"stall_{s}"]
                            for s in ("compute", "memory", "collective")})
        self._stream_ccts: Dict[int, CCT] = {}
        self._stream_nodes: Dict[int, dict] = {}   # tracer node memo
        self._stream_lock = threading.Lock()
        self._started = False
        # (time.monotonic_ns(), time.time_ns()) at start(): puts the trace
        # rows of the default clock on torch.profiler's timeline
        # (``trace_rows_us``); ``clock`` is not called for it, so a
        # scripted clock ticks for the dispatches alone
        self.clock_anchor: Optional[tuple] = None
        self._host = socket.gethostname()
        self._monitor.trace_sink = self._stream_profile_sink

    # ------------------------------------------------------------------ #
    def register_structure(self, name: str, module: HloModule,
                           cost: Optional[dict] = None) -> int:
        """Record a loaded 'GPU binary' for later analysis (§3): the
        program structure ``core.export.module_from_export`` builds from a
        ``torch.export`` graph of a step (a PyTorch program has no HLO
        text to parse).

        ``cost`` is the module's ``{"flops", "bytes accessed"}`` dict
        (``core.export.cost``); when given, hardware-counter readings
        (enable_counters) calibrate their flop/byte totals against it
        instead of relying purely on the structure's estimates."""
        mid = len(self._modules) + 1
        self._modules[mid] = module
        self._module_names[mid] = name
        if cost is not None:
            self._module_costs[mid] = dict(cost)
        return mid

    def enable_counters(self, counters, *, replay: bool = True):
        """Turn on kernel-granularity hardware-counter collection
        (paper §6; repro_torch.counters).  Returns the multiplex schedule.

        ``replay=True`` serializes replay passes so every requested
        counter is measured on every kernel execution; ``replay=False``
        rotates counter groups across invocations (single-pass
        best-effort multiplexing).  Must be called identically on every
        rank so aggregated profiles agree on the counter columns.
        Readings happen on the monitor thread as records drain, so the
        rotation order is the per-thread record order (deterministic
        for one dispatching thread)."""
        from repro_torch.counters.collector import CounterCollector
        self._counters = CounterCollector(counters, replay=replay)
        return self._counters.schedule

    def module(self, mid: int) -> HloModule:
        return self._modules[mid]

    def register_kernel_structures(self, mid: int, structures,
                                   matches: Optional[Dict[str, str]] = None
                                   ) -> int:
        """Bind recovered kernel-interior structures
        (``repro_torch.core.kstruct.KernelStructure``) to module ``mid``'s
        ``custom-call`` ops.  Subsequent PC samples descend into the
        kernels' interiors (loops / inlined scopes / source lines)
        instead of stopping at the opaque op.  Returns total ops bound.
        Call before ``start()``: the op-context cache it invalidates is
        owned by the monitor thread once measurement is running."""
        mod = self._modules[mid]
        matches = matches or {}
        bound = 0
        for ks in structures:
            bound += mod.bind_kernel_structure(ks, matches.get(ks.name))
        if bound:
            # interior leaves change the per-op context paths
            self._op_ctx_cache = {
                k: v for k, v in self._op_ctx_cache.items() if k[0] != mid}
        return bound

    def start(self):
        if not self._started:
            w0 = time.time_ns()
            m = time.monotonic_ns()
            self.clock_anchor = (m, (w0 + time.time_ns()) // 2)
            self._monitor.start()
            self._started = True
        return self

    def stop(self):
        if self._started:
            self._monitor.stop()
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.flush()
        self.stop()

    # ------------------------------------------------------------------ #
    def _tid(self) -> int:
        """The calling thread's key (see ``_local``)."""
        key = getattr(self._local, "key", None)
        if key is None:
            key = self._local.key = next(self._keys)
        return key

    def _state(self) -> _ThreadState:
        tid = self._tid()
        st = self._threads.get(tid)
        if st is None:
            with self._threads_lock:
                st = self._threads.get(tid)
                if st is None:
                    st = _ThreadState(CCT(), self._rings.ring_for(tid),
                                      self._alloc_index())
                    self._threads[tid] = st
        return st

    def _alloc_index(self) -> int:
        # caller holds _threads_lock
        i = self._next_index
        while i in self._bound_indices:
            i += 1
        self._next_index = i + 1
        return i

    def bind_thread(self, index: int) -> int:
        """Pin the calling thread's stable index — its profile slot
        (``profile_rR_t<index>.rpro``), its trace lane in the packed
        dispatch ctx, and its deferred-draw rng lane.  Threads that
        never bind get registration-order indices, which is
        deterministic for a single dispatching thread but racy across
        several; byte-identical multi-threaded runs therefore bind each
        worker to a fixed index before its first dispatch."""
        index = int(index)
        if index < 0:
            raise ValueError("thread index must be >= 0")
        tid = self._tid()
        with self._threads_lock:
            st = self._threads.get(tid)
            if st is not None and st.seq:
                raise RuntimeError(
                    "bind_thread must precede the thread's first dispatch")
            if index in self._bound_indices or any(
                    s.index == index for t, s in self._threads.items()
                    if t != tid):
                raise ValueError(f"thread index {index} already in use")
            self._bound_indices.add(index)
            if st is None:
                self._threads[tid] = _ThreadState(
                    CCT(), self._rings.ring_for(tid), index)
            else:
                st.index = index
        return index

    # -- host calling context (memoized unwind) ------------------------- #
    def _dispatch_context(self, st: _ThreadState) -> CCTNode:
        """The calling context for a dispatch on this thread.

        The full unwind (frame objects + per-frame tree inserts) is
        memoized per *call chain*: the key is the (code object, line)
        pair of every live frame — the Python analogue of keying on
        return addresses — so a dispatch loop pays one raw stack walk,
        not an unwind.  Recursion depth is captured because recursive
        frames appear once per activation in the chain."""
        depth = self.unwind_depth
        if self.unwind and depth > 0:
            try:
                # 0=_dispatch_context, 1=_Dispatch.__enter__, 2=the
                # dispatch site (the `with` statement's frame)
                f = sys._getframe(2)
            except ValueError:
                f = None
            key = [depth]
            d = 0
            while f is not None and d < depth:
                key.append(f.f_code)
                key.append(f.f_lineno)
                f = f.f_back
                d += 1
            key = tuple(key)
            node = st.ctx_cache.get(key)
            if node is None:
                frames = [Frame(HOST, c.co_name, c.co_filename, line)
                          for c, line in zip(key[1::2], key[2::2])
                          if not any(p in c.co_filename for p in _PRUNE)]
                node = st.cct.insert_path(frames[::-1])
                st.ctx_cache[key] = node
        else:
            node = st.app_node
            if node is None:
                node = st.app_node = st.cct.insert_path(
                    [Frame(HOST, "<app>", "", 0)])
        wf = getattr(self._windows, "frames", None)
        if wf:
            # window stamping rides the record: the frames are baked
            # into the ctx/placeholder nodes *here*, at dispatch time,
            # so deferred attribution sees the window that was open
            # when the dispatch happened, not drain-time state
            for frame in wf:
                node = st.cct.get_or_insert(node, frame)
        return node

    def _host_context(self, st: _ThreadState, name: str) -> CCTNode:
        # the non-hot-path unwind (cpu_region): full frame construction
        if self.unwind and self.unwind_depth > 0:
            frames = unwind_host_stack(skip=3, max_depth=self.unwind_depth)
        else:
            frames = [Frame(HOST, "<app>", "", 0)]
        node = st.cct.insert_path(frames)
        for wf in self._window_frames():
            node = st.cct.get_or_insert(node, wf)
        return node

    # -- measurement windows (ISSUE 7: per-request serving attribution) --
    def _window_frames(self) -> list:
        frames = getattr(self._windows, "frames", None)
        if frames is None:
            frames = self._windows.frames = []
        return frames

    @contextlib.contextmanager
    def window(self, *frames: Frame):
        """A measurement window: while open on this thread, ``frames``
        are spliced between the unwound host stack and every dispatch
        placeholder / cpu_region, so the aggregated database attributes
        the enclosed GPU and CPU work to the window (the per-request /
        per-phase identities of ``repro.serving.window``).  Windows
        nest; frames ride the CCT the same way ``dispatch_profiles``
        rides ctx bits — no file-format change."""
        stack = self._window_frames()
        n = len(stack)
        stack.extend(frames)
        try:
            yield
        finally:
            del stack[n:]

    @contextlib.contextmanager
    def window_exclusive(self, *frames: Frame):
        """Like ``window`` but *replaces* the thread's current window
        stack for the duration instead of nesting under it.  This is the
        continuous-batching primitive (repro.serving.window.RequestWindow
        .step): overlapping request windows on one serving thread stamp
        each dispatch with exactly one request's frames, so interleaved
        decode steps never double-count under whichever window happened
        to open first."""
        stack = self._window_frames()
        saved = stack[:]
        stack[:] = list(frames)
        try:
            yield
        finally:
            stack[:] = saved

    def overhead_counters(self) -> Dict[str, int]:
        """Cumulative dispatch-path self-accounting (the governor's
        input): tool time vs application time, dispatch count, the
        PC-sample kept/dropped tally under the current throttle, and
        ``deferred_ns`` — monitor-thread time spent on the deferred
        draw/attribution (off the dispatch path, reported for
        visibility), and ``deferred_between_ns``, the part of it spent on
        a thread's records while that thread had no dispatch open: the
        monitor's work that competes for the GIL with the host code
        between two dispatches (``_on_records`` states the rule).  Every
        per-thread contribution is published as one
        tuple store per update, so a snapshot taken mid-dispatch is
        always internally consistent (no tool_ns-without-dispatches
        torn reads); kept/dropped lag the dispatch counters by at most
        one monitor drain."""
        tool = app = n = kept = dropped = deferred = between = 0
        for st in list(self._threads.values()):
            t, a, d = st.counts
            k, dr, df, bt = st.mon_counts
            tool += t
            app += a
            n += d
            kept += k
            dropped += dr
            deferred += df
            between += bt
        return {"tool_ns": tool, "app_ns": app, "dispatches": n,
                "samples_kept": kept, "samples_dropped": dropped,
                "deferred_ns": deferred, "deferred_between_ns": between}

    def dispatch(self, kind: str, name: str, *, stream: int = 0,
                 module_id: Optional[int] = None, nbytes: int = 0,
                 duration_ns: Optional[int] = None) -> "_Dispatch":
        """Times the enclosed GPU operation and attributes it.

        ``duration_ns`` overrides the measured wall time (used when the
        caller has a better device-side estimate, e.g. from events).

        The hot path (``_Dispatch``): memoized host-context lookup, two
        wait-free ring appends (OP at entry, ACTIVITY + trace-lane row
        at exit), and one published counter tuple.  The PC-sample draw,
        counter reads, metric attribution, and trace appends all happen
        on the monitor thread as the ring drains."""
        return _Dispatch(self, kind, name, stream, module_id, nbytes,
                         duration_ns)

    @contextlib.contextmanager
    def cpu_region(self, name: str):
        """Marks CPU work for the trace/blame views."""
        st = self._state()
        node = st.cct.insert_path([Frame(HOST, name, "", 0)],
                                  parent=self._host_context(st, name))
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            node.metrics.add(self.registry.kind("cpu"), "time_ns", t1 - t0)
            st.trace.append((t0, t1, node.node_id))

    # -- the monitor-side record handler -------------------------------- #
    def _on_records(self, tid: int, payloads: list, lane: np.ndarray):
        """Process one drained ring batch (monitor thread only): the
        deferred PC-sample draw (rng keyed by (thread index, seq) —
        drain-order invariant), deferred counter reads, attribution
        into the thread's shadow CCT, and one buffered trace chunk.
        Returns completed (activity, placeholder) pairs for trace
        routing plus monitor stat increments.

        The call's time adds to ``deferred_ns``, and to
        ``deferred_between_ns`` in full where the thread had no dispatch
        open both as the call started and as it ended, in half where at
        one of the two (when it entered or left a dispatch in between is
        not known), not at all otherwise."""
        t_h0 = time.monotonic_ns()
        st = self._threads[tid]
        closed = not st.open
        keyed = self._keyed
        counters = self._counters
        shadow = st.shadow
        # the dispatching app thread rides the activity record: the
        # tracing threads stamp it into GPU-stream trace events so
        # aggregation can convert their app-thread CCT node ids through
        # this thread's profile (pipeline.traceconv).  One dict per
        # drain, shared read-only by every activity in the batch; only
        # a counter read forks a private copy (its vector is per record)
        shared_meta = {"dispatch_tid": tid}
        acts: List[tuple] = []
        rows: List[int] = []
        n_ops = n_act = n_counter = 0
        kept_add = dropped_add = 0
        lane_py = lane.tolist()    # one bulk convert beats per-field int()
        for i, rec in enumerate(payloads):
            if rec[0] == OP:
                n_ops += 1
                continue
            (_, seq, kind, name, stream, module_id, placeholder,
             nbytes, n_budget, base) = rec
            n_act += 1
            t0, t1, _ctx = lane_py[i]
            samples = None
            meta = shared_meta
            if n_budget:
                mod = self._modules[module_id]
                if n_budget < 0:
                    samples = getattr(mod, "_inst_counts_cache", None)
                    if samples is None:
                        samples = sampling.instruction_counts(mod)
                        mod._inst_counts_cache = samples
                else:
                    rng = (keyed.stream(st.index, seq)
                           if keyed is not None else None)
                    samples = sampling.draw_samples(mod, n_budget, rng)
                    k = 0
                    for s in samples:
                        k += s.count
                    kept_add += k
                    if base > k:
                        dropped_add += base - k
                if counters is not None:
                    meta = {"dispatch_tid": tid,
                            "counters": counters.read(
                                mod, t1 - t0,
                                self._module_costs.get(module_id))}
                    n_counter += 1
            act = GpuActivity(seq, kind, name, stream, t0, t1,
                              bytes=nbytes, samples=samples,
                              module_id=module_id, meta=meta)
            sh = shadow.get(placeholder)
            if sh is None:
                sh = self._shadow_node(st, placeholder)
            self._attribute(st, act, sh)
            rows.append(i)
            acts.append((act, placeholder))
        if rows:
            # one buffered trace chunk per drain (TraceWriter adopts
            # these wholesale at write time — append_chunk)
            st.trace_chunks.append(lane[np.asarray(rows, np.intp)])
        took = time.monotonic_ns() - t_h0
        closed += not st.open
        mc = st.mon_counts
        st.mon_counts = (mc[0] + kept_add, mc[1] + dropped_add,
                         mc[2] + took, mc[3] + took * closed // 2)
        return acts, {"ops": n_ops, "activities": n_act,
                      "counter_records": n_counter}

    def _shadow_node(self, st: _ThreadState, placeholder: CCTNode
                     ) -> CCTNode:
        """The monitor-side stand-in for a dispatch placeholder.  Keyed
        by placeholder *identity* (equal frames under different host
        contexts stay distinct); grafted under the real placeholder at
        flush."""
        sh = st.shadow.get(placeholder)
        if sh is None:
            sh = st.shadow_cct._new_node(placeholder.frame, None)
            st.shadow[placeholder] = sh
        return sh

    @staticmethod
    def _metric_row(node: CCTNode, kind) -> np.ndarray:
        # the kind's dense row on this node, created on first touch —
        # the monitor-side fast path around NodeMetrics.add's
        # name->index scan.  Scalar in-place adds on the row produce
        # bit-identical results to the equivalent add()/add_vec() calls
        # in the same per-record order.
        kinds = node.metrics._kinds
        arr = kinds.get(kind.kind_id)
        if arr is None:
            arr = kinds[kind.kind_id] = np.zeros(len(kind.metrics),
                                                 np.float64)
        return arr

    def _attribute(self, st: _ThreadState, act: GpuActivity,
                   node: CCTNode):
        """Attribute one activity's metrics below ``node`` (the shadow
        placeholder) in the thread's shadow CCT — monitor thread only."""
        kind = self._gpu_kinds.get(act.kind, self._gpu_kinds["kernel"])
        arr = self._metric_row(node, kind)
        arr[0] += 1                      # invocations
        arr[1] += act.duration           # time_ns
        if act.kind == "copy" and act.bytes:
            arr[2] += act.bytes
        if act.meta is not None:
            cvec = act.meta.get("counters")
            if cvec is not None:
                node.metrics.add_vec(self.registry.kind("gpu_counter"),
                                     cvec)
        if act.samples and act.module_id is not None:
            mod = self._modules[act.module_id]
            ops = mod.all_ops()
            total = sum(s.count for s in act.samples) or 1
            # gpu_inst layout: (samples, stall_*, flops, bytes) — four
            # scalar adds per sample on the node's dense row
            ikind = self._ikind
            i_samp, i_fl, i_by, stall_col = self._inst_cols
            kstructs = mod.kernel_structures()
            shadow_cct = st.shadow_cct
            snode_cache = st.snode_cache
            for s in act.samples:
                op = ops[s.op_index] if s.op_index < len(ops) else None
                if op is None:
                    continue
                leaf = getattr(s, "leaf", -1)
                key = (act.module_id, s.op_index, leaf)
                # insert_path is idempotent, so the resolved node memoizes
                # per (shadow placeholder, op context) — repeat dispatches
                # of the same module skip the frame walk entirely
                snode = snode_cache.get((node, key))
                if snode is None:
                    frames = self._op_ctx_cache.get(key)
                    if frames is None:
                        frames = tuple(mod.op_context(op))
                        if leaf >= 0:
                            # kernel-interior descent (kstruct): the leaf's
                            # GPU_FUNC/GPU_LOOP/GPU_OP chain hangs under the
                            # kernel's own GPU_OP context — interiors ride
                            # the database as ordinary tree paths
                            ks = kstructs.get(s.op_index)
                            if ks is not None and leaf < len(ks.leaves):
                                frames = frames + ks.leaf_frames(leaf)
                        self._op_ctx_cache[key] = frames
                    snode = shadow_cct.insert_path(frames, parent=node)
                    snode_cache[(node, key)] = snode
                fl, by = op.flops, op.bytes
                if leaf >= 0:
                    ks = kstructs.get(s.op_index)
                    if ks is not None and leaf < len(ks.leaves):
                        fl, by = ks.leaves[leaf].flops, ks.leaves[leaf].bytes
                sarr = self._metric_row(snode, ikind)
                c = s.count
                sarr[i_samp] += c
                sarr[stall_col[s.stall]] += c
                sarr[i_fl] += fl * c / total
                sarr[i_by] += by * c / total

    def _stream_profile_sink(self, stream: int, pairs: list):
        """Builds per-GPU-stream profiles on the tracing threads — one
        call per drained trace batch, the lock taken once and the
        per-(kind, name) placeholder node memoized."""
        with self._stream_lock:
            cct = self._stream_ccts.get(stream)
            if cct is None:
                cct = self._stream_ccts[stream] = CCT()
                self._stream_nodes[stream] = {}
            memo = self._stream_nodes[stream]
            gpu_kinds = self._gpu_kinds
            for act, _placeholder in pairs:
                key = (act.kind, act.name)
                node = memo.get(key)
                if node is None:
                    node = cct.insert_path(
                        [Frame(PLACEHOLDER, f"{act.kind}:{act.name}",
                               str(stream), 0)])
                    memo[key] = node
                kind = gpu_kinds.get(act.kind, gpu_kinds["kernel"])
                arr = self._metric_row(node, kind)
                arr[0] += 1
                arr[1] += act.duration
                if act.meta is not None:
                    cvec = act.meta.get("counters")
                    if cvec is not None:
                        node.metrics.add_vec(
                            self.registry.kind("gpu_counter"), cvec)

    # -- the shadow graft ------------------------------------------------ #
    def _graft_shadow(self) -> None:
        """Merge every thread's monitor-built shadow tree under its real
        placeholders.  Called at flush/write, when both the dispatching
        threads and the monitor are quiescent (the only moment the two
        single-writer domains may touch).  Idempotent: grafted shadows
        are consumed."""
        for st in list(self._threads.values()):
            if not st.shadow:
                continue
            shadow, st.shadow = st.shadow, {}
            st.shadow_cct = CCT()
            st.snode_cache = {}
            for placeholder, sh in shadow.items():
                self._graft_node(st.cct, placeholder, sh)

    @classmethod
    def _graft_node(cls, cct: CCT, real: CCTNode, sh: CCTNode) -> None:
        real.metrics.merge_from(sh.metrics)
        for frame, child in sh.children.items():
            cls._graft_node(cct, cct.get_or_insert(real, frame), child)

    # ------------------------------------------------------------------ #
    def flush(self, timeout: float = 10.0) -> bool:
        """Quiesce the monitor (all rings + trace channels drained,
        in-flight batches routed), then graft the shadow CCTs into the
        per-thread trees.  Dispatching threads must be quiescent."""
        ok = self._monitor.quiesce(timeout)
        self._graft_shadow()
        return ok

    def write(self) -> Dict[str, str]:
        """Writes all profiles + traces.  Returns {label: path}."""
        self._graft_shadow()    # no-op when flush already ran
        out: Dict[str, str] = {}
        mods = [self._module_names[m] for m in sorted(self._modules)]
        fp = f"{self.tag}_" if self.tag else ""

        def identity(**kw) -> Dict[str, object]:
            ident = {"host": self._host, "rank": self.rank, **kw}
            if self.tag is not None:
                ident["tag"] = self.tag
            return ident

        ordered = sorted(self._threads.items(),
                         key=lambda kv: (kv[1].index, kv[0]))
        for tid, st in ordered:
            i = st.index
            ident = identity(thread=i, type="cpu")
            path = os.path.join(self.out_dir,
                                f"profile_{fp}r{self.rank}_t{i}.rpro")
            write_profile(path, st.cct, self.registry, ident, mods)
            out[f"cpu_{i}"] = path
            tw = TraceWriter(path.replace(".rpro", ".rtrc"), ident)
            # dispatch events arrive as monitor drain chunks (batched
            # trace appends); cpu_region events as scalar tuples.  The
            # reader sorts by start when flagged (§4.4), so the
            # concatenation order only needs to be deterministic.
            for chunk in st.trace_chunks:
                tw.append_chunk(chunk)
            recs = np.asarray(st.trace, np.uint64).reshape(-1, 3)
            tw.append_many(recs[:, 0], recs[:, 1], recs[:, 2])
            tw.close()
            out[f"cpu_trace_{i}"] = tw.path
        with self._stream_lock:
            streams = dict(self._stream_ccts)
        for sid, cct in sorted(streams.items()):
            ident = identity(stream=sid, type="gpu")
            path = os.path.join(self.out_dir,
                                f"profile_{fp}r{self.rank}_s{sid}.rpro")
            write_profile(path, cct, self.registry, ident, mods)
            out[f"gpu_{sid}"] = path
        # GPU stream traces from the tracing threads.  Events carry the
        # dispatching app thread's CCT node id; encode the dispatcher's
        # thread index into the high ctx bits and name its profile in
        # the identity, so aggregation converts every event through the
        # right thread's gmap (no more ctx_unmapped pass-through).
        tid_to_idx = {tid: st.index for tid, st in self._threads.items()}
        for tt in self._monitor._trace_threads:
            for sid, recs in tt.records.items():
                arr = np.asarray(recs, np.int64).reshape(-1, 4)
                idxs = np.asarray([tid_to_idx.get(int(t), -1)
                                   for t in arr[:, 3]], np.int64)
                if len(arr) and (idxs >= 0).all():
                    ctx = pack_dispatch_ctx(idxs, arr[:, 2])
                    used = sorted(set(idxs.tolist()))
                    ident = identity(
                        stream=sid, type="gpu",
                        dispatch_profiles={
                            str(i): f"profile_{fp}r{self.rank}_t{i}.rpro"
                            for i in used})
                else:   # dispatcher unknown: raw node ids, as before
                    ctx = arr[:, 2]
                    ident = identity(stream=sid, type="gpu")
                tw = TraceWriter(
                    os.path.join(self.out_dir,
                                 f"trace_{fp}r{self.rank}_s{sid}.rtrc"),
                    ident)
                tw.append_many(arr[:, 0], arr[:, 1], ctx)
                tw.close()
                out[f"gpu_trace_{sid}"] = tw.path
        return out

    def trace_rows_us(self, base_time_ns: int) -> np.ndarray:
        """(start, end) of every dispatch's trace row, of every thread, on
        torch.profiler's timeline: microseconds after ``base_time_ns`` (a
        chrome trace's ``baseTimeNanoseconds``), as the trace's ``ts``.
        torch.profiler stamps ``ts`` so that ``ts + baseTimeNanoseconds``
        is ``time.time_ns()``; the rows are on the profiler's clock, the
        default ``time.monotonic_ns``, which ``clock_anchor`` ties to it.
        Call after ``flush``."""
        chunks = [c[:, :2] for st in list(self._threads.values())
                  for c in st.trace_chunks]
        if not chunks or self.clock_anchor is None:
            return np.zeros((0, 2))
        c0, w0 = self.clock_anchor
        rows = np.concatenate(chunks).astype(np.int64)
        return (rows - c0 + (w0 - int(base_time_ns))) / 1e3

    def _ring_wait(self, append, *args) -> None:
        # the ring is full: the monitor is >capacity records behind.
        # Yield the GIL until it catches up (bounded by monitor
        # liveness — the same contract the channel spin had).
        while not append(*args):
            time.sleep(0)

    def build_trace_db(self, out_path: Optional[str] = None) -> str:
        """Post-mortem step next to aggregation: merge this measurement
        directory's per-thread/per-stream trace files into one seekable
        ``trace.db`` (repro.traceview).  Note the merged events carry this
        rank's *local* ctx ids; ``aggregate(..., trace_paths=...)`` builds
        the globally-renumbered trace.db in the database directory.
        """
        from repro_torch.traceview.tracedb import build_db
        out_path = out_path or os.path.join(self.out_dir, "trace.db")
        build_db(self.out_dir, out_path)
        return out_path


class _Dispatch:
    """The dispatch-path context manager — a slotted object instead of a
    ``@contextmanager`` generator (the generator machinery alone cost
    more than the ring appends it brackets).  One instance per dispatch;
    ``__enter__`` publishes the OP record, ``__exit__`` the ACTIVITY
    record + trace-lane row and the thread's counter tuple.  While
    torch.profiler records (``scope.recording()``) the dispatch is also a
    span named as its placeholder (``scope.SPAN_PREFIX + "kernel:step"``),
    opened before the tool's own work and closed after it."""

    __slots__ = ("_p", "_st", "_ctx", "_ph", "_te0", "_t0", "_seq", "_rf",
                 "kind", "name", "stream", "module_id", "nbytes",
                 "duration_ns")

    def __init__(self, profiler: Profiler, kind: str, name: str,
                 stream: int, module_id: Optional[int], nbytes: int,
                 duration_ns: Optional[int]):
        self._p = profiler
        self.kind = kind
        self.name = name
        self.stream = stream
        self.module_id = module_id
        self.nbytes = nbytes
        self.duration_ns = duration_ns

    def __enter__(self) -> CCTNode:
        p = self._p
        rf = None
        if scope.recording():
            rf = torch.profiler.record_function(
                f"{scope.SPAN_PREFIX}{self.kind}:{self.name}")
            rf.__enter__()
        self._rf = rf
        te0 = p.clock()
        self._te0 = te0
        st = p._threads.get(p._tid())
        if st is None:
            st = p._state()
        self._st = st
        st.open = True
        ctx = p._dispatch_context(st)
        self._ctx = ctx
        ph_key = (ctx, self.kind, self.name, self.stream)
        ph = st.ph_cache.get(ph_key)
        if ph is None:
            ph = st.cct.get_or_insert(
                ctx, Frame(PLACEHOLDER, f"{self.kind}:{self.name}",
                           str(self.stream), 0))
            st.ph_cache[ph_key] = ph
        self._ph = ph
        seq = st.seq
        st.seq = seq + 1
        self._seq = seq
        rec = (OP, seq, ph)
        if not st.ring.try_append(rec):
            p._ring_wait(st.ring.try_append, rec)
        self._t0 = p.clock()
        return ph

    def __exit__(self, *exc) -> None:
        p = self._p
        st = self._st
        t0 = self._t0
        t1 = p.clock()
        dur = self.duration_ns if self.duration_ns is not None else t1 - t0
        n_budget = 0
        base = 0
        if self.kind == "kernel" and self.module_id in p._modules:
            if p.instrument:
                n_budget = -1           # sentinel: exact op counts
            else:
                dur_s = dur * 1e-9
                rate = p.sample_rate_hz
                base = sampling.sample_budget(dur_s, rate)
                n_budget = sampling.sample_budget(
                    dur_s, rate * p.sample_scale, p.sample_cap)
        rec = (ACTIVITY, self._seq, self.kind, self.name, self.stream,
               self.module_id, self._ph, self.nbytes, n_budget, base)
        t_end = t0 + dur
        ring = st.ring
        if not ring.try_append_timed(rec, t0, t_end, self._ctx.node_id):
            p._ring_wait(ring.try_append_timed, rec, t0, t_end,
                         self._ctx.node_id)
        te1 = p.clock()
        c = st.counts
        st.counts = (c[0] + (t0 - self._te0) + (te1 - t1),
                     c[1] + (t1 - t0), c[2] + 1)     # one atomic publish
        st.open = False
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
