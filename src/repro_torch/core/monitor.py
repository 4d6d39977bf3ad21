"""Measurement runtime (paper §4.1, Fig. 2): application threads, one GPU
monitor thread, and N tracing threads coordinated via wait-free,
per-thread record rings.

Message flow (the OpenCL/Level-Zero variant of §4.1, since on this stack
the completion "callback" runs on the application thread):

  app thread:   dispatch I  -> unwind stack, insert placeholder P
                            -> OP record (I, P) on its record ring
                completion  -> ACTIVITY record (A, P) + trace-lane row
                               on the same ring (one cursor publish each)
  monitor:      drains every thread's ring in epoch-stamped batches
                (``RecordRing.read_batch``); hands each batch to the
                profiler's record handler, which performs the deferred
                PC-sample draw, hardware-counter read, and metric
                attribution into the thread's *shadow* CCT; completed
                (A, P) pairs route onward to the per-stream trace
                channels; trace-lane rows become one buffered trace
                chunk per drain
  tracing thrd: polls its set of trace channels, appends to trace files
  app thread:   never sees the records again — the shadow CCTs graft
                into the per-thread trees at flush, when the owning
                threads are quiescent (profiler.py).

The ring's single producer (its app thread) and single consumer (the
monitor) keep every queue SPSC — the design point §4.1 makes
explicitly — and the monitor being the only caller of the record
handler is what lets the deferred draw, counter rotation, and shadow
attribution all run lock-free on one thread.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.channels import RingSet, SpscQueue
from repro_torch.core.cct import CCTNode

OP = 0
ACTIVITY = 1
SHUTDOWN = 2


@dataclasses.dataclass(slots=True)
class GpuOperation:
    """Invocation record I."""
    corr_id: int
    kind: str                 # kernel | copy | sync
    name: str
    stream: int
    placeholder: CCTNode
    module_id: Optional[int] = None


@dataclasses.dataclass(slots=True)
class GpuActivity:
    """Measurement record A."""
    corr_id: int
    kind: str
    name: str
    stream: int
    t_start: int
    t_end: int
    bytes: int = 0
    samples: Optional[list] = None      # fine-grained records (§4.2)
    module_id: Optional[int] = None
    meta: Optional[dict] = None

    @property
    def duration(self) -> int:
        return self.t_end - self.t_start


# the record handler: (thread_id, payloads, lane_rows) ->
# (completed [(GpuActivity, placeholder)], stat increments)
RecordHandler = Callable[[int, List[Any], Any], tuple]


class MonitorThread:
    """The GPU monitor thread of Fig. 2."""

    def __init__(self, rings: RingSet, handler: RecordHandler,
                 tracing: bool = False, n_tracing_threads: int = 1,
                 poll_s: float = 1e-4, batch: int = 1024):
        self._rings = rings
        self._handler = handler
        self._tracing = tracing
        self._poll_s = poll_s
        self._batch = batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="repro-gpu-monitor",
                                        daemon=True)
        # True while a popped batch is being processed: quiesce() must
        # not declare the system drained based on empty rings alone,
        # because up to ``batch`` records can be in flight here
        self._routing = False
        # per-stream trace channels; monitor is the single producer
        self._trace_channels: Dict[int, SpscQueue] = {}
        self._trace_threads: List[TracingThread] = []
        self._n_tracing = max(1, n_tracing_threads)
        self.stats = {"ops": 0, "activities": 0, "routed": 0,
                      "counter_records": 0, "drains": 0}
        # (stream, [(A, P), ...]) -> None, one call per drained batch
        self.trace_sink: Optional[Callable] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._tracing:
            for i in range(self._n_tracing):
                t = TracingThread(i, poll_s=self._poll_s)
                self._trace_threads.append(t)
                t.start()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        for t in self._trace_threads:
            t.stop()

    def quiesce(self, timeout: float = 5.0):
        """Wait until all rings and trace channels drain (used by flush)."""
        def queues_empty():
            if not all(ring.empty for _, ring in self._rings.items()):
                return False
            return not self._tracing or all(
                q.empty for q in self._trace_channels.values())

        def flags_clear():
            return not self._routing and \
                not any(t.busy for t in self._trace_threads)

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # queues / flags / queues / flags.  The flags are raised before
            # each batch pop, so flags reading False rules out a batch
            # popped from rings a preceding scan saw empty; the second
            # queue scan catches records a routing round moved *into* a
            # trace queue between the first scan and the flag read, and the
            # final flag read catches a tracer that popped that handoff
            # right before the second scan and is still appending it.
            if queues_empty() and flags_clear() \
                    and queues_empty() and flags_clear():
                return True
            time.sleep(self._poll_s)
        return False

    # -- the monitor loop ----------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            busy = self._drain_once()
            if not busy:
                time.sleep(self._poll_s)
        # final drain on shutdown
        for _ in range(16):
            if not self._drain_once():
                break

    def _drain_once(self) -> bool:
        """One polling round: one epoch-stamped batch read per ring,
        handed wholesale to the record handler (deferred draw +
        attribution), completed activities routed to the per-stream
        trace channels.  Per-thread FIFO order is the ring's order; the
        cross-thread drain order is registration order, and nothing
        downstream depends on it (the handler attributes into
        per-thread shadow trees, and trace merges sort by timestamp)."""
        busy = False
        stats = self.stats
        for tid, ring in self._rings.items():
            # flag raised *before* the read: an observer sees either the
            # flag or a still-non-empty ring, never a silent in-flight gap
            self._routing = True
            got = ring.read_batch(self._batch)
            if got is None:
                self._routing = False
                continue
            busy = True
            payloads, lane, _epoch = got
            acts, hstats = self._handler(tid, payloads, lane)
            for k, v in hstats.items():
                stats[k] = stats.get(k, 0) + v
            stats["drains"] += 1
            if acts:
                stats["routed"] += len(acts)
                if self._tracing:
                    traced: Dict[int, List[tuple]] = {}
                    for pair in acts:
                        traced.setdefault(pair[0].stream, []).append(pair)
                    for stream, batch in traced.items():
                        self._push_all(self._trace_queue(stream), batch)
            self._routing = False
        return busy

    def _push_all(self, q: SpscQueue, batch: List[tuple]):
        pos = q.try_push_many(batch)
        while pos < len(batch):
            time.sleep(self._poll_s)  # backpressure, consumer drains
            pos += q.try_push_many(batch[pos:])

    def _trace_queue(self, stream: int) -> SpscQueue:
        q = self._trace_channels.get(stream)
        if q is None:
            q = SpscQueue(1 << 16)
            self._trace_channels[stream] = q
            tt = self._trace_threads[stream % len(self._trace_threads)]
            tt.add_channel(stream, q, self.trace_sink)
        return q


class TracingThread(threading.Thread):
    """Records one or more GPU streams of activities (paper §4.1).

    The number of tracing threads is user-adjustable to balance tracing
    efficiency against tool resource usage.
    """

    def __init__(self, idx: int, poll_s: float = 1e-4):
        super().__init__(name=f"repro-tracer-{idx}", daemon=True)
        self._poll_s = poll_s
        self._stop_evt = threading.Event()
        self._channels: Dict[int, tuple] = {}
        self._pending: List[tuple] = []
        self.records: Dict[int, list] = {}
        # raised before each batch pop (see MonitorThread.quiesce)
        self.busy = False

    def add_channel(self, stream: int, q: SpscQueue, sink):
        # single assignment from the monitor thread; dict insert is atomic
        self._channels[stream] = (q, sink)

    def run(self):
        while not self._stop_evt.is_set():
            busy = self._poll()
            if not busy:
                time.sleep(self._poll_s)
        self._poll()

    def _poll(self) -> bool:
        progressed = False
        for stream, (q, sink) in list(self._channels.items()):
            self.busy = True    # raised before the pop, cleared after append
            batch = q.try_pop_many(1024)
            if not batch:
                self.busy = False
                continue
            progressed = True
            recs = self.records.setdefault(stream, [])
            for act, placeholder in batch:
                # 4th column: the dispatching app thread (rides
                # GpuActivity.meta from the record handler) — write()
                # stamps it into the stream trace so aggregation can
                # convert the node id through that thread's gmap
                tid = (act.meta or {}).get("dispatch_tid", -1)
                recs.append((act.t_start, act.t_end, placeholder.node_id,
                             tid))
            if sink is not None:
                sink(stream, batch)   # one call (and one lock) per batch
            self.busy = False
        return progressed

    def stop(self):
        self._stop_evt.set()
        self.join(timeout=10)
