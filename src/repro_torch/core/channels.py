"""Wait-free single-producer/single-consumer queues and bidirectional
channels (paper §4.1).

The paper coordinates application threads, a GPU monitor thread, and tracing
threads exclusively through *bidirectional channels*, each a pair of
wait-free SPSC queues — deliberately avoiding multi-producer queues (the
OpenCL/Level-Zero discussion in §4.1 exists precisely to preserve the
single-producer invariant).

Wait-freedom here: ``try_push`` and ``try_pop`` complete in a bounded number
of steps regardless of what the peer thread does — there are no locks, no
CAS retry loops, and no blocking.  The producer writes only ``_tail`` and
the slot it owns; the consumer writes only ``_head`` and clears the slot it
owns.  In CPython the GIL guarantees that the int stores publish with the
required ordering (slot write happens-before tail increment in program
order, and bytecode boundaries act as full fences); in C this would be a
release store on tail / acquire load on head, exactly as in [34].
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_EMPTY = object()


class SpscQueue:
    """Bounded wait-free SPSC ring queue."""

    __slots__ = ("_slots", "_capacity", "_head", "_tail",
                 "push_failures", "pushes", "pops")

    def __init__(self, capacity: int = 4096):
        assert capacity > 0
        self._slots: List[Any] = [None] * capacity
        self._capacity = capacity
        self._head = 0  # written only by the consumer
        self._tail = 0  # written only by the producer
        self.push_failures = 0
        self.pushes = 0
        self.pops = 0

    def try_push(self, item: Any) -> bool:
        """Producer-only.  Returns False when full (never blocks)."""
        tail = self._tail
        if tail - self._head >= self._capacity:
            self.push_failures += 1
            return False
        self._slots[tail % self._capacity] = item  # write slot ...
        self._tail = tail + 1                      # ... then publish
        self.pushes += 1
        return True

    def try_pop(self) -> Any:
        """Consumer-only.  Returns ``EMPTY`` when no item is ready."""
        head = self._head
        if head >= self._tail:
            return _EMPTY
        slot = head % self._capacity
        item = self._slots[slot]
        self._slots[slot] = None                   # release reference ...
        self._head = head + 1                      # ... then consume
        self.pops += 1
        return item

    def try_push_many(self, items: Sequence[Any]) -> int:
        """Producer-only batch push.  Returns how many items were accepted
        (0 when full; may be fewer than ``len(items)``).

        All accepted slots are written first and ``_tail`` is published
        once for the whole batch, so the wait-free SPSC invariant is
        unchanged while the per-item call overhead is paid once per batch.
        The consumer may concurrently advance ``_head``; the availability
        snapshot taken here is then a lower bound, which is safe.
        """
        if not items:
            return 0
        tail = self._tail
        avail = self._capacity - (tail - self._head)
        n = len(items) if avail >= len(items) else max(avail, 0)
        if n <= 0:
            self.push_failures += 1
            return 0
        slots, cap = self._slots, self._capacity
        for k in range(n):
            slots[(tail + k) % cap] = items[k]   # write slots ...
        self._tail = tail + n                    # ... then publish once
        self.pushes += n
        if n < len(items):
            self.push_failures += 1
        return n

    def try_pop_many(self, limit: Optional[int] = None) -> List[Any]:
        """Consumer-only batch pop.  Returns up to ``limit`` ready items
        (empty list when none).  ``_head`` is published once per batch."""
        head = self._head
        n = self._tail - head
        if limit is not None and n > limit:
            n = limit
        if n <= 0:
            return []
        slots, cap = self._slots, self._capacity
        out = [None] * n
        for k in range(n):
            i = (head + k) % cap
            out[k] = slots[i]
            slots[i] = None                      # release references ...
        self._head = head + n                    # ... then consume once
        self.pops += n
        return out

    def drain(self, limit: Optional[int] = None) -> Iterator[Any]:
        """Consumer-only: pop until empty (or ``limit`` items)."""
        count = itertools.count() if limit is None else iter(range(limit))
        for _ in count:
            item = self.try_pop()
            if item is _EMPTY:
                return
            yield item

    def __len__(self) -> int:  # approximate (racy but monotonic-safe)
        return max(0, self._tail - self._head)

    @property
    def empty(self) -> bool:
        return self._head >= self._tail


EMPTY = _EMPTY


class BidirectionalChannel:
    """A pair of SPSC queues between exactly two threads (paper Fig. 2).

    ``forward`` carries operation tuples (I, P, C_A) from an application
    thread to the monitor thread; ``backward`` is the *activity channel*
    carrying (A, P) pairs back.
    """

    def __init__(self, capacity: int = 4096):
        self.forward = SpscQueue(capacity)   # app -> monitor ("operation")
        self.backward = SpscQueue(capacity)  # monitor -> app ("activity")

    # convenience aliases matching the paper's terminology
    @property
    def operation(self) -> SpscQueue:
        return self.forward

    @property
    def activity(self) -> SpscQueue:
        return self.backward


class ChannelSet:
    """Registry of per-thread channels owned by the monitor thread.

    Registration itself is the only locked operation (it happens once per
    thread, off the hot path); all steady-state communication is wait-free.
    """

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._channels: dict = {}
        self._capacity = capacity

    def channel_for(self, thread_id) -> BidirectionalChannel:
        ch = self._channels.get(thread_id)
        if ch is None:
            with self._lock:
                ch = self._channels.get(thread_id)
                if ch is None:
                    ch = BidirectionalChannel(self._capacity)
                    self._channels[thread_id] = ch
        return ch

    def items(self):
        # dict iteration is safe w.r.t. concurrent inserts under the GIL;
        # take a snapshot to be explicit.
        return list(self._channels.items())


class RecordRing:
    """Per-thread wait-free record ring for the dispatch hot path.

    One application thread is the only producer; the monitor thread is
    the only consumer.  Compared to ``SpscQueue`` the ring is tuned for
    the profiler's record traffic:

    - the producer appends one payload tuple per record with a **single
      release-store of the write cursor** (slot write, then
      ``_tail = tail + 1``; under the GIL the int store publishes with
      the required ordering, in C it would be a release store);
    - timed records additionally carry a ``(t_start, t_end, ctx)``
      triple in a numpy-backed **trace lane** alongside the slot, so
      the consumer can lift a whole drain batch of trace events with
      one vectorized gather instead of re-packing Python tuples;
    - the consumer reads in **epoch-stamped batches**
      (``read_batch``): one cursor snapshot, one gather, one
      ``_head`` publish per batch — per-thread FIFO order preserved.

    ``try_append*`` never blocks: a full ring returns False and counts
    ``full_waits`` (the producer decides whether to retry; the profiler
    yields the GIL so the consumer can drain).
    """

    __slots__ = ("_slots", "_lane", "_capacity", "_head", "_tail",
                 "appends", "reads", "epoch", "full_waits")

    LANE_COLS = 3          # (t_start, t_end, ctx) int64 columns

    def __init__(self, capacity: int = 1 << 15):
        assert capacity > 0
        self._slots: List[Any] = [None] * capacity
        self._lane = np.zeros((capacity, self.LANE_COLS), np.int64)
        self._capacity = capacity
        self._head = 0          # written only by the consumer
        self._tail = 0          # written only by the producer
        self.appends = 0
        self.reads = 0
        self.epoch = 0          # one per consumed batch
        self.full_waits = 0

    # -- producer side ------------------------------------------------------
    def try_append(self, payload: Any) -> bool:
        """Append an untimed record (no trace-lane row).  Returns False
        when full (never blocks)."""
        tail = self._tail
        if tail - self._head >= self._capacity:
            self.full_waits += 1
            return False
        self._slots[tail % self._capacity] = payload   # write slot ...
        self._tail = tail + 1                          # ... publish once
        self.appends += 1
        return True

    def try_append_timed(self, payload: Any, t_start: int, t_end: int,
                         ctx: int) -> bool:
        """Append a record with a trace-lane row riding along (the
        batched-trace path: the consumer gathers lane rows per drain)."""
        tail = self._tail
        if tail - self._head >= self._capacity:
            self.full_waits += 1
            return False
        i = tail % self._capacity
        lane = self._lane
        lane[i, 0] = t_start
        lane[i, 1] = t_end
        lane[i, 2] = ctx
        self._slots[i] = payload                       # write slot ...
        self._tail = tail + 1                          # ... publish once
        self.appends += 1
        return True

    # -- consumer side ------------------------------------------------------
    def read_batch(self, limit: int = 1024
                   ) -> Optional[Tuple[List[Any], "np.ndarray", int]]:
        """Consume up to ``limit`` records: returns
        ``(payloads, lane_rows, epoch)`` or None when empty.
        ``lane_rows`` is an owned (n, 3) int64 copy aligned with
        ``payloads`` (rows of untimed records are stale and must be
        selected by payload tag).  ``_head`` is published once."""
        head = self._head
        n = self._tail - head
        if n > limit:
            n = limit
        if n <= 0:
            return None
        cap = self._capacity
        idx = np.arange(head, head + n) % cap
        lane_rows = self._lane[idx]                    # gather (a copy)
        slots = self._slots
        ii = idx.tolist()
        payloads = [slots[i] for i in ii]
        for i in ii:
            slots[i] = None                            # release refs ...
        self._head = head + n                          # ... publish once
        self.reads += n
        self.epoch += 1
        return payloads, lane_rows, self.epoch

    def __len__(self) -> int:  # approximate (racy but monotonic-safe)
        return max(0, self._tail - self._head)

    @property
    def empty(self) -> bool:
        return self._head >= self._tail


class RingSet:
    """Registry of per-thread record rings, drained by the monitor.

    Registration is the only locked operation (once per thread, off the
    hot path).  ``items()`` yields rings in registration order — a
    deterministic per-process drain order (attribution order within a
    thread is the ring's FIFO order either way)."""

    def __init__(self, capacity: int = 1 << 15):
        self._lock = threading.Lock()
        self._rings: dict = {}
        self._capacity = capacity

    def ring_for(self, thread_id) -> RecordRing:
        r = self._rings.get(thread_id)
        if r is None:
            with self._lock:
                r = self._rings.get(thread_id)
                if r is None:
                    r = RecordRing(self._capacity)
                    self._rings[thread_id] = r
        return r

    def items(self):
        return list(self._rings.items())
