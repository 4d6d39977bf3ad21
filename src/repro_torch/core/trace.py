"""Trace files (paper §3, §4.1, §4.4): per CPU-thread / GPU-stream sequences
of (t_start, t_end, cct_node) events.

Per §4.4: CUPTI usually orders activities within a stream but the order is
undefined for OpenCL (and even Power9+CUPTI produced overlaps), so rather
than ordering online, the writer just *notes* out-of-order appends and the
post-mortem reader sorts when the flag is set.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

import numpy as np

_REC = struct.Struct("<QQI")
MAGIC = b"RTRC"

# GPU-stream traces written by ``Profiler.write()`` record, per event,
# the *dispatching app thread* alongside the CCT node: the thread index
# rides the high ctx bits and the identity's ``dispatch_profiles`` maps
# thread index -> profile basename.  Phase 5 of aggregation
# (``repro.core.pipeline.traceconv``) converts each event through its
# dispatcher's gmap — the fix for the former ``ctx_unmapped`` flagging
# of profiler GPU-stream traces.
DISPATCH_CTX_SHIFT = 32
DISPATCH_CTX_MASK = (1 << DISPATCH_CTX_SHIFT) - 1


def pack_dispatch_ctx(thread_idx, node_id):
    """Encode (dispatcher thread index, CCT node id) into one ctx value
    (array-friendly: accepts numpy arrays)."""
    import numpy as _np
    return ((_np.asarray(thread_idx, _np.uint64) << DISPATCH_CTX_SHIFT)
            | _np.asarray(node_id, _np.uint64))


class TraceWriter:
    def __init__(self, path: str, identity: dict):
        self.path = path
        self.identity = identity
        self._records: List[Tuple[int, int, int]] = []
        self._chunks: List[np.ndarray] = []
        # invariant: the start of the last event written through EITHER
        # append API — append after append_many must compare against the
        # chunk's last start (tests/test_traceview.py interleaves both)
        self._last_start = -1
        self.out_of_order = False

    def append(self, t_start: int, t_end: int, ctx_id: int) -> None:
        if t_start < self._last_start:
            self.out_of_order = True  # noted; sorted post-mortem (§4.4)
        self._last_start = t_start
        self._records.append((t_start, t_end, ctx_id))

    def append_many(self, starts, ends, ctx_ids) -> None:
        """Bulk append: one vectorized out-of-order check and one array
        copy instead of a Python call per event.  Produces byte-identical
        files to the equivalent sequence of ``append`` calls."""
        starts = np.asarray(starts)
        n = len(starts)
        if n == 0:
            return
        if self._records:   # preserve interleaving with scalar appends
            self._chunks.append(
                np.asarray(self._records, np.uint64).reshape(-1, 3))
            self._records = []
        s64 = starts.astype(np.int64)
        if int(s64[0]) < self._last_start or bool((s64[1:] < s64[:-1]).any()):
            self.out_of_order = True
        self._last_start = int(s64[-1])
        chunk = np.empty((n, 3), np.uint64)
        chunk[:, 0] = starts
        chunk[:, 1] = np.asarray(ends)
        chunk[:, 2] = np.asarray(ctx_ids)
        self._chunks.append(chunk)

    def append_chunk(self, chunk: "np.ndarray") -> None:
        """Adopt a prebuilt ``(n, 3)`` event chunk without re-packing —
        the buffered-trace path: the monitor thread gathers one chunk
        per ring drain (``RecordRing.read_batch`` trace-lane rows) and
        the writer takes it wholesale, one call per drain batch.  Chunk
        boundaries never reach the file (``close`` concatenates), so
        any batch split produces byte-identical output to per-event
        ``append`` calls in the same order."""
        chunk = np.asarray(chunk)
        if chunk.ndim != 2 or chunk.shape[1] != 3:
            raise ValueError("append_chunk wants an (n, 3) event array")
        if not len(chunk):
            return
        if chunk.dtype == np.int64:
            chunk = chunk.view(np.uint64)       # same bits, no copy
        elif chunk.dtype != np.uint64:
            chunk = chunk.astype(np.uint64)
        if self._records:   # preserve interleaving with scalar appends
            self._chunks.append(
                np.asarray(self._records, np.uint64).reshape(-1, 3))
            self._records = []
        s64 = chunk[:, 0].astype(np.int64)
        if int(s64[0]) < self._last_start or bool((s64[1:] < s64[:-1]).any()):
            self.out_of_order = True
        self._last_start = int(s64[-1])
        self._chunks.append(chunk)

    def close(self) -> None:
        import json
        with open(self.path, "wb") as f:
            hdr = json.dumps({"identity": self.identity,
                              "out_of_order": self.out_of_order}).encode()
            f.write(MAGIC + struct.pack("<I", len(hdr)) + hdr)
            parts = list(self._chunks)
            if self._records:
                parts.append(
                    np.asarray(self._records, np.uint64).reshape(-1, 3))
            if parts:
                arr = np.concatenate(parts)
            else:
                arr = np.zeros((0, 3), np.uint64)
            f.write(arr.tobytes())


@dataclasses.dataclass
class TraceData:
    identity: dict
    starts: np.ndarray
    ends: np.ndarray
    ctx: np.ndarray


def sorted_by_start(td: TraceData) -> TraceData:
    """Events stable-sorted by start time, as int64 arrays — the §4.4
    post-mortem sort, shared by the trace.db merge and the traceview
    interval stats.  Returns a new TraceData; arrays are views of the
    input when already sorted."""
    starts = np.asarray(td.starts, np.int64)
    ends = np.asarray(td.ends, np.int64)
    ctx = np.asarray(td.ctx, np.int64)
    if len(starts) > 1 and bool((starts[1:] < starts[:-1]).any()):
        order = np.argsort(starts, kind="stable")
        starts, ends, ctx = starts[order], ends[order], ctx[order]
    return TraceData(td.identity, starts, ends, ctx)


def read_trace_header(path: str) -> dict:
    """Read just the JSON header (identity + out-of-order flag) without
    touching the event data — what shard planning and dispatch
    resolution need from a trace file."""
    import json
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not a trace file (bad magic)")
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n))


def read_trace(path: str) -> TraceData:
    import json
    with open(path, "rb") as f:
        assert f.read(4) == MAGIC
        (n,) = struct.unpack("<I", f.read(4))
        hdr = json.loads(f.read(n))
        arr = np.frombuffer(f.read(), np.uint64).reshape(-1, 3)
    starts, ends, ctx = arr[:, 0], arr[:, 1], arr[:, 2].astype(np.int64)
    if hdr.get("out_of_order"):
        order = np.argsort(starts, kind="stable")  # post-mortem sort (§4.4)
        starts, ends, ctx = starts[order], ends[order], ctx[order]
    return TraceData(hdr["identity"], starts.astype(np.int64),
                     ends.astype(np.int64), ctx)
