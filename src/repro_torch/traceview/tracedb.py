"""Merged trace database — the ``trace.db`` analogue (paper §4.4, §6.1;
"Preparing for Performance Analysis at Exascale" motivates the format).

``hpcprof`` merges N per-rank/per-stream trace files into *one* seekable
database so post-mortem tools never re-open thousands of small files and
never re-sort events.  We do the same:

- one header (JSON, canonical encoding) with an **identity index**: every
  trace line's identity dict plus its (element offset, event count) into
  the data region;
- one int64 data region holding, per line, the three columns
  ``starts | ends | ctx`` contiguously, with starts **sorted at merge
  time** (the writer's out-of-order flag is consumed exactly once, here,
  instead of by every reader — §4.4);
- the data region is 64-byte aligned and read back with ``np.memmap``, so
  opening a multi-GB database touches only the header and each view is a
  zero-copy slice.

Merging is idempotent: rebuilding a database from an existing ``trace.db``
produces byte-identical output (canonical line order + canonical JSON),
which tests/test_traceview.py locks in.

Layout::

    MAGIC "RTDB" | u32 version | u64 header_len | header JSON | pad to 64
    int64 data[]   (per line: count starts, count ends, count ctx)
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import struct
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.trace import (DISPATCH_CTX_MASK, TraceData, read_trace,
                              sorted_by_start)

MAGIC = b"RTDB"
VERSION = 1
_ALIGN = 64
_HDR = struct.Struct("<4sIQ")    # magic, version, header json length


def _line_key(identity: dict) -> tuple:
    """Canonical line order: host, rank, CPU threads before GPU streams,
    then thread/stream index (hpctraceviewer's process.thread ordering)."""
    return (str(identity.get("host", "")),
            int(identity.get("rank", 0)),
            0 if identity.get("type", "cpu") == "cpu" else 1,
            int(identity.get("thread", identity.get("stream", 0)) or 0),
            json.dumps(identity, sort_keys=True))


Source = Union[str, TraceData]


def _decode_dispatch(td: TraceData) -> TraceData:
    """A raw GPU-stream trace from ``Profiler.write()`` encodes the
    dispatching thread index in the high ctx bits (repro.core.trace).
    Aggregation consumes that encoding (pipeline.traceconv); a trace.db
    built straight from a measurement directory wants plain local node
    ids, so strip it here — the pre-encoding behavior."""
    if not td.identity.get("dispatch_profiles"):
        return td
    identity = {k: v for k, v in td.identity.items()
                if k != "dispatch_profiles"}
    ctx = np.asarray(td.ctx, np.int64) & DISPATCH_CTX_MASK
    return TraceData(identity, td.starts, td.ends, ctx)


def _load_sources(sources: Union[Source, Sequence[Source]]
                  ) -> List[TraceData]:
    """Expand sources into trace lines.  A source is a measurement
    directory (all ``*.rtrc`` inside), a single ``.rtrc`` file, an
    existing ``trace.db`` (whose lines re-merge unchanged), or an
    in-memory ``TraceData`` line (the database merge hands remapped
    lines straight in — repro.core.merge)."""
    if isinstance(sources, (str, TraceData)):
        sources = [sources]
    lines: List[TraceData] = []
    for src in sources:
        if isinstance(src, TraceData):
            # materialized by the caller when the arrays view a file this
            # build may overwrite (sorted_by_start copies only if unsorted)
            lines.append(_decode_dispatch(src))
        elif os.path.isdir(src):
            for p in sorted(glob.glob(os.path.join(src, "*.rtrc"))):
                lines.append(_decode_dispatch(read_trace(p)))
        elif src.endswith(".rtrc"):
            lines.append(_decode_dispatch(read_trace(src)))
        else:
            # materialize: line_views are zero-copy views into the mapped
            # file, which build_db may be about to overwrite in place
            with TraceDB(src) as db:
                lines.extend(TraceData(td.identity, np.array(td.starts),
                                       np.array(td.ends), np.array(td.ctx))
                             for td in db.line_views())
    return lines


def build_db(sources: Union[Source, Sequence[Source]],
             out_path: str) -> "TraceDB":
    """Merge per-identity trace files into one seekable ``trace.db``."""
    lines = [sorted_by_start(td) for td in _load_sources(sources)]
    lines.sort(key=lambda td: _line_key(td.identity))
    index = []
    offset = 0
    for td in lines:
        n = len(td.starts)
        index.append({"identity": td.identity, "offset": offset, "count": n})
        offset += 3 * n
    t_min = min((int(td.starts[0]) for td in lines if len(td.starts)),
                default=0)
    t_max = max((int(td.ends.max()) for td in lines if len(td.ends)),
                default=0)
    header = json.dumps(
        {"version": VERSION, "n_events": offset // 3,
         "t_min": t_min, "t_max": t_max, "lines": index},
        sort_keys=True, separators=(",", ":")).encode()
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, len(header)))
        f.write(header)
        pos = _HDR.size + len(header)
        f.write(b"\0" * (-pos % _ALIGN))
        for td in lines:
            f.write(td.starts.astype("<i8").tobytes())
            f.write(td.ends.astype("<i8").tobytes())
            f.write(td.ctx.astype("<i8").tobytes())
    os.replace(tmp_path, out_path)   # atomic; safe for in-place re-merge
    return TraceDB(out_path)


@dataclasses.dataclass
class TraceLine:
    identity: dict
    offset: int       # element offset into the data region
    count: int


class TraceDB:
    """Memory-mapped reader.  ``starts/ends/ctx(i)`` are zero-copy slices
    of the mapped data region; ``view(i)`` wraps them as the same
    ``TraceData`` the pre-merge tools (blame, viewer) consume.

    Context manager: ``close()`` releases the mapping, so tools that
    scan many databases (the fleet daemon, pyramid builds) don't
    accumulate open file mappings; re-merging a database in place is
    safe once its readers are closed.  Accessors raise ``ValueError``
    after close."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic, version, hdr_len = _HDR.unpack(f.read(_HDR.size))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a trace.db (bad magic)")
            if version != VERSION:
                raise ValueError(f"{path}: unsupported version {version}")
            hdr = json.loads(f.read(hdr_len))
        data_offset = (_HDR.size + hdr_len + _ALIGN - 1) // _ALIGN * _ALIGN
        self.t_min: int = hdr["t_min"]
        self.t_max: int = hdr["t_max"]
        self.n_events: int = hdr["n_events"]
        self.lines: List[TraceLine] = [
            TraceLine(ln["identity"], ln["offset"], ln["count"])
            for ln in hdr["lines"]]
        self._data = np.memmap(path, np.int64, mode="r", offset=data_offset,
                               shape=(3 * self.n_events,)) \
            if self.n_events else np.zeros(0, np.int64)

    def close(self) -> None:
        data, self._data = self._data, None
        if isinstance(data, np.memmap):
            data._mmap.close()

    def __enter__(self) -> "TraceDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.lines)

    def _slice(self, lo: int, hi: int) -> np.ndarray:
        if self._data is None:
            raise ValueError(f"{self.path}: trace.db reader is closed")
        return self._data[lo:hi]

    def raw(self) -> np.ndarray:
        """The whole mapped int64 data region — every line's
        ``starts|ends|ctx`` blocks concatenated, addressed via
        ``lines[i].offset``.  The pyramid's batched occupancy gathers
        candidate events of many (line, edge) pairs in one fancy index
        instead of a per-line slice loop."""
        if self._data is None:
            raise ValueError(f"{self.path}: trace.db reader is closed")
        return self._data

    def starts(self, i: int) -> np.ndarray:
        ln = self.lines[i]
        return self._slice(ln.offset, ln.offset + ln.count)

    def ends(self, i: int) -> np.ndarray:
        ln = self.lines[i]
        return self._slice(ln.offset + ln.count, ln.offset + 2 * ln.count)

    def ctx(self, i: int) -> np.ndarray:
        ln = self.lines[i]
        return self._slice(ln.offset + 2 * ln.count,
                           ln.offset + 3 * ln.count)

    def view(self, i: int) -> TraceData:
        return TraceData(self.lines[i].identity, self.starts(i),
                         self.ends(i), self.ctx(i))

    def line_views(self) -> List[TraceData]:
        return [self.view(i) for i in range(len(self.lines))]

    def time_range(self) -> Tuple[int, int]:
        return self.t_min, self.t_max
