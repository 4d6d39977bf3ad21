"""PMS / CMS sparse-cube analysis formats (paper §6.2, Fig. 4).

The analysis result is a sparse cube indexed by (profile, context, metric).
Two complementary layouts, each a stack of modified-CSR planes:

- **PMS (Profile-Major Sparse)**: one plane per profile -> compare metrics
  *within* a thread/stream; plane = CSR over (context -> metric, value).
- **CMS (CCT-Major Sparse)**: one plane per context -> compare a metric
  *across* profiles; plane = sparse ``midxs`` array of (metric id, start)
  pairs (many metrics are empty for a context, so even the CSR row array is
  sparsified — the paper's key refinement), then ``pids`` and ``vals``.

Access costs (asserted by tests, matching §6.2): plane locate O(1) via the
offsets vector, metric locate O(log m) by binary search in midxs, a single
(ctx, metric, profile) value O(log m + log p).

Construction mirrors hpcprof-mpi: workers are assigned profiles (PMS) or
contiguous context ranges balanced by plane bytes (~non-zero count, the
paper's CMS load-balance criterion); an exscan over plane sizes yields
every worker's write offset; workers then fill a preallocated memmap
concurrently without further communication, in bounded-memory rounds
(out-of-core).
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CMS_MAGIC = b"RCMS"
PMS_MAGIC = b"RPMS"


@dataclasses.dataclass
class ProfileValues:
    """Sparse values of one profile: parallel arrays (ctx, metric, value)."""
    profile_id: int
    ctx: np.ndarray        # (V,) uint32
    metric: np.ndarray     # (V,) uint32
    values: np.ndarray     # (V,) float64


def _exscan(sizes: Sequence[int]) -> List[int]:
    out = [0]
    for s in sizes[:-1]:
        out.append(out[-1] + int(s))
    return out


# =========================================================================
# CMS
# =========================================================================
def write_cms(path: str, profiles: List[ProfileValues], *,
              n_workers: int = 4, max_round_bytes: int = 1 << 28) -> dict:
    """Builds the CCT-major cube.  Returns size stats."""
    # --- transpose to per-context COO (vectorized) --------------------------
    ctx = np.concatenate([p.ctx for p in profiles]) if profiles else \
        np.zeros(0, np.uint32)
    met = np.concatenate([p.metric for p in profiles]) if profiles else \
        np.zeros(0, np.uint32)
    val = np.concatenate([p.values for p in profiles]) if profiles else \
        np.zeros(0, np.float64)
    pid = np.concatenate([np.full(len(p.ctx), p.profile_id, np.uint32)
                          for p in profiles]) if profiles else \
        np.zeros(0, np.uint32)
    # sort by (ctx, metric, profile)
    order = np.lexsort((pid, met, ctx))
    ctx, met, val, pid = ctx[order], met[order], val[order], pid[order]

    uctx, starts = np.unique(ctx, return_index=True)
    bounds = np.append(starts, len(ctx))

    # per-context plane sizes: midx entries + sentinel, pids, vals
    # (vectorized: unique (ctx, metric) pairs -> metric count per context;
    # the pair table is reused below to build the midxs streams)
    pair = (ctx.astype(np.int64) << 32) | met.astype(np.int64)
    upair, up_first = np.unique(pair, return_index=True)
    upair_plane = np.searchsorted(uctx, (upair >> 32))
    m_counts = np.bincount(upair_plane, minlength=len(uctx)).astype(np.int64)
    n_midxs = m_counts + 1  # + sentinel
    nnz = bounds[1:] - bounds[:-1]
    plane_bytes = n_midxs * 12 + nnz * (4 + 8)
    offsets = np.zeros(len(uctx), np.int64)
    np.cumsum(plane_bytes[:-1], out=offsets[1:len(uctx)])

    header = {
        "n_ctx": int(len(uctx)),
        "n_profiles": int(len(profiles)),
        "nnz": int(len(val)),
    }
    hdr = json.dumps(header).encode()
    index_bytes = len(uctx) * 24
    data_start = 4 + 4 + len(hdr) + 4 + index_bytes
    total = data_start + int(plane_bytes.sum())

    with open(path, "wb") as f:
        f.truncate(total)
    mm = np.memmap(path, np.uint8, "r+")
    mm[:4] = np.frombuffer(CMS_MAGIC, np.uint8)
    mm[4:8] = np.frombuffer(struct.pack("<I", len(hdr)), np.uint8)
    mm[8:8 + len(hdr)] = np.frombuffer(hdr, np.uint8)
    p0 = 8 + len(hdr)
    mm[p0:p0 + 4] = np.frombuffer(struct.pack("<I", len(uctx)), np.uint8)
    # context index: (ctx_id u32, nnz u32, abs offset u64, n_midxs u32) = 20B
    # pad to 24 for alignment
    idx = np.zeros((len(uctx), 3), np.int64)
    idx[:, 0] = uctx
    idx[:, 1] = (n_midxs << 32) | nnz
    idx[:, 2] = offsets + data_start
    mm[p0 + 4:p0 + 4 + index_bytes] = np.frombuffer(idx.tobytes(), np.uint8)

    # --- plane fill ---------------------------------------------------------
    # Workers own disjoint, byte-balanced contiguous plane ranges, filled
    # in bounded rounds (out-of-core): each round assembles a run of
    # planes into one segment with array-level scatters (no per-context
    # Python loop, no per-context np.unique) and writes it to the memmap
    # with a single GIL-releasing copy, then flushes.  The scatter's index
    # arrays cost ~_SEG_TEMP_FACTOR transient bytes per output byte, so
    # rounds are sized at max_round_bytes / _SEG_TEMP_FACTOR — per-worker
    # memory stays bounded by ~max_round_bytes.  Same communication-free
    # exscan+fill construction as hpcprof-mpi.
    n_planes = len(uctx)
    cum_pairs = np.concatenate(([0], np.cumsum(m_counts)))
    cum_bytes = np.cumsum(plane_bytes) if n_planes else np.zeros(0, np.int64)
    data_bytes = int(cum_bytes[-1]) if n_planes else 0
    pid_u8 = np.ascontiguousarray(pid.astype("<u4")).view(np.uint8)
    val_u8 = np.ascontiguousarray(val.astype("<f8")).view(np.uint8)

    def runs(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Concatenated [start, start+len) ranges as one index array."""
        total_ = int(lens.sum())
        if total_ == 0:
            return np.zeros(0, np.int64)
        shift = np.concatenate(([0], np.cumsum(lens)[:-1]))
        return np.repeat(starts - shift, lens) + np.arange(total_)

    def build_segment(lo: int, hi: int) -> np.ndarray:
        """All planes [lo, hi) as one contiguous byte segment."""
        base = int(offsets[lo])
        seg = np.empty(int(cum_bytes[hi - 1]) - base, np.uint8)
        p0, p1 = int(cum_pairs[lo]), int(cum_pairs[hi])
        # midxs stream: per plane its (metric, local start) pairs + sentinel
        midxs = np.zeros((p1 - p0) + (hi - lo),
                         dtype=[("m", "<u4"), ("s", "<u8")])
        pair_dest = np.arange(p1 - p0) + (upair_plane[p0:p1] - lo)
        sentinel_dest = (cum_pairs[lo + 1:hi + 1] - p0) + np.arange(hi - lo)
        midxs["m"][pair_dest] = (upair[p0:p1] & 0xFFFFFFFF).astype(np.uint32)
        midxs["s"][pair_dest] = up_first[p0:p1] - bounds[upair_plane[p0:p1]]
        midxs["m"][sentinel_dest] = 0xFFFFFFFF
        midxs["s"][sentinel_dest] = nnz[lo:hi]
        off = offsets[lo:hi] - base
        seg[runs(off, n_midxs[lo:hi] * 12)] = midxs.view(np.uint8)
        b0, b1 = int(bounds[lo]) * 4, int(bounds[hi]) * 4
        seg[runs(off + n_midxs[lo:hi] * 12, nnz[lo:hi] * 4)] = pid_u8[b0:b1]
        seg[runs(off + n_midxs[lo:hi] * 12 + nnz[lo:hi] * 4,
                 nnz[lo:hi] * 8)] = val_u8[b0 * 2:b1 * 2]
        return seg

    # contiguous plane ranges balanced by plane bytes, one per worker
    targets = np.linspace(0, data_bytes, n_workers + 1)[1:-1]
    plane_cuts = [0] + [int(c) for c in
                        np.searchsorted(cum_bytes, targets)] + [n_planes]
    _SEG_TEMP_FACTOR = 10
    seg_budget = max(max_round_bytes // _SEG_TEMP_FACTOR, 1 << 20)

    if data_bytes <= seg_budget:
        # in-budget fast path: one vectorized build, workers only memcpy
        buf = build_segment(0, n_planes) if n_planes else             np.zeros(0, np.uint8)

        def fill(w: int):
            lo = int(offsets[plane_cuts[w]]) if plane_cuts[w] < n_planes                 else data_bytes
            hi = int(offsets[plane_cuts[w + 1]])                 if plane_cuts[w + 1] < n_planes else data_bytes
            mm[data_start + lo:data_start + hi] = buf[lo:hi]
    else:
        # out-of-core: each worker assembles and writes its range in
        # memory-bounded rounds (>= 1 plane per round)
        def fill(w: int):
            lo, hi = plane_cuts[w], plane_cuts[w + 1]
            while lo < hi:
                budget = (int(cum_bytes[lo - 1]) if lo else 0) + seg_budget
                chunk_hi = int(np.searchsorted(cum_bytes, budget,
                                               side="right"))
                chunk_hi = min(max(chunk_hi, lo + 1), hi)
                seg = build_segment(lo, chunk_hi)
                off = data_start + int(offsets[lo])
                mm[off:off + len(seg)] = seg
                if chunk_hi < hi:          # out-of-core round boundary
                    mm.flush()
                lo = chunk_hi

    if n_workers > 1:
        with ThreadPoolExecutor(n_workers) as ex:
            list(ex.map(fill, range(n_workers)))
    else:
        fill(0)
    # release the mapping without a synchronous msync: munmap leaves the
    # dirty pages in the unified page cache (immediately visible to every
    # subsequent reader) and the OS writes them back asynchronously — a
    # blocking flush of the whole cube serialized the aggregation tail
    # for ~1s per cube on this container's filesystem
    del mm
    return {"bytes": total, "nnz": int(len(val)), "n_ctx": int(len(uctx))}


class CMSReader:
    def __init__(self, path: str):
        self._mm = np.memmap(path, np.uint8, "r")
        assert bytes(self._mm[:4]) == CMS_MAGIC
        (hlen,) = struct.unpack("<I", self._mm[4:8])
        self.header = json.loads(bytes(self._mm[8:8 + hlen]))
        p0 = 8 + hlen
        (n_ctx,) = struct.unpack("<I", self._mm[p0:p0 + 4])
        idx = np.frombuffer(self._mm[p0 + 4:p0 + 4 + n_ctx * 24],
                            np.int64).reshape(-1, 3)
        self._ctx_ids = idx[:, 0]
        self._n_midxs = (idx[:, 1] >> 32).astype(np.int64)
        self._nnz = (idx[:, 1] & 0xFFFFFFFF).astype(np.int64)
        self._offsets = idx[:, 2]

    def contexts(self) -> np.ndarray:
        return self._ctx_ids

    def _plane(self, ctx: int):
        i = int(np.searchsorted(self._ctx_ids, ctx))
        if i >= len(self._ctx_ids) or self._ctx_ids[i] != ctx:
            return None
        off = int(self._offsets[i])
        nm = int(self._n_midxs[i])
        nv = int(self._nnz[i])
        midxs = np.frombuffer(self._mm[off:off + nm * 12],
                              dtype=[("m", "<u4"), ("s", "<u8")])
        off += nm * 12
        pids = np.frombuffer(self._mm[off:off + nv * 4], "<u4")
        off += nv * 4
        vals = np.frombuffer(self._mm[off:off + nv * 8], "<f8")
        return midxs, pids, vals

    def metric_values(self, ctx: int, metric: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """All (profile, value) pairs for one (ctx, metric): O(log m)."""
        plane = self._plane(ctx)
        if plane is None:
            return np.zeros(0, np.uint32), np.zeros(0, np.float64)
        midxs, pids, vals = plane
        ms = midxs["m"].astype(np.int64)
        j = int(np.searchsorted(ms[:-1], metric))
        if j >= len(ms) - 1 or ms[j] != metric:
            return np.zeros(0, np.uint32), np.zeros(0, np.float64)
        lo, hi = int(midxs["s"][j]), int(midxs["s"][j + 1])
        return pids[lo:hi], vals[lo:hi]

    def lookup(self, ctx: int, metric: int, profile: int) -> float:
        """O(log m + log p) single-value access (paper complexity claim)."""
        pids, vals = self.metric_values(ctx, metric)
        k = int(np.searchsorted(pids, profile))
        if k < len(pids) and pids[k] == profile:
            return float(vals[k])
        return 0.0

    def plane_triplets(self, ctx: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One context plane as ``(profile, metric, value)`` COO arrays,
        in stored (metric-major) order — copies, safe to keep after the
        reader goes away."""
        plane = self._plane(ctx)
        if plane is None:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.float64)
        midxs, pids, vals = plane
        starts = midxs["s"].astype(np.int64)     # last entry = sentinel nnz
        counts = starts[1:] - starts[:-1]
        mets = np.repeat(midxs["m"][:-1].astype(np.int64), counts)
        return pids.astype(np.int64), mets, np.array(vals, np.float64)


def read_cms(path: str) -> List[ProfileValues]:
    """Full CMS round-trip: reconstruct every profile's sparse values from
    the CCT-major cube (per-profile arrays in row-major (ctx, metric)
    order — the order ``aggregate`` streams them in)."""
    r = CMSReader(path)
    ctx_l, pid_l, met_l, val_l = [], [], [], []
    for ctx in r.contexts().tolist():
        pids, mets, vals = r.plane_triplets(int(ctx))
        pid_l.append(pids)
        met_l.append(mets)
        val_l.append(vals)
        ctx_l.append(np.full(len(pids), int(ctx), np.int64))
    if not ctx_l:
        return []
    ctx = np.concatenate(ctx_l)
    pid = np.concatenate(pid_l)
    met = np.concatenate(met_l)
    val = np.concatenate(val_l)
    order = np.lexsort((met, ctx, pid))
    ctx, pid, met, val = ctx[order], pid[order], met[order], val[order]
    upids, starts = np.unique(pid, return_index=True)
    bounds = np.append(starts, len(pid))
    return [ProfileValues(int(upids[i]),
                          ctx[bounds[i]:bounds[i + 1]].astype(np.uint32),
                          met[bounds[i]:bounds[i + 1]].astype(np.uint32),
                          val[bounds[i]:bounds[i + 1]])
            for i in range(len(upids))]


# =========================================================================
# PMS
# =========================================================================
def write_pms(path: str, profiles: List[ProfileValues], *,
              n_workers: int = 4) -> dict:
    """Profile-major cube: one CSR plane per profile (work split by
    profile count — the paper's PMS load-balance rule)."""
    sizes = []
    for p in profiles:
        n_ctx_rows = len(np.unique(p.ctx)) + 1
        sizes.append(n_ctx_rows * 12 + len(p.ctx) * 12)
    offsets = _exscan(sizes)
    header = {"n_profiles": len(profiles)}
    hdr = json.dumps(header).encode()
    index_bytes = len(profiles) * 24
    data_start = 8 + len(hdr) + 4 + index_bytes
    total = data_start + sum(sizes)

    with open(path, "wb") as f:
        f.truncate(total)
    mm = np.memmap(path, np.uint8, "r+")
    mm[:4] = np.frombuffer(PMS_MAGIC, np.uint8)
    mm[4:8] = np.frombuffer(struct.pack("<I", len(hdr)), np.uint8)
    mm[8:8 + len(hdr)] = np.frombuffer(hdr, np.uint8)
    p0 = 8 + len(hdr)
    mm[p0:p0 + 4] = np.frombuffer(struct.pack("<I", len(profiles)), np.uint8)
    idx = np.zeros((len(profiles), 3), np.int64)
    for i, p in enumerate(profiles):
        idx[i] = (p.profile_id, len(p.ctx), offsets[i] + data_start)
    mm[p0 + 4:p0 + 4 + index_bytes] = np.frombuffer(idx.tobytes(), np.uint8)

    def fill(i: int):
        p = profiles[i]
        order = np.lexsort((p.metric, p.ctx))
        ctx = p.ctx[order]
        met = p.metric[order]
        vals = p.values[order]
        uc, starts = np.unique(ctx, return_index=True)
        rows = np.zeros((len(uc) + 1, 1),
                        dtype=[("c", "<u4"), ("s", "<u8")])
        rows["c"][:-1, 0] = uc
        rows["s"][:-1, 0] = starts
        rows["c"][-1, 0] = 0xFFFFFFFF
        rows["s"][-1, 0] = len(ctx)
        blob = (rows.tobytes() + met.astype("<u4").tobytes()
                + vals.astype("<f8").tobytes())
        off = int(idx[i, 2])
        mm[off:off + len(blob)] = np.frombuffer(blob, np.uint8)

    if n_workers > 1:
        with ThreadPoolExecutor(n_workers) as ex:
            list(ex.map(fill, range(len(profiles))))
    else:
        for i in range(len(profiles)):
            fill(i)
    del mm     # no synchronous msync — see write_cms
    return {"bytes": total}


class PMSReader:
    def __init__(self, path: str):
        self._mm = np.memmap(path, np.uint8, "r")
        assert bytes(self._mm[:4]) == PMS_MAGIC
        (hlen,) = struct.unpack("<I", self._mm[4:8])
        self.header = json.loads(bytes(self._mm[8:8 + hlen]))
        p0 = 8 + hlen
        (n,) = struct.unpack("<I", self._mm[p0:p0 + 4])
        idx = np.frombuffer(self._mm[p0 + 4:p0 + 4 + n * 24],
                            np.int64).reshape(-1, 3)
        self._pids = idx[:, 0]
        self._nnz = idx[:, 1]
        self._offsets = idx[:, 2]

    def profile_plane(self, profile: int):
        i = int(np.searchsorted(self._pids, profile))
        if i >= len(self._pids) or self._pids[i] != profile:
            return None
        off = int(self._offsets[i])
        nv = int(self._nnz[i])
        # planes are laid out in index order, so the next plane's offset
        # (or the file end) bounds this one: row count falls out without
        # scanning for the sentinel record by record
        end = int(self._offsets[i + 1]) if i + 1 < len(self._offsets) \
            else len(self._mm)
        n_rows = (end - off - nv * 12) // 12
        raw = np.frombuffer(self._mm[off:off + n_rows * 12],
                            dtype=[("c", "<u4"), ("s", "<u8")])
        rows = list(zip(raw["c"].tolist(), raw["s"].tolist()))
        off += n_rows * 12
        mets = np.frombuffer(self._mm[off:off + nv * 4], "<u4")
        off += nv * 4
        vals = np.frombuffer(self._mm[off:off + nv * 8], "<f8")
        return rows, mets, vals

    def context_values(self, profile: int, ctx: int) -> Dict[int, float]:
        plane = self.profile_plane(profile)
        if plane is None:
            return {}
        rows, mets, vals = plane
        cs = np.array([r[0] for r in rows], np.int64)
        j = int(np.searchsorted(cs[:-1], ctx))
        if j >= len(cs) - 1 or cs[j] != ctx:
            return {}
        lo, hi = rows[j][1], rows[j + 1][1]
        return {int(m): float(v) for m, v in zip(mets[lo:hi], vals[lo:hi])}

    def profile_ids(self) -> np.ndarray:
        return self._pids

    def profile_values(self, profile: int) -> Optional[ProfileValues]:
        """One profile's full sparse values, bitwise as written: the plane
        is stored row-major in (ctx, metric), which is exactly the order
        ``aggregate`` emits, so PMS -> ``profile_values`` -> ``write_pms``
        round-trips byte-identically.  Arrays are copies (safe to keep
        while the underlying file is rewritten, e.g. an in-place
        incremental merge)."""
        plane = self.profile_plane(profile)
        if plane is None:
            return None
        rows, mets, vals = plane
        counts = np.diff([r[1] for r in rows])
        ctx = np.repeat(np.array([r[0] for r in rows[:-1]], np.int64),
                        counts)
        return ProfileValues(profile, ctx.astype(np.uint32),
                             np.array(mets, np.uint32),
                             np.array(vals, np.float64))


def read_pms(path: str) -> List[ProfileValues]:
    """Full PMS round-trip: every profile's sparse values, ascending
    profile id (the canonical order ``aggregate`` assigned)."""
    r = PMSReader(path)
    out = []
    for pid in r.profile_ids().tolist():
        pv = r.profile_values(int(pid))
        if pv is not None:
            out.append(pv)
    return out


def dense_cube_nbytes(n_profiles: int, n_ctx: int, n_metrics: int) -> int:
    """Size of the dense (profile x context x metric) cube (§8.2)."""
    return n_profiles * n_ctx * n_metrics * 8
