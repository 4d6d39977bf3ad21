"""The on-disk database: reader (``Database``) and the single shared
writer (``write_database``) behind both ``aggregate()`` and
``repro.core.merge.merge_databases``.

Canonical-database contract (docs/aggregation.md): every output byte —
tree, stats, CMS/PMS cubes, coverage — is a pure function of the
*profile set*.  Context ids are canonical (``pipeline.unify``); profile
ids are assigned here in canonical identity order (``profile_sort_key``).

Files in a database directory::

    meta.json      tree, metrics, profile identities, cube info, timing
    stats.npz      sum/min/mean/max/std/cov/count per (ctx, metric)
    metrics.cms    CCT-major sparse cube      (repro.core.sparse)
    metrics.pms    profile-major sparse cube  (repro.core.sparse)
    coverage.npz   per-profile ctx-id coverage sets (retention input)
    trace.db       merged traces (repro.traceview), when traces were given
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cct import Frame, tree_depths
from repro_torch.core.pipeline.contracts import ProfileEntry
from repro_torch.core.sparse import ProfileValues, write_cms, write_pms

STATS = ("sum", "min", "mean", "max", "std", "cov")


def _ident_int(identity: dict, *keys) -> int:
    for k in keys:
        v = identity.get(k)
        if v is not None:
            try:
                return int(v)
            except (TypeError, ValueError):
                return 0
    return 0


def profile_sort_key(identity: dict, ctx: np.ndarray, met: np.ndarray,
                     val: np.ndarray) -> tuple:
    """Canonical profile order: host, rank, CPU threads before GPU
    streams, thread/stream index (the trace.db line order), then the full
    identity JSON, then a digest of the value triplets as a content
    tie-break — a pure function of the profile, never of input order."""
    digest = hashlib.sha256(
        np.ascontiguousarray(ctx.astype("<u4")).tobytes()
        + np.ascontiguousarray(met.astype("<u4")).tobytes()
        + np.ascontiguousarray(val.astype("<f8")).tobytes()).hexdigest()
    return (str(identity.get("host", "")), _ident_int(identity, "rank"),
            0 if identity.get("type", "cpu") == "cpu" else 1,
            _ident_int(identity, "thread", "stream"),
            json.dumps(identity, sort_keys=True), digest)


def ancestor_closure(ids: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """Sorted unique ``ids`` plus all their ancestors (and the root) —
    the fallback coverage for callers that hand ``write_database`` bare
    4-tuples, and the tree-restriction primitive retention uses."""
    parents = np.asarray(parents, np.int64)
    keep = np.zeros(len(parents), bool)
    keep[0] = True
    keep[np.asarray(ids, np.int64)] = True
    frontier = keep.copy()
    while frontier.any():
        up = parents[np.nonzero(frontier)[0]]
        up = up[up >= 0]
        frontier = np.zeros(len(parents), bool)
        frontier[up[~keep[up]]] = True
        keep |= frontier
    return np.nonzero(keep)[0].astype(np.int64)


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Database:
    out_dir: str
    frames: List[Frame]
    parents: np.ndarray
    metrics: List[str]
    profile_ids: Dict[int, dict]            # profile id -> identity
    stats: Dict[str, np.ndarray]            # stat -> (n_ctx, n_metrics)
    inclusive: bool = True
    # CSR children index, built lazily on first children_of() call
    _child_order: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False)
    _child_parents: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False)
    _depths: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False)

    @classmethod
    def load(cls, out_dir: str) -> "Database":
        with open(os.path.join(out_dir, "meta.json")) as f:
            meta = json.load(f)
        frames = [Frame(*f) for f in meta["frames"]]
        data = np.load(os.path.join(out_dir, "stats.npz"))
        stats = {k: data[k] for k in data.files}
        return cls(out_dir, frames, np.asarray(meta["parents"]),
                   meta["metrics"],
                   {int(k): v for k, v in meta["profiles"].items()}, stats)

    def metric_id(self, name: str) -> int:
        return self.metrics.index(name)

    def children_of(self, gid: int) -> List[int]:
        """Children of a context, via a precomputed CSR index (a stable
        argsort of the parent array) instead of an O(n) scan per call."""
        if self._child_order is None:
            parents = np.asarray(self.parents, np.int64)
            order = np.argsort(parents, kind="stable")
            # publish _child_parents first: a concurrent caller passing the
            # None-check above must find both arrays populated
            self._child_parents = parents[order]
            self._child_order = order
        lo, hi = np.searchsorted(self._child_parents, [gid, gid + 1])
        return [int(i) for i in self._child_order[lo:hi]]

    def depths(self) -> np.ndarray:
        """Per-context depth (root = 0), cached — the traceview raster and
        interval stats project contexts through this."""
        if self._depths is None:
            self._depths = tree_depths(self.parents)
        return self._depths

    def coverage(self) -> Optional[Dict[int, np.ndarray]]:
        """Per-profile ctx-coverage sets (``coverage.npz``), or ``None``
        for databases written before coverage was recorded."""
        return load_coverage(self.out_dir)

    def trace_db_path(self) -> str:
        return os.path.join(self.out_dir, "trace.db")

    def cms_path(self) -> str:
        return os.path.join(self.out_dir, "metrics.cms")

    def pms_path(self) -> str:
        return os.path.join(self.out_dir, "metrics.pms")

    def coverage_path(self) -> str:
        return os.path.join(self.out_dir, "coverage.npz")


def load_coverage(out_dir: str) -> Optional[Dict[int, np.ndarray]]:
    path = os.path.join(out_dir, "coverage.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    ids, offsets = data["ids"], data["offsets"]
    return {i: ids[offsets[i]:offsets[i + 1]]
            for i in range(len(offsets) - 1)}


# --------------------------------------------------------------------------
# Writer (shared with repro.core.merge)
# --------------------------------------------------------------------------
def write_database(out_dir: str, frames: List[Frame], parents: np.ndarray,
                   metrics: List[str],
                   profiles: Sequence,
                   *, n_workers: int, t0: float,
                   timing_base: Optional[dict] = None) -> Database:
    """Fold per-profile inclusive triplets into the on-disk database.

    ``profiles`` is a sequence of ``ProfileEntry`` (or bare
    ``(identity, ctx, metric, value[, coverage])`` tuples) against
    canonical context ids, in *any* order: profiles are sorted into
    canonical order here (``profile_sort_key``), so stats accumulation,
    the CMS/PMS cubes, coverage, and ``meta.json`` come out
    byte-identical for any arrival order — the single writer behind both
    ``aggregate()`` and ``merge_databases()``.
    """
    os.makedirs(out_dir, exist_ok=True)
    n_ctx = len(frames)
    n_metrics = len(metrics)
    prepped = []
    for item in profiles:
        ident, ctx, met, val, *rest = (
            item.astuple() if isinstance(item, ProfileEntry) else item)
        ctx = np.asarray(ctx, np.int64)
        met = np.asarray(met, np.int64)
        val = np.asarray(val, np.float64)
        o = np.lexsort((met, ctx))          # row-major, defensive re-sort
        ctx, met, val = ctx[o], met[o], val[o]
        cover = (np.asarray(rest[0], np.int64) if rest
                 else ancestor_closure(ctx, parents))
        prepped.append((profile_sort_key(ident, ctx, met, val),
                        ident, ctx, met, val, cover))
    prepped.sort(key=lambda it: it[0])

    identities: Dict[int, dict] = {}
    pvals: List[ProfileValues] = []
    covers: List[np.ndarray] = []
    acc_sum = np.zeros((n_ctx, n_metrics))
    acc_min = np.full((n_ctx, n_metrics), np.inf)
    acc_max = np.full((n_ctx, n_metrics), -np.inf)
    acc_sumsq = np.zeros((n_ctx, n_metrics))
    acc_count = np.zeros((n_ctx, n_metrics))
    for pidx, (_, ident, ctx, met, val, cover) in enumerate(prepped):
        identities[pidx] = ident
        pvals.append(ProfileValues(pidx, ctx.astype(np.uint32),
                                   met.astype(np.uint32), val))
        covers.append(cover)
        idx = (ctx, met)
        acc_sum[idx] += val           # (ctx, metric) pairs unique per profile
        np.minimum.at(acc_min, idx, val)
        np.maximum.at(acc_max, idx, val)
        acc_sumsq[idx] += val ** 2
        acc_count[idx] += 1

    count = np.maximum(acc_count, 1)
    mean = acc_sum / count
    var = np.maximum(acc_sumsq / count - mean ** 2, 0.0)
    std = np.sqrt(var)
    stats = {
        "sum": acc_sum,
        "min": np.where(np.isfinite(acc_min), acc_min, 0.0),
        "mean": mean,
        "max": np.where(np.isfinite(acc_max), acc_max, 0.0),
        "std": std,
        "cov": np.where(mean != 0, std / np.maximum(np.abs(mean), 1e-30),
                        0.0),
        "count": acc_count,
    }

    cms_info = write_cms(os.path.join(out_dir, "metrics.cms"), pvals,
                         n_workers=n_workers)
    pms_info = write_pms(os.path.join(out_dir, "metrics.pms"), pvals,
                         n_workers=n_workers)
    cov_ids = (np.concatenate(covers) if covers else np.zeros(0, np.int64))
    cov_off = np.zeros(len(covers) + 1, np.int64)
    np.cumsum([len(c) for c in covers], out=cov_off[1:])
    np.savez(os.path.join(out_dir, "coverage.npz"),
             ids=cov_ids.astype(np.int64), offsets=cov_off)

    meta = {
        "frames": [[f.kind, f.name, f.module, f.line] for f in frames],
        "parents": [int(p) for p in parents],
        "metrics": metrics,
        "profiles": {str(i): ident for i, ident in identities.items()},
        "cms": cms_info, "pms": pms_info,
        "timing": {**(timing_base or {}),
                   "total_s": time.monotonic() - t0},
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    np.savez(os.path.join(out_dir, "stats.npz"), **stats)
    return Database(out_dir, frames, np.asarray(parents), metrics,
                    identities, stats)
