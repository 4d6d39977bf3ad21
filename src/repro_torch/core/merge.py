"""Incremental & sharded database merge (continuous profiling).

The paper's ``hpcprof-mpi`` (§6.1) aggregates a whole measurement
directory in one shot; its exascale follow-up ("Preparing for Performance
Analysis at Exascale", Anderson et al.) gets to scale with a sparse
format plus *composable* parallel reduction.  This module is that
composition step: ``merge_databases`` folds N independently-built
databases (shards of a measurement directory, or successive epochs of a
long-running job) into one database whose bytes are **identical** to a
one-shot ``aggregate()`` over the union of their profiles.

Why that byte-identity is possible (the canonical contract,
docs/aggregation.md):

- context ids are canonical (BFS, children in frame-key order), so the
  union tree renumbers the same no matter how profiles were sharded, and
  the *relative* order of any node's children — the floating-point fold
  order of the inclusive sweep — is the same in a shard tree as in the
  union tree.  Per-profile inclusive values therefore come out bitwise
  identical in both, differing only by the ctx renumbering this module
  applies;
- profile ids are canonical (identity order + content digest), so the
  cross-profile accumulator fold and the CMS/PMS plane order do not
  depend on which shard a profile arrived in;
- ``trace.db`` lines merge by canonical identity order and re-merge
  idempotently (repro.traceview.tracedb), so shard trace databases
  re-fold after the same ctx remapping.

The merge therefore never re-propagates metrics: it re-reads each
shard's per-profile inclusive values from the PMS cube (``read_pms``),
grafts the shard trees into one union tree (``GlobalTree.merge_tree``
replayed from the serialized arrays), remaps ctx ids through the
composed ``shard -> union -> canonical`` map, and hands everything to
the same ``write_database`` writer ``aggregate()`` uses.

Inputs need not live on disk: the parallel shard driver
(``repro.core.pipeline.driver``) hands in-memory ``ShardResult``
objects (phases 1-4 over a shard, no intermediate database), and the
identical fold runs — that is what makes ``aggregate(..., workers=N)``
byte-identical to serial by construction and faster in wall-clock
(benchmarks/bench_pipeline.py measures it; bench_merge measures the
on-disk variant).

**Retention** (``repro.core.retention``): a ``RetentionPolicy`` filters
the unioned profile multiset before the write — retiring epochs,
deduplicating, capping profile count — and the tree is rebuilt from the
survivors' recorded context coverage, so the retained database is
byte-identical to re-aggregating the surviving profiles from scratch.

CLI::

    python -m repro.core.merge SHARD_DB... -o OUT_DB [--retain SPEC]
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cct import Frame
from repro_torch.core.pipeline.contracts import ShardResult
from repro_torch.core.pipeline.database import (Database, ancestor_closure,
                                          load_coverage, write_database)
from repro_torch.core.pipeline.unify import (GlobalTree, apply_order,
                                       canonical_order)
from repro_torch.core.retention import RetentionPolicy, RetentionReport, \
    apply_retention, parse_retention
from repro_torch.core.sparse import ProfileValues, read_pms
from repro_torch.core.trace import TraceData
from repro_torch.ft import inject

# Labeled crash points on the commit path (ISSUE 6): the fleet crash
# matrix kills the merging process at each of these and asserts the
# intact-or-previous guarantee plus journal replay (docs/fleet.md).
FP_COMMIT_PRE_SWAP = "merge.commit.pre_swap"
FP_COMMIT_MID_SWAP = "merge.commit.mid_swap"
FP_COMMIT_POST_SWAP = "merge.commit.post_swap"
inject.register_points(FP_COMMIT_PRE_SWAP, FP_COMMIT_MID_SWAP,
                       FP_COMMIT_POST_SWAP)

PRE_MERGE_SUFFIX = ".pre-merge"
STAGING_PREFIX = ".merge_staging_"


# --------------------------------------------------------------------------
# Shard loading
# --------------------------------------------------------------------------
class LoadedShard:
    """One input database, fully materialized (arrays are copies, so an
    in-place merge may replace the files afterwards)."""

    def __init__(self, out_dir: str, *, load_traces: bool = True):
        self.out_dir = out_dir
        db = Database.load(out_dir)
        self.frames: List[Frame] = db.frames
        self.parents = np.asarray(db.parents, np.int64)
        self.metrics: List[str] = list(db.metrics)
        self.identities: Dict[int, dict] = db.profile_ids
        pms = db.pms_path()
        self.pvals: List[ProfileValues] = \
            read_pms(pms) if os.path.exists(pms) else []
        if set(int(p.profile_id) for p in self.pvals) != \
                set(self.identities):
            raise ValueError(
                f"{out_dir}: PMS profile planes do not match meta.json "
                "profiles; refusing to merge a torn database")
        # per-profile ctx coverage; databases written before coverage was
        # recorded fall back to the ancestor closure of the nonzero ctxs
        self.coverage: Dict[int, np.ndarray] = load_coverage(out_dir) or {
            int(pv.profile_id): ancestor_closure(
                pv.ctx.astype(np.int64), self.parents)
            for pv in self.pvals}
        self.trace_lines: List[TraceData] = []
        tpath = db.trace_db_path()
        if load_traces and os.path.exists(tpath):
            from repro_torch.traceview.tracedb import TraceDB
            self.trace_lines = [
                TraceData(td.identity, np.array(td.starts),
                          np.array(td.ends), np.array(td.ctx))
                for td in TraceDB(tpath).line_views()]


ShardInput = Union[str, ShardResult, LoadedShard]


# --------------------------------------------------------------------------
# The merge driver
# --------------------------------------------------------------------------
def merge_databases(in_dirs: Sequence[ShardInput], out_dir: str, *,
                    n_workers: int = 4,
                    trace_db: bool = True,
                    retention: Optional[RetentionPolicy] = None,
                    retention_report: Optional[RetentionReport] = None,
                    remaps_out: Optional[list] = None,
                    extra_files: Optional[Dict[str, bytes]] = None
                    ) -> Database:
    """Fold N databases into one, byte-identical to a one-shot
    ``aggregate()`` over the union of their profiles.

    The fold is associative and input-order-invariant (canonicalization
    happens after the union), so any sharding of a measurement directory
    — and any merge tree over the shards — lands on the same bytes
    (property-tested in tests/test_merge_properties.py).  Profiles are
    concatenated as a multiset; identities are not deduplicated (unless
    a ``retention`` policy asks for it).

    Inputs are database directories or in-memory ``ShardResult`` objects
    (the parallel shard driver's contract).  With ``retention``, the
    unioned profile multiset is filtered and the tree restricted to the
    survivors' coverage before writing — byte-identical to re-aggregating
    the survivors (``repro.core.retention``); a ``retention_report``
    instance, when given, is filled in place.  ``remaps_out``, when a
    list, receives one ``shard ctx id -> output ctx id`` array per input
    (unsupported together with ``retention``).

    The output is staged in a sibling temp dir and committed with a
    directory swap, so ``out_dir`` may be one of ``in_dirs`` (in-place
    epoch extension — every input is fully materialized before anything
    is written) and a crash mid-merge never leaves a half-written mix of
    old and new files: the worst case is the old database parked at
    ``out_dir + ".pre-merge"`` (cleaned up on the next merge, or by
    ``recover_interrupted_swap``).  A merged directory indexes traces
    solely via ``trace.db`` — the per-trace ``.rtrc`` intermediates a
    one-shot ``aggregate()`` leaves are not reproduced (and any stale
    ones in a replaced ``out_dir`` go away with it).

    ``extra_files`` (name -> bytes) are written into the staged output
    *before* the swap, so they commit atomically with the database —
    this is how the fleet daemon's ingest journal rides the fold
    (``repro.fleet.journal``): there is no crash schedule that applies
    shards without journaling them, or vice versa.
    """
    if not in_dirs:
        raise ValueError("merge_databases: need at least one input "
                         "database")
    if retention is not None and remaps_out is not None:
        raise ValueError("merge_databases: remaps_out is not supported "
                         "together with retention (retired contexts have "
                         "no output id)")
    t0 = time.monotonic()
    shards = [sh if isinstance(sh, (ShardResult, LoadedShard))
              else LoadedShard(sh, load_traces=trace_db)
              for sh in in_dirs]

    metrics: List[str] = []
    for sh in shards:
        if not sh.identities:
            continue            # empty databases carry no metric columns
        if not metrics:
            metrics = sh.metrics
        elif sh.metrics != metrics:
            raise ValueError(
                f"{sh.out_dir}: metric columns {sh.metrics[:3]}... differ "
                f"from {metrics[:3]}...; databases must be measured with "
                "identical metric registries to merge")

    # union tree: graft every shard tree (shard inputs duck-type the
    # frames/parents pair merge_tree consumes — the same reduction step
    # hpcprof's rank fold uses, replayed from the serialized arrays),
    # then canonicalize — the result is a pure function of the union
    # node set, not of shard order
    union = GlobalTree()
    mappings = [union.merge_tree(sh) for sh in shards]
    new_id = canonical_order(union.frames, union.parents)
    frames_c, parents_c = apply_order(union.frames, union.parents, new_id)
    remaps = [new_id[m] for m in mappings]

    # per-profile values: remap ctx (and coverage) through shard ->
    # canonical-union ids.  write_database re-sorts rows and re-sorts
    # profiles canonically, so shard order is irrelevant from here on.
    entries: List[Tuple[dict, np.ndarray, np.ndarray, np.ndarray,
                        np.ndarray]] = []
    for sh, remap in zip(shards, remaps):
        for pv in sh.pvals:
            pid = int(pv.profile_id)
            cover = sh.coverage.get(pid)
            if cover is None:
                cover = ancestor_closure(pv.ctx.astype(np.int64),
                                         np.asarray(sh.parents, np.int64))
            entries.append(
                (sh.identities[pid], remap[pv.ctx.astype(np.int64)],
                 pv.metric.astype(np.int64), pv.values,
                 np.sort(remap[np.asarray(cover, np.int64)])))

    # trace.db: remap each shard's lines and re-merge (idempotent path)
    trace_lines: List[TraceData] = []
    for sh, remap in zip(shards, remaps):
        for td in sh.trace_lines:
            if td.identity.get("ctx_unmapped"):
                # aggregate() flagged this line as carrying raw
                # (non-database) ctx ids; copy it verbatim — exactly what
                # a one-shot aggregation over the union would emit
                trace_lines.append(td)
                continue
            valid = (td.ctx >= 0) & (td.ctx < len(remap))
            if not bool(valid.all()):
                warnings.warn(
                    f"{sh.out_dir}/trace.db: {int((~valid).sum())} event(s)"
                    " reference ctx ids outside the shard tree; attributing"
                    " them to the root context", RuntimeWarning)
            ctx = np.where(valid, remap[np.clip(td.ctx, 0, len(remap) - 1)],
                           0)
            trace_lines.append(TraceData(td.identity, td.starts, td.ends,
                                         ctx))

    if retention is not None and not retention.is_noop:
        entries, trace_lines, report = \
            apply_retention(entries, trace_lines, retention)
        if retention_report is not None:
            retention_report.__dict__.update(report.__dict__)
        frames_c, parents_c, entries, trace_lines = _restrict_tree(
            frames_c, parents_c, entries, trace_lines)

    # stage the complete output in a sibling temp dir, then commit with a
    # directory swap (two renames).  This is what makes in-place epoch
    # extension safe — a crash never leaves out_dir as a half-written mix
    # of old and new files — and it sweeps away anything stale a replaced
    # out_dir held (old trace.db, converted .rtrc with dead ctx ids).
    import shutil
    import tempfile
    out_abs = os.path.abspath(out_dir)
    parent = os.path.dirname(out_abs) or "."
    os.makedirs(parent, exist_ok=True)
    work_dir = tempfile.mkdtemp(prefix=STAGING_PREFIX, dir=parent)

    db = write_database(work_dir, frames_c, parents_c, metrics,
                        entries, n_workers=max(1, n_workers), t0=t0,
                        timing_base={"merged_dbs": len(shards)})
    if trace_lines and trace_db:
        from repro_torch.traceview.tracedb import build_db
        build_db(trace_lines, os.path.join(work_dir, "trace.db"))
    for name, data in (extra_files or {}).items():
        with open(os.path.join(work_dir, name), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    inject.fault_point(FP_COMMIT_PRE_SWAP)
    backup = out_abs + PRE_MERGE_SUFFIX
    if os.path.lexists(backup):       # leftover of a crashed prior merge
        shutil.rmtree(backup, ignore_errors=True)
    if os.path.lexists(out_abs):
        # only ever replace a database directory (or an empty one) — a
        # typo'd -o must not vaporize unrelated files
        if not os.path.isdir(out_abs) or (
                os.listdir(out_abs)
                and not os.path.exists(os.path.join(out_abs, "meta.json"))):
            shutil.rmtree(work_dir, ignore_errors=True)
            raise ValueError(
                f"{out_dir}: exists and is not a database directory "
                "(no meta.json); refusing to replace it")
        os.rename(out_abs, backup)
        inject.fault_point(FP_COMMIT_MID_SWAP)
        os.rename(work_dir, out_abs)
        inject.fault_point(FP_COMMIT_POST_SWAP)
        shutil.rmtree(backup, ignore_errors=True)
    else:
        os.rename(work_dir, out_abs)
        inject.fault_point(FP_COMMIT_POST_SWAP)
    if remaps_out is not None:
        remaps_out.extend(remaps)
    return Database(out_dir, db.frames, db.parents, db.metrics,
                    db.profile_ids, db.stats)


def recover_interrupted_swap(out_dir: str) -> Optional[str]:
    """Repair the directory state a merge killed mid-commit leaves
    behind — the restart half of the intact-or-previous guarantee.

    Returns what was done (``"restored"`` — the previous database was
    parked at ``<out>.pre-merge`` with nothing at ``out_dir``, so it is
    renamed back; ``"cleaned"`` — the swap completed but the backup's
    removal didn't, so the stale backup is dropped) or ``None`` when the
    state is already consistent.  Always sweeps dead staging
    directories.  The fleet daemon runs this before every poll
    (``repro.fleet.daemon``)."""
    import shutil
    out_abs = os.path.abspath(out_dir)
    parent = os.path.dirname(out_abs) or "."
    if os.path.isdir(parent):
        for fn in os.listdir(parent):
            if fn.startswith(STAGING_PREFIX):
                shutil.rmtree(os.path.join(parent, fn),
                              ignore_errors=True)
    backup = out_abs + PRE_MERGE_SUFFIX
    if not os.path.lexists(backup):
        return None
    if not os.path.lexists(out_abs):
        os.rename(backup, out_abs)      # crash between the two renames
        return "restored"
    shutil.rmtree(backup, ignore_errors=True)   # crash before cleanup
    return "cleaned"


def _restrict_tree(frames: List[Frame], parents: np.ndarray, entries: list,
                   trace_lines: List[TraceData]):
    """Drop every context no surviving profile covers (and no surviving
    mapped trace line references), then renumber canonically.

    Coverage sets are parent-closed by construction (every profile path
    node maps; expansion intermediates are ancestors of mapped nodes),
    so the kept set is ancestor-closed and the compressed numbering of
    an already-canonical tree stays canonical — the restricted tree is
    exactly what re-aggregating the survivors builds (``canonical_order``
    is re-run as cheap insurance).
    """
    n = len(frames)
    referenced = [np.zeros(0, np.int64)]
    for e in entries:
        referenced.append(e[4])
    for td in trace_lines:
        if not td.identity.get("ctx_unmapped"):
            referenced.append(np.asarray(td.ctx, np.int64))
    keep_ids = ancestor_closure(np.concatenate(referenced),
                                np.asarray(parents, np.int64))
    sub = np.full(n, -1, np.int64)
    sub[keep_ids] = np.arange(len(keep_ids))
    frames_r = [frames[int(i)] for i in keep_ids]
    parents_r = np.where(np.asarray(parents, np.int64)[keep_ids] >= 0,
                         sub[np.asarray(parents, np.int64)[keep_ids]], -1)
    new2 = canonical_order(frames_r, parents_r)
    frames_r, parents_r = apply_order(frames_r, parents_r, new2)
    conv = new2[sub]          # old id -> restricted canonical id (kept only)
    entries = [(ident, conv[ctx], met, val, np.sort(conv[cover]))
               for ident, ctx, met, val, cover in entries]
    out_lines = []
    for td in trace_lines:
        if td.identity.get("ctx_unmapped"):
            out_lines.append(td)
        else:
            out_lines.append(TraceData(td.identity, td.starts, td.ends,
                                       conv[np.asarray(td.ctx, np.int64)]))
    return frames_r, parents_r, entries, out_lines


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def summarize(db: Database, in_dirs: Sequence[str]) -> str:
    """Deterministic post-merge report (golden-tested): counts only, no
    timings or absolute paths."""
    nnz = sum(len(pv.values) for pv in read_pms(db.pms_path()))
    lines = [
        f"MERGE  {len(in_dirs)} database(s) -> "
        f"{os.path.basename(os.path.normpath(db.out_dir))}",
        f"  inputs:   "
        + " ".join(sorted(os.path.basename(os.path.normpath(d))
                          for d in in_dirs)),
        f"  profiles: {len(db.profile_ids)}",
        f"  contexts: {len(db.frames)}",
        f"  metrics:  {len(db.metrics)}",
        f"  nnz:      {nnz}",
    ]
    tpath = db.trace_db_path()
    if os.path.exists(tpath):
        from repro_torch.traceview.tracedb import TraceDB
        tdb = TraceDB(tpath)
        lines.append(f"  trace.db: {len(tdb)} line(s), "
                     f"{tdb.n_events} event(s)")
    else:
        lines.append("  trace.db: (none)")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.core.merge",
        description="Merge databases produced by aggregate() into one, "
                    "byte-identical to a one-shot aggregation over the "
                    "union of their profiles.")
    ap.add_argument("inputs", nargs="+", help="input database directories")
    ap.add_argument("-o", "--out", required=True,
                    help="output database directory")
    ap.add_argument("--workers", type=int, default=4,
                    help="writer worker threads (default 4)")
    ap.add_argument("--retain", default=None, metavar="SPEC",
                    help="retention policy, e.g. 'last=2,max=64,dedup' "
                         "(repro.core.retention)")
    ap.add_argument("--no-trace-db", action="store_true",
                    help="skip merging the shards' trace.db files (any "
                         "pre-existing OUT/trace.db is removed — its ctx "
                         "ids would be stale against the merged tree)")
    args = ap.parse_args(argv)
    retention = parse_retention(args.retain) if args.retain else None
    report = RetentionReport() if retention else None
    db = merge_databases(args.inputs, args.out, n_workers=args.workers,
                         trace_db=not args.no_trace_db,
                         retention=retention, retention_report=report)
    print(summarize(db, args.inputs))
    if report is not None:
        print(report.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
