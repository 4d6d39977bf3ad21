"""Streaming aggregation — the ``hpcprof`` / ``hpcprof-mpi`` analogue
(paper §6.1): the public façade over the staged pipeline.

The five paper phases each live in their own module under
``repro.core.pipeline`` (acquire -> unify -> expand -> stats ->
traceconv, behind dataclass stage contracts), the database
reader/writer in ``pipeline.database``, and the pluggable serial /
thread / process shard driver in ``pipeline.driver`` —
``docs/pipeline.md`` documents the architecture, ``docs/aggregation.md``
the canonical-database contract every stage upholds: database bytes are
a pure function of the profile set, which is what makes shard
aggregation composable (``repro.core.merge``), the parallel driver
byte-identical to serial by construction, and retention policies
(``repro.core.retention``) exact.

This module re-exports every name the pre-decomposition monolith
offered, so existing imports keep working unchanged.

CLI::

    python -m repro.core.aggregate MEASURE_DIR -o DB [--workers N]
        [--driver serial|thread|process] [--base DB] [--retain SPEC]
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

# Re-exported public surface (the façade contract: no import breaks).
from repro_torch.core.pipeline.acquire import Acquisition, acquire  # noqa: F401
from repro_torch.core.pipeline.contracts import (ProfileEntry,  # noqa: F401
                                           ShardResult, UnifiedProfile,
                                           Unification)
from repro_torch.core.pipeline.database import (STATS, Database,  # noqa: F401
                                          ancestor_closure,
                                          profile_sort_key, write_database)
from repro_torch.core.pipeline.database import write_database as _write_database  # noqa: F401,E501
from repro_torch.core.pipeline.driver import (DRIVERS, ENV_DRIVER,  # noqa: F401
                                        ENV_WORKERS, resolve_driver)
from repro_torch.core.pipeline.expand import make_expander  # noqa: F401
from repro_torch.core.pipeline.stats import (_group_sum_ordered,  # noqa: F401
                                       _profile_inclusive_sparse,
                                       generate_stats)
from repro_torch.core.pipeline.traceconv import convert_traces  # noqa: F401
from repro_torch.core.pipeline.unify import (GlobalTree,  # noqa: F401
                                       apply_order, canonical_order, unify)
from repro_torch.core.structure import HloModule


def aggregate(profile_paths: Sequence[str], out_dir: str, *,
              n_ranks: int = 4, n_threads: int = 4,
              structures: Optional[Dict[str, HloModule]] = None,
              trace_paths: Sequence[str] = (),
              trace_db: bool = True,
              trace_pyramid: bool = False,
              base_db: "Optional[str | Database]" = None,
              timing: Optional[dict] = None,
              workers: Optional[int] = None,
              driver: Optional[str] = None,
              retention=None) -> Database:
    """Aggregate ``profile_paths`` into the database at ``out_dir``.

    - ``workers`` / ``driver`` select the shard driver
      (``pipeline.driver``): ``workers=4`` runs four shard aggregations
      on a ``ProcessPoolExecutor`` and folds them through
      ``merge_databases`` — byte-identical to the serial one-shot by
      construction, faster once shard work dominates the fold.
      Defaults honour ``$REPRO_AGG_DRIVER`` / ``$REPRO_AGG_WORKERS``.
    - ``base_db`` (a database directory or ``Database``) switches to
      incremental mode: the new profiles extend the base and the output
      is byte-identical to a one-shot run over the union — see
      ``_aggregate_incremental`` and ``repro.core.merge``.
    - ``retention`` (a ``repro.core.retention.RetentionPolicy``) is
      applied at merge time: epochs beyond the window are retired,
      duplicates compacted, and the result is byte-identical to
      re-aggregating the surviving profile set.
    - ``trace_pyramid=True`` also builds the ``trace.pyr`` tile pyramid
      next to ``trace.db`` during phase 5 (repro.traceview.pyramid) —
      the opt-in alternative to the lazy ``ensure_pyramid`` cache.
    """
    if base_db is not None:
        db = _aggregate_incremental(
            profile_paths, out_dir, base_db, n_ranks=n_ranks,
            n_threads=n_threads, structures=structures,
            trace_paths=trace_paths, trace_db=trace_db, timing=timing,
            workers=workers, driver=driver, retention=retention)
    elif retention is not None and not retention.is_noop:
        db = _aggregate_retained(
            profile_paths, out_dir, retention, n_ranks=n_ranks,
            n_threads=n_threads, structures=structures,
            trace_paths=trace_paths, trace_db=trace_db, timing=timing,
            workers=workers, driver=driver)
    else:
        from repro_torch.core.pipeline import driver as _driver
        return _driver.run(profile_paths, out_dir, n_ranks=n_ranks,
                           n_threads=n_threads, structures=structures,
                           trace_paths=trace_paths, trace_db=trace_db,
                           trace_pyramid=trace_pyramid, timing=timing,
                           workers=workers, driver=driver)
    # merged paths (incremental/retained) rebuild trace.db during the
    # fold; refresh the pyramid from the final bytes
    if trace_pyramid and os.path.exists(db.trace_db_path()):
        from repro_torch.traceview.pyramid import ensure_pyramid
        ensure_pyramid(db).close()
    return db


def _aggregate_incremental(profile_paths: Sequence[str], out_dir: str,
                           base_db, *, n_ranks: int, n_threads: int,
                           structures, trace_paths: Sequence[str],
                           trace_db: bool, timing: Optional[dict],
                           workers=None, driver=None,
                           retention=None) -> Database:
    """``aggregate(..., base_db=...)``: extend an existing database with
    new profiles.  The new profiles are aggregated into a scratch
    database, then folded with the base through ``merge_databases`` — the
    result is byte-identical to a one-shot ``aggregate()`` over the union
    of the base's profiles and the new ones (the canonical contract).
    ``out_dir`` may equal ``base_db`` (in-place epoch extension); a
    ``retention`` policy retires old epochs in the same fold."""
    import json
    import shutil
    import tempfile
    from repro_torch.core.merge import merge_databases

    base_dir = base_db.out_dir if isinstance(base_db, Database) else base_db
    t0 = time.monotonic()
    scratch = tempfile.mkdtemp(prefix="repro_increment_")
    try:
        aggregate(profile_paths, scratch, n_ranks=n_ranks,
                  n_threads=n_threads, structures=structures,
                  trace_paths=trace_paths, trace_db=trace_db,
                  workers=workers, driver=driver)
        db = merge_databases([base_dir, scratch], out_dir,
                             n_workers=n_ranks * n_threads,
                             trace_db=trace_db, retention=retention)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if timing is not None:
        with open(os.path.join(out_dir, "meta.json")) as f:
            timing.update(json.load(f)["timing"])
        timing["incremental_s"] = time.monotonic() - t0
    return db


def _aggregate_retained(profile_paths: Sequence[str], out_dir: str,
                        retention, *, n_ranks: int, n_threads: int,
                        structures, trace_paths: Sequence[str],
                        trace_db: bool, timing: Optional[dict],
                        workers, driver) -> Database:
    """One-shot aggregation with a retention policy: aggregate to a
    scratch database (under the selected driver), then apply the policy
    in a single self-merge — the same fold the incremental path uses.
    Like every merged directory, the output indexes traces solely via
    ``trace.db`` (no per-trace ``.rtrc`` intermediates)."""
    import shutil
    import tempfile
    from repro_torch.core.merge import merge_databases

    scratch = tempfile.mkdtemp(prefix="repro_retain_")
    try:
        aggregate(profile_paths, scratch, n_ranks=n_ranks,
                  n_threads=n_threads, structures=structures,
                  trace_paths=trace_paths, trace_db=trace_db,
                  timing=timing, workers=workers, driver=driver)
        return merge_databases([scratch], out_dir,
                               n_workers=n_ranks * n_threads,
                               trace_db=trace_db, retention=retention)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    import sys
    from repro_torch.core.pipeline.cli import main
    sys.exit(main())
