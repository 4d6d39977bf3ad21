"""The pluggable shard driver: serial / thread / process execution of
the aggregation pipeline (docs/pipeline.md).

The serial path runs the five stages inline — this *is* the classic
one-shot ``aggregate()``.  The parallel paths round-robin the profiles
into shards, run phases 1-4 per shard on an executor —
``ProcessPoolExecutor`` escapes the GIL for the Python-heavy
unification loop — fold the in-memory ``ShardResult``s through
``repro.core.merge.merge_databases``, and convert traces in-parent
against the final tree (composed ``remaps_out`` gmaps).
Because shard aggregation is canonical (pipeline.unify), the fold is
**byte-identical to the serial one-shot by construction** (the merge
contract, docs/aggregation.md; property-tested in
tests/test_merge_properties.py, benchmarked in
benchmarks/bench_pipeline.py).

Driver selection: the ``driver=`` / ``workers=`` arguments of
``aggregate()``, else the ``REPRO_AGG_DRIVER`` / ``REPRO_AGG_WORKERS``
environment (CI runs the tier-1 suite once with
``REPRO_AGG_DRIVER=process``), else serial.
"""
from __future__ import annotations

import os
import pickle
import time
import warnings
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline.acquire import acquire
from repro_torch.core.pipeline.contracts import ShardResult
from repro_torch.core.pipeline.database import Database, write_database
from repro_torch.core.pipeline.expand import make_expander
from repro_torch.core.pipeline.stats import generate_stats
from repro_torch.core.pipeline.traceconv import build_trace_db, convert_traces
from repro_torch.core.pipeline.unify import unify
from repro_torch.core.sparse import ProfileValues

ENV_DRIVER = "REPRO_AGG_DRIVER"
ENV_WORKERS = "REPRO_AGG_WORKERS"
DRIVERS = ("serial", "thread", "process")

# one cached process pool (keyed by its worker count): startup is paid
# once per interpreter, not once per aggregate() call, and requesting a
# different worker count retires the old pool so idle workers never
# accumulate across counts
_PROCESS_POOLS: Dict[int, ProcessPoolExecutor] = {}


def resolve_driver(driver: Optional[str],
                   workers: Optional[int]) -> Tuple[str, int]:
    """Explicit arguments beat the environment beats serial.  A worker
    count > 1 — from either source — implies the process driver unless
    a driver was named explicitly."""
    if workers is None:
        env_w = os.environ.get(ENV_WORKERS)
        workers = int(env_w) if env_w else None
    if driver is None:
        driver = os.environ.get(ENV_DRIVER) or None
    if driver is None:
        driver = "process" if (workers or 0) > 1 else "serial"
    if driver not in DRIVERS:
        raise ValueError(f"unknown aggregation driver {driver!r}; "
                         f"expected one of {DRIVERS}")
    if workers is None:
        workers = 4 if driver != "serial" else 1
    return driver, max(1, int(workers))


# --------------------------------------------------------------------------
# Serial path (the classic one-shot pipeline)
# --------------------------------------------------------------------------
def run_serial(profile_paths: Sequence[str], out_dir: str, *,
               n_ranks: int = 4, n_threads: int = 4,
               structures=None, trace_paths: Sequence[str] = (),
               trace_db: bool = True, trace_pyramid: bool = False,
               timing: Optional[dict] = None) -> Database:
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.monotonic()
    expand = make_expander(structures) if structures else None

    # phases 1-2(-3): acquisition, unification (+ expansion), canonical ids
    uni = unify(acquire(profile_paths, n_ranks), n_threads=n_threads,
                expand=expand)
    t_unify = time.monotonic() - t0

    # phase 4: statistic generation (parallel over profiles)
    entries = generate_stats(uni, n_workers=n_ranks * n_threads)
    t_stats = time.monotonic() - t0 - t_unify

    # phase 5: trace conversion (vectorized gather through gmap)
    gmaps = {up.path: up.gmap for up in uni.profiles}
    converted = convert_traces(trace_paths, gmaps, out_dir)
    if converted and trace_db:
        build_trace_db(converted, out_dir, pyramid=trace_pyramid,
                       parents=uni.parents)

    db = write_database(out_dir, uni.frames, uni.parents, uni.metrics,
                        entries, n_workers=n_ranks * n_threads,
                        t0=t0, timing_base={"unify_s": t_unify,
                                            "stats_s": t_stats})
    if timing is not None:
        _load_timing(out_dir, timing)
    return db


def _load_timing(out_dir: str, timing: dict) -> None:
    import json
    with open(os.path.join(out_dir, "meta.json")) as f:
        timing.update(json.load(f)["timing"])


# --------------------------------------------------------------------------
# Shard planning
# --------------------------------------------------------------------------
def plan_shards(profile_paths: Sequence[str],
                n_shards: int) -> List[List[str]]:
    """Round-robin the profiles over at most ``n_shards`` shards.

    *Any* partition folds to the same bytes (the merge contract,
    property-tested in tests/test_merge_properties.py), and phase 5 runs
    in-parent against the final tree, so traces never constrain the
    partition — even a GPU-stream trace whose dispatcher thread profiles
    land in different shards converts exactly as in the serial path.
    """
    shards: List[List[str]] = [[] for _ in range(max(1, n_shards))]
    for i, p in enumerate(profile_paths):
        shards[i % len(shards)].append(p)
    return [sh for sh in shards if sh]


# --------------------------------------------------------------------------
# Shard worker (top-level: picklable for ProcessPoolExecutor)
# --------------------------------------------------------------------------
def run_shard_stages(shard_paths: Sequence[str],
                     structures=None) -> ShardResult:
    """Phases 1-4 over one shard, entirely in memory: no trace work, no
    disk output — the fold (``merge_databases``) and the driver's final
    trace conversion consume the result."""
    t0 = time.monotonic()
    expand = make_expander(structures) if structures else None
    uni = unify(acquire(shard_paths, 1), n_threads=1, expand=expand)
    entries = generate_stats(uni, n_workers=1)
    identities: Dict[int, dict] = {}
    pvals: List[ProfileValues] = []
    coverage: Dict[int, np.ndarray] = {}
    for i, e in enumerate(entries):
        identities[i] = e.identity
        pvals.append(ProfileValues(i, e.ctx.astype(np.uint32),
                                   e.metric.astype(np.uint32), e.values))
        coverage[i] = e.coverage
    return ShardResult(uni.frames, np.asarray(uni.parents, np.int64),
                       uni.metrics, identities, pvals, coverage,
                       {up.path: up.gmap for up in uni.profiles},
                       unify_s=uni.unify_s,
                       stats_s=time.monotonic() - t0 - uni.unify_s)


def _process_pool(workers: int) -> ProcessPoolExecutor:
    ex = _PROCESS_POOLS.get(workers)
    if ex is None:
        for old in _PROCESS_POOLS.values():   # at most one pool alive
            old.shutdown(wait=False)
        _PROCESS_POOLS.clear()
        ex = ProcessPoolExecutor(max_workers=workers)
        _PROCESS_POOLS[workers] = ex
    return ex


# infrastructure failures the process driver degrades serially on: a
# dead/unusable pool, or arguments the executor cannot pickle across
# the pipe.  Deterministic task errors (a corrupt profile file, say)
# propagate unchanged — re-running them serially would only hit the
# same error again, slower.
_POOL_ERRORS = (BrokenProcessPool, pickle.PicklingError, TypeError,
                AttributeError)


def _execute_shards(driver: str, workers: int,
                    tasks: List[Sequence[str]],
                    structures) -> List[ShardResult]:
    if driver == "thread":
        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(lambda t: run_shard_stages(t, structures),
                               tasks))
    try:
        ex = _process_pool(workers)
        futs = [ex.submit(run_shard_stages, t, structures) for t in tasks]
        return [f.result() for f in futs]
    except _POOL_ERRORS as e:
        _PROCESS_POOLS.pop(workers, None)
        warnings.warn(
            f"process shard driver failed ({type(e).__name__}: {e}); "
            "retrying the shards serially — output is unaffected (the "
            "fold is byte-identical by construction)", RuntimeWarning)
        return [run_shard_stages(t, structures) for t in tasks]


# --------------------------------------------------------------------------
# The driver
# --------------------------------------------------------------------------
def run(profile_paths: Sequence[str], out_dir: str, *,
        n_ranks: int = 4, n_threads: int = 4, structures=None,
        trace_paths: Sequence[str] = (), trace_db: bool = True,
        trace_pyramid: bool = False,
        timing: Optional[dict] = None, workers: Optional[int] = None,
        driver: Optional[str] = None) -> Database:
    """Aggregate ``profile_paths`` into ``out_dir`` under the selected
    driver.  All drivers produce byte-identical databases; the parallel
    ones are faster once shard work dominates the fold (>= ~16 profiles
    on this container, benchmarks/bench_pipeline.py)."""
    driver, workers = resolve_driver(driver, workers)
    profile_paths = list(profile_paths)
    trace_paths = list(trace_paths)
    serial_kw = dict(n_ranks=n_ranks, n_threads=n_threads,
                     structures=structures, trace_paths=trace_paths,
                     trace_db=trace_db, trace_pyramid=trace_pyramid,
                     timing=timing)
    if driver == "serial" or workers <= 1 or len(profile_paths) < 2:
        return run_serial(profile_paths, out_dir, **serial_kw)

    shards = plan_shards(profile_paths, workers)
    if len(shards) < 2:
        return run_serial(profile_paths, out_dir, **serial_kw)

    from repro_torch.core.merge import merge_databases

    t0 = time.monotonic()
    results = _execute_shards(driver, workers, shards, structures)
    t_shards = time.monotonic() - t0

    # the fold: byte-identical to one-shot over the union (merge contract)
    remaps: List[np.ndarray] = []
    db = merge_databases(results, out_dir, n_workers=n_ranks * n_threads,
                         trace_db=False, remaps_out=remaps)

    # phase 5 runs in-parent against the *final* canonical tree: compose
    # each profile's local->shard map with its shard's ->final remap, so
    # converted traces (and trace.db) match the serial path byte for byte
    gmaps: Dict[str, np.ndarray] = {}
    for res, remap in zip(results, remaps):
        for path, g in res.gmaps.items():
            gmaps[path] = remap[g]
    converted = convert_traces(trace_paths, gmaps, out_dir)
    if converted and trace_db:
        build_trace_db(converted, out_dir, pyramid=trace_pyramid,
                       parents=db.parents)

    if timing is not None:
        _load_timing(out_dir, timing)
        timing.update({"driver": driver, "workers": workers,
                       "n_shards": len(results), "shard_wall_s": t_shards,
                       "fold_s": time.monotonic() - t0 - t_shards})
    return db
