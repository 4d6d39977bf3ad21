"""Phase 4 — statistic generation (paper §6.1, §6.2).

Per profile, metric values are scatter-added into a sparse
(ctx, metric) COO set and propagated up the tree with a vectorized
level-order sweep (one grouped ``np.add.at`` per tree level, deepest
first); workers share *nothing* — per-profile partial accumulators are
folded once, in canonical profile order, inside
``pipeline.database.write_database`` (the paper's communication-free
workers after exscan).  The FP addition order reproduces the dense
reverse-id reference sweep bit for bit (tests/test_aggregate_equiv.py).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from repro_torch.core.cct import tree_depths
from repro_torch.core.pipeline.contracts import (ProfileEntry, UnifiedProfile,
                                           Unification)
from repro_torch.core.profmt import ProfileData


def _group_sum_ordered(keys: np.ndarray, vals: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sum ``vals`` grouped by ``keys``, accumulating within each group in
    the array order of equal keys (stable sort + one unbuffered
    ``np.add.at``) — the FP addition order therefore matches a sequential
    scatter loop over the same data."""
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    uk, counts = np.unique(ks, return_counts=True)
    gidx = np.repeat(np.arange(len(uk)), counts)
    out = np.zeros(len(uk))
    np.add.at(out, gidx, vs)
    return uk, out


def _profile_inclusive_sparse(prof: ProfileData, gmap: np.ndarray,
                              parents: np.ndarray, depth: np.ndarray,
                              n_metrics: int
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One profile's inclusive (ctx, metric, value) triplets against the
    global tree, fully sparse.

    Exclusive values are scatter-added into COO keyed by
    ``ctx * n_metrics + metric``; inclusive propagation is a level-order
    sweep from the deepest tree level to the root — per level one grouped
    ``np.add.at`` folds the (already-inclusive) child entries into their
    parents.  Children are folded in decreasing global-id order after the
    parent's own exclusive value, which reproduces, bit for bit, the FP
    addition order of the classic dense reverse-id sweep (see
    docs/aggregation.md and tests/test_aggregate_equiv.py).
    """
    n_values = len(prof.values)
    if n_values == 0 or n_metrics == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    ranges = prof.ranges
    starts, counts = ranges[:, 1], ranges[:, 2]
    if (len(ranges) and starts[0] == 0
            and starts[-1] + counts[-1] == n_values
            and np.array_equal(starts[1:], starts[:-1] + counts[:-1])):
        node_of_value = np.repeat(gmap[ranges[:, 0]], counts)
    else:   # non-contiguous layout: rare, keep the per-range fill
        node_of_value = np.zeros(n_values, np.int64)
        for nid, start, count in ranges:
            node_of_value[start:start + count] = gmap[int(nid)]
    keys = node_of_value * n_metrics + prof.value_mids.astype(np.int64)
    uk, val = _group_sum_ordered(keys, prof.values)
    ctx = uk // n_metrics
    met = uk % n_metrics

    dd = depth[ctx]
    maxd = int(dd.max()) if len(dd) else 0
    for lvl in range(maxd, 0, -1):
        sel = dd == lvl
        if not sel.any():
            continue
        s_ctx, s_met, s_val = ctx[sel], met[sel], val[sel]
        # children fold into a parent in decreasing id order (stable), the
        # order the dense reverse-id sweep adds them in
        o = np.argsort(-s_ctx, kind="stable")
        up_keys = parents[s_ctx[o]] * n_metrics + s_met[o]
        plv = dd == lvl - 1
        # parent's own (exclusive) entry first, then its children
        cat_keys = np.concatenate([ctx[plv] * n_metrics + met[plv], up_keys])
        cat_vals = np.concatenate([val[plv], s_val[o]])
        uk2, nv = _group_sum_ordered(cat_keys, cat_vals)
        keep = ~plv
        ctx = np.concatenate([ctx[keep], uk2 // n_metrics])
        met = np.concatenate([met[keep], uk2 % n_metrics])
        val = np.concatenate([val[keep], nv])
        dd = depth[ctx]

    nz = val != 0.0          # match np.nonzero() on the dense matrix
    ctx, met, val = ctx[nz], met[nz], val[nz]
    o = np.argsort(ctx * n_metrics + met, kind="stable")  # row-major order
    return ctx[o], met[o], val[o]


def profile_coverage(up: UnifiedProfile) -> np.ndarray:
    """The set of canonical ctx ids this profile's CCT mapped into —
    sorted unique, always including the root.  Recorded per profile in
    the database (``coverage.npz``) so retention policies can rebuild
    the exact tree a re-aggregation of the surviving profiles would
    build (``repro.core.retention``)."""
    node_ids = up.prof.node_ids
    if len(node_ids) == 0:
        return np.zeros(1, np.int64)
    return np.unique(up.gmap[node_ids]).astype(np.int64)


def generate_stats(uni: Unification, *,
                   n_workers: int = 4) -> List[ProfileEntry]:
    """Run phase 4 over every unified profile.  Workers are
    communication-free: each returns its profile's sparse triplets; the
    partial accumulators are folded in ``write_database``, once, in
    canonical profile order — no shared state, no lock, deterministic."""
    metrics = uni.metrics
    n_metrics = len(metrics)
    parents = np.asarray(uni.parents, np.int64)
    depth = tree_depths(parents)

    def gen(up: UnifiedProfile) -> ProfileEntry:
        ctx, met, val = _profile_inclusive_sparse(up.prof, up.gmap, parents,
                                                  depth, n_metrics)
        return ProfileEntry(up.prof.identity, ctx, met, val,
                            profile_coverage(up))

    with ThreadPoolExecutor(max(1, n_workers)) as ex:
        return list(ex.map(gen, uni.profiles))
