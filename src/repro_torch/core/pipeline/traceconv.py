"""Phase 5 — trace conversion (paper §6.1, §4.4).

Trace files are rewritten in terms of global ctx ids (vectorized gather
+ bulk ``TraceWriter.append_many``) and merged into one seekable
``trace.db`` (repro.traceview).  Three cases per ``.rtrc``:

- a trace with a matching ``.rpro`` basename converts through that
  profile's gmap (CPU-thread traces);
- a GPU-stream trace written by ``Profiler.write()`` records the
  *dispatching app thread* per event (the thread index rides the high
  ctx bits, ``trace.DISPATCH_CTX_SHIFT``; the identity's
  ``dispatch_profiles`` maps thread index -> profile basename): each
  event converts through its dispatcher's gmap — heterogeneous traces
  land on real database ctx ids;
- anything else (or a dispatch trace whose profiles were not part of
  this aggregation) passes through verbatim with a ``ctx_unmapped``
  identity flag, which downstream composition (``repro.core.merge``)
  honours by copying the line unchanged.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.trace import (DISPATCH_CTX_MASK, DISPATCH_CTX_SHIFT,
                              TraceWriter, read_trace, read_trace_header)


def required_profiles(tpath: str, identity: Optional[dict],
                      profile_paths) -> List[str]:
    """The profile paths a trace needs for exact ctx conversion, resolved
    against the given profile set — the same resolution rule
    ``convert_traces`` applies, exposed so tools (and the contract
    tests) can ask "which profiles must accompany this trace?" without
    converting.  The shard driver deliberately does NOT use it: phase 5
    runs in-parent against every gmap, so traces never constrain the
    partition.  ``identity`` may be ``None`` to read it from the trace
    header."""
    direct = tpath.replace(".rtrc", ".rpro")
    if direct in profile_paths:
        return [direct]
    if identity is None:
        try:
            identity = read_trace_header(tpath).get("identity", {})
        except (OSError, ValueError):
            return []
    dp = identity.get("dispatch_profiles")
    if not dp:
        return []
    base = os.path.dirname(tpath)
    cands = [os.path.join(base, bname) for bname in dp.values()]
    return [c for c in cands if c in profile_paths]


def _convert_dispatch(td, gmaps_by_idx: Dict[int, np.ndarray], tpath: str
                      ) -> np.ndarray:
    """Per-event conversion through each event's dispatcher gmap."""
    enc = np.asarray(td.ctx, np.int64)
    idxs = enc >> DISPATCH_CTX_SHIFT
    nodes = enc & DISPATCH_CTX_MASK
    gids = np.zeros(len(enc), np.int64)
    bad = 0
    for i in np.unique(idxs):
        gmap = gmaps_by_idx[int(i)]
        sel = idxs == i
        node = nodes[sel]
        valid = (node >= 0) & (node < len(gmap))
        bad += int((~valid).sum())
        gids[sel] = np.where(valid,
                             gmap[np.clip(node, 0, len(gmap) - 1)], 0)
    if bad:
        warnings.warn(
            f"{tpath}: {bad} trace event(s) reference ctx ids outside "
            "the dispatching thread's id map; attributing them to the "
            "root context", RuntimeWarning)
    return gids


def convert_traces(trace_paths: Sequence[str],
                   gmaps: Dict[str, np.ndarray],
                   out_dir: str) -> List[str]:
    """Rewrite every trace into ``out_dir`` with global ctx ids.
    ``gmaps`` maps profile path -> local-node-id -> global-ctx-id.
    Returns the converted paths (input order, deduplicated)."""
    converted: List[str] = []
    for tpath in trace_paths:
        td = read_trace(tpath)
        identity = td.identity
        gmap = gmaps.get(tpath.replace(".rtrc", ".rpro"))
        dispatch: Optional[Dict[int, np.ndarray]] = None
        if gmap is None:
            dp = identity.get("dispatch_profiles") or {}
            base = os.path.dirname(tpath)
            found = {int(i): gmaps.get(os.path.join(base, bname))
                     for i, bname in dp.items()}
            if dp and all(g is not None for g in found.values()):
                dispatch = found
                # the encoding is consumed here; the converted trace
                # carries plain database ctx ids like any other line
                identity = {k: v for k, v in identity.items()
                            if k != "dispatch_profiles"}
            else:
                # no matching profile(s): ctx ids pass through unmapped
                # (e.g. a gpu-stream trace aggregated without its rank's
                # thread profiles).  Mark the line so downstream
                # composition (repro.core.merge) copies it verbatim
                # instead of remapping ids that were never database ctx
                # ids.
                identity = {**identity, "ctx_unmapped": True}
        out = TraceWriter(os.path.join(out_dir, os.path.basename(tpath)),
                          identity)
        if dispatch is not None:
            gids = _convert_dispatch(td, dispatch, tpath)
        elif gmap is None:
            gids = td.ctx
        else:
            valid = (td.ctx >= 0) & (td.ctx < len(gmap))
            if not valid.all():
                warnings.warn(
                    f"{tpath}: {int((~valid).sum())} trace event(s) "
                    "reference ctx ids outside the profile's id map; "
                    "attributing them to the root context", RuntimeWarning)
            gids = np.where(valid,
                            gmap[np.clip(td.ctx, 0, len(gmap) - 1)], 0)
        out.append_many(td.starts, td.ends, gids)
        out.close()
        if out.path in converted:
            warnings.warn(
                f"{tpath}: basename collides with another trace path; "
                "the earlier converted trace was overwritten",
                RuntimeWarning)
        else:
            converted.append(out.path)
    return converted


def build_trace_db(converted: Sequence[str], out_dir: str, *,
                   pyramid: bool = False, parents=None) -> None:
    """Post-mortem merge into the seekable trace.db (traceview, §4.4):
    the converted traces already carry global ctx ids, so the merged
    database is directly renderable against the Database.

    ``pyramid=True`` also builds the ``trace.pyr`` tile pyramid
    (repro.traceview.pyramid) from the fresh trace.db and the final CCT
    ``parents`` — the opt-in phase-5 variant of the lazy
    ``ensure_pyramid`` cache."""
    from repro_torch.traceview.tracedb import build_db
    db_path = os.path.join(out_dir, "trace.db")
    with build_db(list(converted), db_path):
        pass
    if pyramid:
        if parents is None:
            raise ValueError("trace pyramid build requires the CCT parents")
        from repro_torch.traceview.pyramid import build_pyramid
        build_pyramid(db_path, parents).close()
