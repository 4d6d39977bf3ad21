"""Merge-time database retention policies for continuous profiling.

A long-running job that extends its database every epoch
(``aggregate(..., base_db=...)``, ``Profiler(tag="epochN")``) grows
without bound; the ROADMAP's windowed-database item asks for retiring
old measurement windows **without recomputation**.  A
``RetentionPolicy`` does exactly that at merge time
(``merge_databases(..., retention=...)``): it filters the canonical
profile multiset — epochs beyond the keep window, duplicates, overflow
beyond a profile cap — and the merge then rebuilds the tree from the
surviving profiles' recorded context **coverage** (``coverage.npz``),
so the retained database is byte-identical to re-aggregating the
surviving profile set from scratch (pinned in tests/test_retention.py).

Policy semantics (composable; applied dedup -> window -> last -> max):

- ``dedup``            — identity-level dedup: among profiles whose
  identity JSON is identical (e.g. a database merged with itself, or a
  rank re-measured without a distinguishing ``tag``), keep the
  canonically-first one; exact-duplicate trace lines collapse too.
  Idempotent.
- ``since_epoch=TAG``  — the time-windowed database: keep epochs whose
  tag orders >= TAG (natural order: ``epoch10`` after ``epoch2``).
- ``keep_last_epochs=N`` — keep only the N newest distinct epochs.
- ``max_profiles=M``   — compaction cap: retire whole oldest epochs
  until <= M profiles remain; if a single epoch still exceeds M, drop
  canonically-first profiles **and their trace lines** (sub-epoch trace
  compaction: a line is dropped iff its identity belonged to a dropped
  profile and no surviving profile shares it; lines whose identity
  matches no profile at all are conservatively kept).

Profiles without a ``tag`` are not epoch-scoped: the epoch policies
(``since_epoch`` / ``keep_last_epochs``) always keep them.

CLI spec (``--retain`` on ``python -m repro.core.aggregate`` and
``python -m repro.core.merge``)::

    --retain "last=2,max=64,since=epoch3,dedup"
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline.database import profile_sort_key


# --------------------------------------------------------------------------
# Policy + spec parsing
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    keep_last_epochs: Optional[int] = None
    since_epoch: Optional[str] = None
    max_profiles: Optional[int] = None
    dedup: bool = False

    def __post_init__(self):
        for name in ("keep_last_epochs", "max_profiles"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"retention: {name} must be >= 1, "
                                 f"got {v}")

    @property
    def is_noop(self) -> bool:
        return (self.keep_last_epochs is None and self.since_epoch is None
                and self.max_profiles is None and not self.dedup)


def parse_retention(spec: str) -> RetentionPolicy:
    """Parse a ``--retain`` spec: comma-separated ``last=N``, ``since=TAG``,
    ``max=M``, ``dedup`` (order-free)."""
    kw = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        key, _, value = part.partition("=")
        if key == "dedup" and not value:
            kw["dedup"] = True
        elif key == "last" and value:
            kw["keep_last_epochs"] = int(value)
        elif key == "max" and value:
            kw["max_profiles"] = int(value)
        elif key == "since" and value:
            kw["since_epoch"] = value
        else:
            raise ValueError(
                f"retention spec {spec!r}: cannot parse {part!r} "
                "(expected last=N, since=TAG, max=M, dedup)")
    return RetentionPolicy(**kw)


def epoch_key(tag: str) -> tuple:
    """Natural sort key for epoch tags: digit runs compare numerically,
    so ``epoch10`` orders after ``epoch2``."""
    return tuple(int(tok) if tok.isdigit() else tok
                 for tok in re.split(r"(\d+)", tag) if tok)


# --------------------------------------------------------------------------
# Application
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RetentionReport:
    kept_profiles: int = 0
    dropped_profiles: int = 0
    deduped_profiles: int = 0
    dropped_epochs: List[str] = dataclasses.field(default_factory=list)
    kept_lines: int = 0
    dropped_lines: int = 0

    def summary(self) -> str:
        parts = [f"retention: kept {self.kept_profiles} profile(s)"]
        if self.deduped_profiles:
            parts.append(f"deduped {self.deduped_profiles}")
        if self.dropped_profiles:
            parts.append(f"retired {self.dropped_profiles}")
        if self.dropped_epochs:
            parts.append("epochs retired: "
                         + " ".join(self.dropped_epochs))
        if self.dropped_lines:
            parts.append(f"trace lines dropped: {self.dropped_lines}")
        return "; ".join(parts)


def _tag(identity: dict) -> Optional[str]:
    tag = identity.get("tag")
    return str(tag) if tag is not None else None


def _line_fingerprint(td) -> tuple:
    return (json.dumps(td.identity, sort_keys=True),
            np.asarray(td.starts, np.int64).tobytes(),
            np.asarray(td.ends, np.int64).tobytes(),
            np.asarray(td.ctx, np.int64).tobytes())


def apply_retention(entries: Sequence[tuple], trace_lines: Sequence,
                    policy: RetentionPolicy
                    ) -> Tuple[list, list, RetentionReport]:
    """Filter the profile multiset and its trace lines.

    ``entries`` are ``(identity, ctx, metric, values, coverage)`` tuples
    against one canonical ctx-id space (what ``merge_databases`` holds
    after the union remap); ``trace_lines`` are ``TraceData``.  Returns
    the surviving subsets (canonically ordered) and a report.  The
    caller is responsible for restricting the tree to the survivors'
    coverage (``merge_databases`` does).
    """
    report = RetentionReport()
    items = sorted(entries,
                   key=lambda e: profile_sort_key(e[0], e[1], e[2], e[3]))
    lines = list(trace_lines)
    n_in, lines_in = len(items), len(lines)

    if policy.dedup:
        seen, kept = set(), []
        for e in items:
            key = json.dumps(e[0], sort_keys=True)
            if key in seen:
                continue
            seen.add(key)
            kept.append(e)
        report.deduped_profiles = len(items) - len(kept)
        items = kept
        seen_l, kept_l = set(), []
        for td in lines:
            fp = _line_fingerprint(td)
            if fp in seen_l:
                continue
            seen_l.add(fp)
            kept_l.append(td)
        lines = kept_l

    def retire_epochs(retired: set):
        nonlocal items, lines
        if not retired:
            return
        report.dropped_epochs.extend(sorted(retired, key=epoch_key))
        items = [e for e in items if _tag(e[0]) not in retired]
        lines = [td for td in lines if _tag(td.identity) not in retired]

    tags = sorted({t for t in (_tag(e[0]) for e in items) if t is not None},
                  key=epoch_key)
    if policy.since_epoch is not None:
        cut = epoch_key(policy.since_epoch)
        retire_epochs({t for t in tags if epoch_key(t) < cut})
        tags = [t for t in tags if epoch_key(t) >= cut]
    if policy.keep_last_epochs is not None \
            and len(tags) > policy.keep_last_epochs:
        retire_epochs(set(tags[:-policy.keep_last_epochs]))
        tags = tags[-policy.keep_last_epochs:]

    if policy.max_profiles is not None:
        while len(items) > policy.max_profiles:
            alive = sorted({t for t in (_tag(e[0]) for e in items)
                            if t is not None}, key=epoch_key)
            if len(alive) > 1:
                retire_epochs({alive[0]})
            else:
                # one (or no) epoch left: cap by dropping canonically-
                # first profiles, and compact their trace lines too —
                # a line goes iff its identity belonged to a dropped
                # profile and no survivor shares it (lines matching no
                # profile at all are conservatively kept)
                dropped = items[:len(items) - policy.max_profiles]
                items = items[len(items) - policy.max_profiles:]
                kept_ids = {json.dumps(e[0], sort_keys=True)
                            for e in items}
                orphaned = {json.dumps(e[0], sort_keys=True)
                            for e in dropped} - kept_ids
                if orphaned:
                    lines = [td for td in lines
                             if json.dumps(td.identity, sort_keys=True)
                             not in orphaned]
                break

    report.kept_profiles = len(items)
    report.dropped_profiles = n_in - len(items) - report.deduped_profiles
    report.kept_lines = len(lines)
    report.dropped_lines = lines_in - len(lines)
    return items, lines, report
