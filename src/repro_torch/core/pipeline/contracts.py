"""Stage contracts: the dataclasses the pipeline phases hand each other.

Every phase of the aggregation pipeline (acquire -> unify -> expand ->
stats -> traceconv -> write) consumes and produces one of these, so the
stages compose the same way whether they run inline (serial driver), on
threads, or in worker processes (``pipeline.driver``).  The contracts
are deliberately plain — numpy arrays, lists, dicts — so a
``ShardResult`` pickles cheaply across a ``ProcessPoolExecutor`` pipe.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cct import Frame
from repro_torch.core.profmt import ProfileData
from repro_torch.core.sparse import ProfileValues


@dataclasses.dataclass
class UnifiedProfile:
    """One loaded profile after unification (phase 2 output, per file)."""
    path: str
    prof: ProfileData
    gmap: np.ndarray            # local node id -> canonical global ctx id


@dataclasses.dataclass
class Unification:
    """Phase-2 contract: the canonical global tree + per-profile maps."""
    frames: List[Frame]         # canonical order (see unify.canonical_order)
    parents: np.ndarray
    profiles: List[UnifiedProfile]
    unify_s: float = 0.0

    @property
    def metrics(self) -> List[str]:
        return self.profiles[0].prof.metrics if self.profiles else []


@dataclasses.dataclass
class ProfileEntry:
    """Phase-4 contract: one profile's inclusive sparse values against
    canonical ctx ids, plus the set of ctx ids the profile's CCT touched
    (``coverage`` — what retention policies need to rebuild the exact
    survivor tree, ``repro.core.retention``)."""
    identity: dict
    ctx: np.ndarray             # (V,) int64, row-major sorted with metric
    metric: np.ndarray          # (V,) int64
    values: np.ndarray          # (V,) float64
    coverage: np.ndarray        # (C,) int64, sorted unique ctx ids

    def astuple(self):
        return (self.identity, self.ctx, self.metric, self.values,
                self.coverage)


@dataclasses.dataclass
class ShardResult:
    """What a shard worker hands back to the fold (phases 1-4 over a
    subset of the profiles; no trace work, no disk output).

    Duck-type compatible with ``repro.core.merge.LoadedShard``: the same
    ``merge_databases`` fold consumes either, which is what makes the
    parallel driver's output byte-identical to the serial path by
    construction (the merge contract, docs/aggregation.md).
    """
    frames: List[Frame]
    parents: np.ndarray
    metrics: List[str]
    identities: Dict[int, dict]                 # profile id -> identity
    pvals: List[ProfileValues]                  # shard-canonical ctx ids
    coverage: Dict[int, np.ndarray]             # profile id -> ctx id set
    gmaps: Dict[str, np.ndarray]                # path -> local->shard map
    trace_lines: list = dataclasses.field(default_factory=list)
    unify_s: float = 0.0
    stats_s: float = 0.0
    out_dir: Optional[str] = None               # label for diagnostics
