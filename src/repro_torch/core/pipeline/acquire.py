"""Phase 1 — input acquisition (paper §6.1).

Profile files are listed and distributed evenly across ranks
(round-robin), then processed as dynamic per-thread tasks inside a rank
(``pipeline.unify``).  Also home to the measurement-directory expansion
the ``python -m repro.core.aggregate`` CLI uses.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class Acquisition:
    """Phase-1 contract: per-rank work lists (round-robin by input
    order, the paper's static distribution before dynamic tasking)."""
    rank_paths: List[List[str]]

    @property
    def n_profiles(self) -> int:
        return sum(len(r) for r in self.rank_paths)


def acquire(profile_paths: Sequence[str], n_ranks: int) -> Acquisition:
    ranks: List[List[str]] = [[] for _ in range(max(1, n_ranks))]
    for i, p in enumerate(profile_paths):
        ranks[i % len(ranks)].append(p)
    return Acquisition(ranks)


def expand_inputs(inputs: Sequence[str]
                  ) -> Tuple[List[str], List[str]]:
    """CLI input acquisition: expand measurement directories into their
    ``*.rpro`` profiles and ``*.rtrc`` traces; pass files through.
    Returns ``(profile_paths, trace_paths)``, each in sorted order."""
    profiles: List[str] = []
    traces: List[str] = []
    for src in inputs:
        if os.path.isdir(src):
            profiles += sorted(glob.glob(os.path.join(src, "*.rpro")))
            traces += sorted(glob.glob(os.path.join(src, "*.rtrc")))
        elif src.endswith(".rtrc"):
            traces.append(src)
        else:
            profiles.append(src)
    return profiles, traces
