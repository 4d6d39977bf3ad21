"""Staged aggregation pipeline (paper §6.1), one module per phase.

The ``hpcprof`` analogue is an explicitly staged pipeline; this package
gives each paper phase its own module behind a dataclass stage contract
(``contracts``), plus a pluggable shard driver:

- ``acquire``   — phase 1: input acquisition + round-robin distribution
- ``unify``     — phase 2: call-path unification into the global CCT,
  canonical renumbering (``GlobalTree``, ``canonical_order``)
- ``expand``    — phase 3: calling-context expansion against structure
- ``stats``     — phase 4: sparse statistic generation
- ``traceconv`` — phase 5: trace conversion to global ctx ids
- ``database``  — the on-disk database writer/reader shared with
  ``repro.core.merge`` (``Database``, ``write_database``)
- ``driver``    — serial / thread / process executors over profile
  shards, folded through ``merge_databases`` (docs/pipeline.md)
- ``cli``       — ``python -m repro.core.aggregate``

``repro.core.aggregate`` remains the public façade: every name that was
importable from it before the decomposition still is.
"""
from repro_torch.core.pipeline.acquire import Acquisition, acquire  # noqa: F401
from repro_torch.core.pipeline.contracts import (ProfileEntry,  # noqa: F401
                                           ShardResult, UnifiedProfile,
                                           Unification)
from repro_torch.core.pipeline.database import (Database,  # noqa: F401
                                          profile_sort_key, write_database)
from repro_torch.core.pipeline.expand import make_expander  # noqa: F401
from repro_torch.core.pipeline.stats import generate_stats  # noqa: F401
from repro_torch.core.pipeline.traceconv import convert_traces  # noqa: F401
from repro_torch.core.pipeline.unify import (GlobalTree,  # noqa: F401
                                       apply_order, canonical_order, unify)
