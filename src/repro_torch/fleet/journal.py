"""The ingest journal: exactly-once shard application (ISSUE 6).

The journal is a JSON file, ``fleet_journal.json``, living **inside the
fleet database directory** and committed *atomically with the fold*:
``merge_databases(..., extra_files=...)`` writes it into the staged
output before the directory-swap commit, so the fold and the record
that the fold happened are one rename — there is no schedule of crashes
that applies a shard without journaling it or journals a shard without
applying it.  That single invariant is the whole exactly-once argument
(docs/fleet.md spells it out as a failure matrix):

- daemon dies before the swap  -> old database, old journal; the shard
  is still spooled and not journaled -> replayed on restart;
- daemon dies after the swap   -> new database, new journal; the spooled
  copy is journaled -> cleaned up on restart, never re-folded;
- a shard is delivered twice   -> second copy's id is journaled -> no-op.

Entries map shard id -> the envelope's payload SHA-256, so a
*different* payload arriving under an already-applied id is detected
(quarantined as a conflict) rather than silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

JOURNAL_NAME = "fleet_journal.json"
_VERSION = 1


@dataclasses.dataclass
class Journal:
    """Applied-shard record.  Immutable in spirit: ``with_applied``
    returns the successor journal the fold commits."""
    applied: Dict[str, str] = dataclasses.field(default_factory=dict)
    generation: int = 0            # fold count, for recovery diagnostics

    @classmethod
    def load(cls, db_dir: str) -> "Journal":
        path = os.path.join(db_dir, JOURNAL_NAME)
        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != _VERSION:
            raise ValueError(f"{path}: unknown journal version "
                             f"{data.get('version')!r}")
        return cls(applied={str(k): str(v)
                            for k, v in data["applied"].items()},
                   generation=int(data.get("generation", 0)))

    def with_applied(self, shards: Dict[str, str]) -> "Journal":
        """Successor journal with ``shards`` (id -> payload sha) added
        and the generation bumped."""
        merged = dict(self.applied)
        merged.update(shards)
        return Journal(applied=merged, generation=self.generation + 1)

    def dumps(self) -> bytes:
        return json.dumps(
            {"version": _VERSION, "generation": self.generation,
             "applied": dict(sorted(self.applied.items()))},
            indent=1, sort_keys=True).encode()

    def __contains__(self, shard_id: str) -> bool:
        return shard_id in self.applied

    def conflict(self, shard_id: str, payload_sha: str) -> bool:
        """True when ``shard_id`` was applied with *different* bytes —
        an id collision the daemon must quarantine, not dedup."""
        got = self.applied.get(shard_id)
        return got is not None and got != payload_sha
