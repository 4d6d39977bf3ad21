"""Live telemetry export: serving snapshots as fleet shards (ISSUE 7).

Each export packages one ``ServingStats.snapshot()`` as a tiny,
perfectly ordinary profile database — a one-node CCT carrying a
dedicated ``serving`` metric kind — tagged with a monotonically
increasing epoch, and stages it through the existing ``ShardProducer``.
Nothing new on the wire: envelopes are content-addressed, the daemon's
journal dedups them, so live telemetry inherits the fleet tier's
exactly-once ingest *for free*, and the fleet database doubles as a
queryable time series (``read_telemetry``).

The telemetry registry is intentionally separate from the measurement
``default_registry()``: telemetry shards fold into their *own* fleet
database (the daemon's metric-taxonomy gate would rightly quarantine a
serving shard folded into a kernel-measurement database).
"""
from __future__ import annotations

import os
import shutil
import socket
import tempfile
from typing import Dict, List, Optional

from repro_torch.core.cct import CCT, Frame, HOST
from repro_torch.core.metrics import MetricRegistry
from repro_torch.core.profmt import write_profile

SERVING_KIND = "serving"
# fixed column order: every telemetry shard agrees, so the daemon's
# taxonomy gate admits them all into one fleet database
SERVING_METRICS = (
    "requests", "tokens", "tok_s",
    "prefill_p50_ms", "prefill_p99_ms",
    "decode_p50_ms", "decode_p99_ms",
    "overhead_frac", "governor_level",
    "samples_kept", "samples_dropped",
    "spool_depth", "throttled",
)

TAG_PREFIX = "telemetry_e"
TELEMETRY_CTX = "serving_telemetry"


def telemetry_registry() -> MetricRegistry:
    reg = MetricRegistry()
    reg.register_kind(SERVING_KIND, SERVING_METRICS)
    return reg


class TelemetryExporter:
    """Turns snapshots into epoch-tagged shard envelopes.

    ``export()`` never raises into the serving loop for delivery
    problems — the producer's sacrificial contract (bounded outbox,
    backoff, drop-oldest) already covers every failure mode; staging
    itself is local disk I/O on a few KB.
    """

    def __init__(self, producer, *, host: Optional[str] = None,
                 rank: int = 0, deliver: bool = True):
        self.producer = producer
        self.host = host or socket.gethostname()
        self.rank = rank
        self.deliver = deliver
        self.epoch = 0
        self.exported = 0

    def identity(self, epoch: int) -> Dict[str, object]:
        return {"host": self.host, "rank": self.rank, "thread": 0,
                "type": "cpu", "tag": f"{TAG_PREFIX}{epoch:08d}"}

    def shard_id(self, epoch: int) -> str:
        """Deterministic per-epoch shard id: at most one telemetry shard
        per (host, rank, epoch) ever folds.  A redelivered envelope
        dedups as a journal no-op; a *re-exported* epoch (same id, new
        payload bytes) is a journal conflict and quarantines visibly —
        either way the time series stays exactly-once."""
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.host)
        return f"telemetry-{safe}-r{self.rank}-e{epoch:08d}"

    def export(self, snapshot: Dict[str, float],
               epoch: Optional[int] = None) -> str:
        """Package ``snapshot`` as epoch ``epoch`` (default: next) and
        stage it into the producer's outbox; returns the shard id."""
        from repro_torch.core.aggregate import aggregate

        if epoch is None:
            epoch = self.epoch
        reg = telemetry_registry()
        kind = reg.kind(SERVING_KIND)
        cct = CCT()
        node = cct.insert_path([Frame(HOST, TELEMETRY_CTX,
                                      "<telemetry>", 0)])
        for metric in SERVING_METRICS:
            value = float(snapshot.get(metric, 0.0))
            if value:
                node.metrics.add(kind, metric, value)
        tmp = tempfile.mkdtemp(prefix="repro_telemetry_")
        try:
            prof = os.path.join(tmp, f"telemetry_r{self.rank}.rpro")
            write_profile(prof, cct, reg, self.identity(epoch))
            db_dir = os.path.join(tmp, "db")
            aggregate([prof], db_dir, n_ranks=1, n_threads=1,
                      trace_db=False, driver="serial")
            sid = self.producer.stage(db_dir, epoch=epoch,
                                      shard_id=self.shard_id(epoch),
                                      meta={"kind": "serving_telemetry",
                                            "host": self.host,
                                            "rank": self.rank})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.epoch = epoch + 1
        self.exported += 1
        if self.deliver:
            self.producer.deliver()
        return sid


def read_telemetry(db) -> List[Dict[str, float]]:
    """The fleet database as a telemetry time series: one row per
    exported epoch (sorted), each a dict of ``SERVING_METRICS`` plus
    ``epoch``/``host``/``rank``.  Works on any ``Database`` whose
    profiles carry ``telemetry_e*`` tags — the daemon's fleet db, a
    merged shard, or a local aggregate."""
    from repro_torch.core.sparse import PMSReader

    rows: List[Dict[str, float]] = []
    if not db.profile_ids:
        return rows
    reader = PMSReader(db.pms_path())
    for pid, ident in sorted(db.profile_ids.items()):
        tag = str(ident.get("tag", ""))
        if not tag.startswith(TAG_PREFIX):
            continue
        row: Dict[str, float] = {m: 0.0 for m in SERVING_METRICS}
        row["epoch"] = float(int(tag[len(TAG_PREFIX):]))
        row["host"] = ident.get("host", "")
        row["rank"] = float(ident.get("rank", 0))
        pv = reader.profile_values(int(pid))
        if pv is not None:
            for ctx, mid, val in zip(pv.ctx, pv.metric, pv.values):
                if ctx != 0:        # root holds the inclusive totals
                    continue
                name = db.metrics[int(mid)]
                if name.startswith(SERVING_KIND + "/"):
                    row[name.split("/", 1)[1]] = float(val)
        rows.append(row)
    rows.sort(key=lambda r: (r["host"], r["rank"], r["epoch"]))
    return rows
