"""The fleet aggregation daemon: crash-tolerant continuous ingest
(ISSUE 6 tentpole).

A long-running service that turns the one-shot ``merge_databases`` into
the always-on aggregation tier the exascale papers argue for
(PAPERS.md): producer hosts deliver checksummed shard envelopes
(``repro.fleet.envelope``) into a spool directory (or over a unix
socket), and the daemon folds them incrementally into one queryable
database with **exactly-once** semantics.

Spool layout::

    spool/
      incoming/     delivered envelopes (visible only after rename)
      pending/      <shard_id>/ — verified, unpacked shard databases
      quarantine/   rejected envelopes + <name>.reason files

Ingest pipeline, ``poll_once()``:

1. **recover** — repair any interrupted merge commit
   (``recover_interrupted_swap``: the previous database is either intact
   or parked at ``<db>.pre-merge``), sweep staging/temp droppings, and
   delete pending shards the journal already records as applied (the
   crash-between-commit-and-cleanup window).
2. **admit** — verify each incoming envelope (magic, sizes, SHA-256)
   and its unpacked shard database; torn, corrupt, malformed,
   conflicting, or unreadable shards go to quarantine with a reason —
   never a daemon crash.  Journaled ids are duplicates: dropped as
   no-ops.  Survivors are staged under ``pending/<id>`` and the
   envelope acknowledged (deleted).
3. **fold** — all pending shards fold through
   ``merge_databases(base_db, *pending, retention=...)`` in one commit;
   the successor journal rides the same directory swap
   (``extra_files``), so applying the shards and recording that they
   were applied is a single atomic rename.  Shards whose metric
   taxonomy does not match the database are quarantined instead of
   folded.

The correctness spine: after *any* schedule of crashes (at every
labeled fault point, ``repro.ft.inject``), restarts, and redeliveries,
the database is byte-identical to a one-shot ``aggregate()`` over the
union of journaled shards (tests/test_fleet_crash.py sweeps the
matrix; docs/fleet.md states the failure table).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.merge import (FP_COMMIT_MID_SWAP, FP_COMMIT_POST_SWAP,
                              FP_COMMIT_PRE_SWAP, LoadedShard,
                              merge_databases, recover_interrupted_swap)
from repro_torch.core.pipeline.database import Database
from repro_torch.core.retention import RetentionPolicy
from repro_torch.fleet.envelope import (EnvelopeError, atomic_write,
                                  sweep_stale_temps, unpack_envelope,
                                  verify_envelope)
from repro_torch.fleet.journal import JOURNAL_NAME, Journal
from repro_torch.ft import inject

ENVELOPE_SUFFIX = ".shard"
INGEST_META = "ingest.json"     # sha + meta, staged inside pending/<id>

# Labeled crash points on the daemon's admit/fold path; together with
# the merge commit points these are the daemon half of the crash
# matrix.  Order follows the ingest pipeline.
FP_ADMIT_PRE_UNPACK = "daemon.admit.pre_unpack"
FP_ADMIT_POST_UNPACK = "daemon.admit.post_unpack"
FP_ADMIT_POST_ACK = "daemon.admit.post_ack"
FP_FOLD_PRE_MERGE = "daemon.fold.pre_merge"
FP_FOLD_POST_COMMIT = "daemon.fold.post_commit"
FP_FOLD_POST_CLEANUP = "daemon.fold.post_cleanup"
inject.register_points(FP_ADMIT_PRE_UNPACK, FP_ADMIT_POST_UNPACK,
                       FP_ADMIT_POST_ACK, FP_FOLD_PRE_MERGE,
                       FP_FOLD_POST_COMMIT, FP_FOLD_POST_CLEANUP)

DAEMON_FAULT_POINTS = (
    FP_ADMIT_PRE_UNPACK, FP_ADMIT_POST_UNPACK, FP_ADMIT_POST_ACK,
    FP_FOLD_PRE_MERGE, FP_COMMIT_PRE_SWAP, FP_COMMIT_MID_SWAP,
    FP_COMMIT_POST_SWAP, FP_FOLD_POST_COMMIT, FP_FOLD_POST_CLEANUP,
)


@dataclasses.dataclass
class IngestReport:
    """What one ``poll_once`` did (all counts for this poll only)."""
    applied: List[str] = dataclasses.field(default_factory=list)
    duplicates: List[str] = dataclasses.field(default_factory=list)
    quarantined: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)                  # (name, reason)
    replay_cleaned: List[str] = dataclasses.field(default_factory=list)
    recovered: Optional[str] = None            # swap repair action
    folded: bool = False

    def summary(self) -> str:
        parts = [f"applied {len(self.applied)}"]
        if self.duplicates:
            parts.append(f"duplicates {len(self.duplicates)}")
        if self.quarantined:
            parts.append(f"quarantined {len(self.quarantined)}")
        if self.replay_cleaned:
            parts.append(f"replay-cleaned {len(self.replay_cleaned)}")
        if self.recovered:
            parts.append(f"recovered:{self.recovered}")
        return "ingest: " + ", ".join(parts)


class FleetDaemon:
    """Crash-tolerant aggregation daemon over a spool directory.

    Restart-safe by construction: a ``FleetDaemon`` holds no state that
    is not derivable from disk — constructing a fresh instance over the
    same ``db_dir``/``spool_dir`` *is* the restart path the crash tests
    exercise.
    """

    def __init__(self, db_dir: str, spool_dir: str, *,
                 retention: Optional[RetentionPolicy] = None,
                 n_workers: int = 2):
        self.db_dir = os.path.abspath(db_dir)
        self.spool_dir = os.path.abspath(spool_dir)
        self.incoming_dir = os.path.join(self.spool_dir, "incoming")
        self.pending_dir = os.path.join(self.spool_dir, "pending")
        self.quarantine_dir = os.path.join(self.spool_dir, "quarantine")
        self.retention = retention
        self.n_workers = max(1, n_workers)
        # cumulative counters (diagnostics only; never load-bearing)
        self.total_applied = 0
        self.total_duplicates = 0
        self.total_quarantined = 0
        self._stop = threading.Event()
        for d in (self.incoming_dir, self.pending_dir,
                  self.quarantine_dir):
            os.makedirs(d, exist_ok=True)

    # -- recovery -----------------------------------------------------------
    def recover(self, report: Optional[IngestReport] = None
                ) -> IngestReport:
        """Restore disk consistency after any crash: repair an
        interrupted merge swap, sweep temp droppings, and drop pending
        shards the journal already records (they *were* folded; only
        their cleanup was lost)."""
        report = report if report is not None else IngestReport()
        report.recovered = recover_interrupted_swap(self.db_dir)
        sweep_stale_temps(self.incoming_dir)
        for fn in os.listdir(self.pending_dir):
            if fn.startswith(".unpack_"):
                shutil.rmtree(os.path.join(self.pending_dir, fn),
                              ignore_errors=True)
        journal = self.journal()
        for sid in self._pending_ids():
            if sid in journal:
                shutil.rmtree(os.path.join(self.pending_dir, sid),
                              ignore_errors=True)
                report.replay_cleaned.append(sid)
        return report

    def journal(self) -> Journal:
        return Journal.load(self.db_dir)

    def database(self) -> Optional[Database]:
        if os.path.exists(os.path.join(self.db_dir, "meta.json")):
            return Database.load(self.db_dir)
        return None

    def _pending_ids(self) -> List[str]:
        return sorted(
            fn for fn in os.listdir(self.pending_dir)
            if not fn.startswith(".")
            and os.path.isdir(os.path.join(self.pending_dir, fn)))

    # -- quarantine ---------------------------------------------------------
    def _quarantine(self, path: str, reason: str,
                    report: IngestReport) -> None:
        """Move a rejected envelope (or unpacked shard dir) into
        quarantine with a ``.reason`` file; never raises on a missing
        source (a crashed prior attempt may have half-moved it)."""
        name = os.path.basename(path)
        dest = os.path.join(self.quarantine_dir, name)
        i = 0
        while os.path.lexists(dest):
            i += 1
            dest = os.path.join(self.quarantine_dir, f"{name}.{i}")
        if os.path.lexists(path):
            os.rename(path, dest)
        atomic_write(dest + ".reason", (reason + "\n").encode())
        report.quarantined.append((os.path.basename(dest), reason))
        self.total_quarantined += 1

    # -- admit --------------------------------------------------------------
    def _admit_one(self, env_path: str, journal: Journal,
                   report: IngestReport) -> None:
        try:
            header = verify_envelope(env_path)
        except EnvelopeError as e:
            self._quarantine(env_path, f"invalid envelope: {e}", report)
            return
        sid = header.shard_id
        if journal.conflict(sid, header.payload_sha256):
            self._quarantine(
                env_path,
                f"shard id {sid!r} already applied with different "
                f"payload (journal {journal.applied[sid][:12]}..., "
                f"envelope {header.payload_sha256[:12]}...)", report)
            return
        if sid in journal:
            os.unlink(env_path)             # duplicate delivery: no-op
            report.duplicates.append(sid)
            self.total_duplicates += 1
            return
        dest = os.path.join(self.pending_dir, sid)
        inject.fault_point(FP_ADMIT_PRE_UNPACK)
        fresh = not os.path.isdir(dest)
        unpack_envelope(env_path, dest)
        if fresh:
            try:
                self._validate_shard(dest)
            except (ValueError, OSError, KeyError) as e:
                shutil.rmtree(dest, ignore_errors=True)
                self._quarantine(env_path, f"invalid shard database: {e}",
                                 report)
                return
            atomic_write(
                os.path.join(dest, INGEST_META),
                json.dumps({"shard_id": sid,
                            "payload_sha256": header.payload_sha256,
                            "meta": header.meta},
                           sort_keys=True).encode())
        inject.fault_point(FP_ADMIT_POST_UNPACK)
        os.unlink(env_path)                 # acknowledge the delivery
        inject.fault_point(FP_ADMIT_POST_ACK)

    @staticmethod
    def _validate_shard(shard_dir: str) -> None:
        """A shard must load as a coherent database before it may ever
        reach the fold (``LoadedShard`` rejects torn meta/PMS pairs)."""
        LoadedShard(shard_dir, load_traces=False)

    def _shard_metrics(self, shard_dir: str) -> Optional[list]:
        """Metric columns of a pending shard (``None`` for an empty
        shard, which is compatible with anything)."""
        with open(os.path.join(shard_dir, "meta.json")) as f:
            meta = json.load(f)
        return meta["metrics"] if meta.get("profiles") else None

    def _shard_sha(self, shard_dir: str) -> str:
        try:
            with open(os.path.join(shard_dir, INGEST_META)) as f:
                return str(json.load(f)["payload_sha256"])
        except (OSError, ValueError, KeyError):
            return ""                       # pre-INGEST_META crash window

    # -- fold ---------------------------------------------------------------
    def _fold(self, journal: Journal, report: IngestReport) -> None:
        batch = [sid for sid in self._pending_ids() if sid not in journal]
        if not batch:
            return
        # metric-taxonomy gate: the database's columns are the reference;
        # mismatched shards quarantine rather than poison the fold.
        # Bootstrapping an empty database, the reference is the batch's
        # MAJORITY taxonomy (ties broken by smallest shard id holding
        # them) — shard ids are content hashes, so "first id in the
        # batch" would let an arbitrary outlier win the fleet db
        db = self.database()
        reference = db.metrics if db is not None and db.profile_ids \
            else None
        shard_metrics = {
            sid: self._shard_metrics(os.path.join(self.pending_dir, sid))
            for sid in batch}
        if reference is None:
            votes: dict = {}
            for sid in batch:
                m = shard_metrics[sid]
                if m is not None:
                    votes.setdefault(tuple(m), []).append(sid)
            if votes:
                top = max(len(sids) for sids in votes.values())
                reference = list(min(
                    (tax for tax, sids in votes.items()
                     if len(sids) == top),
                    key=lambda tax: min(votes[tax])))
        kept: List[str] = []
        for sid in batch:
            sdir = os.path.join(self.pending_dir, sid)
            metrics = shard_metrics[sid]
            if metrics is not None and reference is not None \
                    and metrics != reference:
                self._quarantine(
                    sdir, f"metric taxonomy mismatch: shard has "
                    f"{len(metrics)} column(s) ({metrics[:3]}...), "
                    f"database has {len(reference)}", report)
                continue
            kept.append(sid)
        if not kept:
            return
        applied = {sid: self._shard_sha(os.path.join(self.pending_dir,
                                                     sid))
                   for sid in kept}
        successor = journal.with_applied(applied)
        inputs: List[str] = []
        if os.path.exists(os.path.join(self.db_dir, "meta.json")):
            inputs.append(self.db_dir)
        inputs += [os.path.join(self.pending_dir, sid) for sid in kept]
        inject.fault_point(FP_FOLD_PRE_MERGE)
        merge_databases(
            inputs, self.db_dir, n_workers=self.n_workers,
            retention=self.retention,
            extra_files={JOURNAL_NAME: successor.dumps()})
        inject.fault_point(FP_FOLD_POST_COMMIT)
        for sid in kept:
            shutil.rmtree(os.path.join(self.pending_dir, sid),
                          ignore_errors=True)
        inject.fault_point(FP_FOLD_POST_CLEANUP)
        report.applied.extend(kept)
        report.folded = True
        self.total_applied += len(kept)

    # -- the poll loop ------------------------------------------------------
    def poll_once(self) -> IngestReport:
        """One recover/admit/fold cycle.  Every step is restartable:
        killing the daemon anywhere in here and constructing a fresh one
        loses no acknowledged shard and re-applies none."""
        report = self.recover()
        journal = self.journal()
        for fn in sorted(os.listdir(self.incoming_dir)):
            if fn.startswith(".") or not fn.endswith(ENVELOPE_SUFFIX):
                continue
            self._admit_one(os.path.join(self.incoming_dir, fn),
                            journal, report)
        self._fold(journal, report)
        return report

    def stop(self) -> None:
        self._stop.set()

    def run(self, *, interval_s: float = 1.0,
            max_polls: Optional[int] = None) -> int:
        """Poll until stopped (or ``max_polls``); returns polls done."""
        polls = 0
        while not self._stop.is_set():
            self.poll_once()
            polls += 1
            if max_polls is not None and polls >= max_polls:
                break
            self._stop.wait(interval_s)
        return polls

    # -- status -------------------------------------------------------------
    def spool_depth(self) -> int:
        """The backpressure signal: shards delivered but not yet folded
        (incoming envelopes + pending unpacked shards).  Producers poll
        this (``ShardProducer.poll_backpressure``) to throttle their own
        measurement while the daemon digests a backlog."""
        incoming = sum(1 for fn in os.listdir(self.incoming_dir)
                       if fn.endswith(ENVELOPE_SUFFIX))
        return incoming + len(self._pending_ids())

    def status(self) -> dict:
        journal = self.journal()
        db = self.database()
        status = {
            "db": self.db_dir,
            "profiles": len(db.profile_ids) if db else 0,
            "contexts": len(db.frames) if db else 0,
            "applied_shards": len(journal.applied),
            "generation": journal.generation,
            "pending": self._pending_ids(),
            "incoming": sorted(
                fn for fn in os.listdir(self.incoming_dir)
                if fn.endswith(ENVELOPE_SUFFIX)),
            "quarantined": sorted(
                fn for fn in os.listdir(self.quarantine_dir)
                if not fn.endswith(".reason")),
        }
        status["spool_depth"] = (len(status["incoming"])
                                 + len(status["pending"]))
        return status


# --------------------------------------------------------------------------
# Socket ingest: a thin transport in front of the same spool pipeline
# --------------------------------------------------------------------------
_LEN = struct.Struct("<Q")
MAX_ENVELOPE_BYTES = 1 << 31


class SocketIngest(threading.Thread):
    """Unix-socket envelope receiver.

    Protocol: client sends ``u64le length`` + envelope bytes; server
    commits them into the daemon's incoming spool (temp + fsync +
    rename — the same all-or-nothing contract as directory delivery)
    and replies ``OK <shard_id>\\n`` or ``ERR <reason>\\n``.  Envelopes
    whose header cannot even be parsed are still committed under a
    content-hash name so the poll loop quarantines them visibly rather
    than the bytes vanishing.
    """

    def __init__(self, daemon: FleetDaemon, socket_path: str):
        super().__init__(daemon=True, name="fleet-socket-ingest")
        self.fleet = daemon
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(socket_path)
        self._srv.listen(8)
        self._srv.settimeout(0.2)
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                try:
                    self._serve(conn)
                except Exception as e:     # noqa: BLE001 — stay serving
                    try:
                        conn.sendall(f"ERR {e}\n".encode())
                    except OSError:
                        pass
        self._srv.close()

    def _serve(self, conn: socket.socket) -> None:
        raw = self._recv_exact(conn, _LEN.size)
        (n,) = _LEN.unpack(raw)
        if n == 0:
            # a zero-length frame is a status poll (backpressure):
            # reply OK + the daemon's status JSON on one line
            conn.sendall(b"OK " + json.dumps(
                self.fleet.status(), sort_keys=True).encode() + b"\n")
            return
        if n > MAX_ENVELOPE_BYTES:
            conn.sendall(b"ERR envelope too large\n")
            return
        data = self._recv_exact(conn, n)
        from repro_torch.fleet.envelope import MAGIC, read_header
        import hashlib
        import tempfile
        fd, tmp = tempfile.mkstemp(prefix=".tmp-socket-",
                                   dir=self.fleet.incoming_dir)
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            header, _ = read_header(tmp)
            name = header.shard_id + ENVELOPE_SUFFIX
        except EnvelopeError:
            digest = hashlib.sha256(data).hexdigest()[:12]
            name = f"socket-{digest}{ENVELOPE_SUFFIX}"
        os.replace(tmp, os.path.join(self.fleet.incoming_dir, name))
        conn.sendall(f"OK {name[: -len(ENVELOPE_SUFFIX)]}\n".encode())

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = conn.recv(min(1 << 20, n - got))
            if not chunk:
                raise ConnectionError(
                    f"peer closed after {got}/{n} bytes")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
