"""The producer side of fleet ingest: stage-and-forward shard delivery
(ISSUE 6 tentpole).

Each profiled host runs a ``ShardProducer`` next to its serving
process.  The producer's contract is sacrificial: it must **never block
or crash the host it measures**.  Concretely:

- ``stage()`` packages a local shard database into a checksummed
  envelope in a bounded on-disk outbox (write-temp/fsync/rename, so a
  crash mid-stage leaves no torn envelope).  When the outbox exceeds
  its soft bound the producer reports *throttled* (callers may lower
  their profiling rate); at the hard bound it **drops the
  oldest-epoch envelopes with a counted warning** — losing the oldest
  measurements is the designed failure mode, stalling the host is not.
- ``deliver()`` pushes spooled envelopes to the daemon, oldest epoch
  first, retrying transport failures with the exponential backoff of
  ``repro.ft.watchdog.RestartPolicy`` (the same budget-per-window
  supervisor used for job restarts).  A crash between a successful send
  and the local acknowledgement re-delivers the envelope on restart;
  the daemon's journal dedups it (envelope ids are content-addressed),
  so at-least-once delivery composes to exactly-once ingest.

Transports are pluggable: ``DirectoryTransport`` renames into the
daemon's incoming spool (same-filesystem deployments, and the crash
tests); ``SocketTransport`` speaks the length-prefixed unix-socket
protocol of ``repro.fleet.daemon.SocketIngest``.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import struct
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.fleet.envelope import (FP_STAGE_PRE_RENAME, FP_STAGE_PRE_WRITE,
                                  read_header, pack_envelope,
                                  sweep_stale_temps)
from repro_torch.ft import inject
from repro_torch.ft.watchdog import RestartPolicy

ENVELOPE_SUFFIX = ".shard"

FP_SEND_PRE_DELIVER = "client.send.pre_deliver"
FP_SEND_POST_DELIVER = "client.send.post_deliver"
inject.register_points(FP_SEND_PRE_DELIVER, FP_SEND_POST_DELIVER)

# every client-process fault point, for the crash-matrix sweep
CLIENT_FAULT_POINTS = (FP_STAGE_PRE_WRITE, FP_STAGE_PRE_RENAME,
                       FP_SEND_PRE_DELIVER, FP_SEND_POST_DELIVER)


class TransportError(RuntimeError):
    """A delivery attempt failed; the envelope stays spooled."""


class DirectoryTransport:
    """Deliver by atomic rename into the daemon's incoming spool (the
    daemon only ever sees complete envelopes)."""

    def __init__(self, incoming_dir: str):
        self.incoming_dir = incoming_dir

    def send(self, env_path: str) -> None:
        try:
            dest = os.path.join(self.incoming_dir,
                                os.path.basename(env_path))
            fd, tmp = tempfile.mkstemp(prefix=".tmp-deliver-",
                                       dir=self.incoming_dir)
            try:
                with os.fdopen(fd, "wb") as out, open(env_path, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
                    out.flush()
                    os.fsync(out.fileno())
                os.replace(tmp, dest)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError as e:
            raise TransportError(f"directory delivery failed: {e}") from e

    def poll_status(self) -> dict:
        """Daemon spool depth observed straight from the filesystem
        (same-box deployments): undelivered incoming envelopes plus the
        sibling ``pending/`` unpacked shards — the same number
        ``FleetDaemon.spool_depth()`` reports."""
        try:
            incoming = sum(1 for fn in os.listdir(self.incoming_dir)
                           if fn.endswith(ENVELOPE_SUFFIX))
            pending_dir = os.path.join(
                os.path.dirname(os.path.abspath(self.incoming_dir)),
                "pending")
            pending = 0
            if os.path.isdir(pending_dir):
                pending = sum(1 for fn in os.listdir(pending_dir)
                              if not fn.startswith("."))
        except OSError as e:
            raise TransportError(f"status poll failed: {e}") from e
        return {"spool_depth": incoming + pending}


class SocketTransport:
    """Deliver over the daemon's unix-socket listener (``SocketIngest``):
    u64le length + envelope bytes, reply ``OK <id>`` / ``ERR <reason>``."""

    _LEN = struct.Struct("<Q")

    def __init__(self, socket_path: str, *, timeout_s: float = 30.0):
        self.socket_path = socket_path
        self.timeout_s = timeout_s

    def send(self, env_path: str) -> None:
        try:
            with open(env_path, "rb") as f:
                data = f.read()
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(self.timeout_s)
                s.connect(self.socket_path)
                s.sendall(self._LEN.pack(len(data)) + data)
                reply = s.makefile("rb").readline().decode().strip()
        except OSError as e:
            raise TransportError(f"socket delivery failed: {e}") from e
        if not reply.startswith("OK"):
            raise TransportError(f"daemon rejected envelope: {reply}")

    def poll_status(self) -> dict:
        """Status poll over the socket: a zero-length frame, to which
        ``SocketIngest`` replies ``OK <status json>``."""
        import json
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(self.timeout_s)
                s.connect(self.socket_path)
                s.sendall(self._LEN.pack(0))
                reply = s.makefile("rb").readline().decode().strip()
        except OSError as e:
            raise TransportError(f"status poll failed: {e}") from e
        if not reply.startswith("OK "):
            raise TransportError(f"daemon status poll failed: {reply}")
        try:
            return json.loads(reply[3:])
        except ValueError as e:
            raise TransportError(f"malformed status reply: {e}") from e


@dataclasses.dataclass
class DeliveryReport:
    delivered: List[str] = dataclasses.field(default_factory=list)
    failed: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)       # (name, last error)
    gave_up: bool = False           # restart budget exhausted


class ShardProducer:
    """Bounded-outbox producer: stage locally, deliver with backoff.

    ``clock``/``sleep`` are injectable so tests run the backoff schedule
    without real waiting.
    """

    def __init__(self, outbox_dir: str, transport, *,
                 producer: str = "producer",
                 spool_soft: int = 32, spool_max: int = 64,
                 daemon_spool_soft: Optional[int] = None,
                 policy: Optional[RestartPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if spool_max < 1 or spool_soft < 1:
            raise ValueError("spool bounds must be >= 1")
        self.outbox_dir = os.path.abspath(outbox_dir)
        self.transport = transport
        self.producer = producer
        self.spool_soft = spool_soft
        self.spool_max = spool_max
        self.daemon_spool_soft = daemon_spool_soft
        self.policy = policy if policy is not None else RestartPolicy(
            backoff_base_s=0.05, backoff_max_s=2.0)
        self.clock = clock
        self.sleep = sleep
        self.throttled = False          # outbox or daemon over soft bound
        self.daemon_spool_depth = 0     # last observed daemon backlog
        self.daemon_backpressured = False
        self.dropped = 0                # envelopes sacrificed, cumulative
        os.makedirs(self.outbox_dir, exist_ok=True)
        sweep_stale_temps(self.outbox_dir)

    # -- outbox -------------------------------------------------------------
    def spooled(self) -> List[str]:
        """Envelope paths, oldest epoch first (header ``meta.epoch``,
        then name — the delivery and drop order)."""
        ranked = []
        for fn in sorted(os.listdir(self.outbox_dir)):
            if fn.startswith(".") or not fn.endswith(ENVELOPE_SUFFIX):
                continue
            path = os.path.join(self.outbox_dir, fn)
            try:
                header, _ = read_header(path)
                epoch = int(header.meta.get("epoch", 0))
            except (ValueError, TypeError):
                epoch = 0
            ranked.append((epoch, fn, path))
        ranked.sort()
        return [path for _, _, path in ranked]

    def stage(self, db_dir: str, *, epoch: int = 0,
              meta: Optional[dict] = None,
              shard_id: Optional[str] = None) -> str:
        """Package ``db_dir`` into the outbox; returns the shard id.
        Never blocks: over the hard bound, the oldest epoch is dropped
        (counted, warned) to make room for the measurement just taken.
        ``shard_id`` overrides the content-derived id — telemetry
        exporters use a deterministic per-epoch id so a re-exported
        epoch dedups at the daemon instead of double-counting."""
        full_meta = dict(meta or {})
        full_meta["epoch"] = int(epoch)
        sid = pack_envelope(
            db_dir, os.path.join(self.outbox_dir, "{id}" + ENVELOPE_SUFFIX),
            shard_id=shard_id, producer=self.producer, meta=full_meta)
        self._enforce_bound()
        # refresh the combined backpressure flag on every enqueue, not
        # just in deliver/tick loops: a producer that only stages (e.g.
        # an exporter between governor ticks) must see its own outbox
        # filling — and the daemon backlog when observable — *before*
        # the governor's next note_backpressure read, or it keeps
        # exporting at full fidelity into a pipe that is already behind
        self.poll_backpressure()
        return sid

    def poll_backpressure(self) -> bool:
        """Refresh ``throttled`` from both ends of the pipe: the local
        outbox depth (soft bound, as before) and — when the transport
        can observe the daemon and ``daemon_spool_soft`` is set — the
        daemon's unfolded spool depth.  A failed poll keeps the last
        observation (polling must never hurt the serving host).  The
        overhead governor consumes the combined flag
        (``OverheadGovernor.note_backpressure``)."""
        poll = getattr(self.transport, "poll_status", None)
        if poll is not None and self.daemon_spool_soft is not None:
            try:
                status = poll()
                self.daemon_spool_depth = int(
                    status.get("spool_depth", 0))
                self.daemon_backpressured = (
                    self.daemon_spool_depth > self.daemon_spool_soft)
            except TransportError:
                pass
        self.throttled = (len(self.spooled()) > self.spool_soft
                          or self.daemon_backpressured)
        return self.throttled

    def _enforce_bound(self) -> None:
        spooled = self.spooled()
        self.throttled = (len(spooled) > self.spool_soft
                          or self.daemon_backpressured)
        overflow = len(spooled) - self.spool_max
        if overflow <= 0:
            return
        victims = spooled[:overflow]     # oldest epochs first
        for path in victims:
            os.unlink(path)
        self.dropped += len(victims)
        warnings.warn(
            f"fleet outbox over spool_max={self.spool_max}: dropped "
            f"{len(victims)} oldest-epoch envelope(s) "
            f"({self.dropped} dropped total); serving is never blocked",
            RuntimeWarning, stacklevel=3)

    # -- delivery -----------------------------------------------------------
    def deliver(self) -> DeliveryReport:
        """Push every spooled envelope, oldest epoch first.  Transport
        failures retry with ``RestartPolicy`` backoff until the restart
        budget for the rolling window is exhausted, then give up (the
        envelopes stay spooled for the next ``deliver``)."""
        report = DeliveryReport()
        for path in self.spooled():
            name = os.path.basename(path)
            while True:
                inject.fault_point(FP_SEND_PRE_DELIVER)
                try:
                    self.transport.send(path)
                except TransportError as e:
                    now = self.clock()
                    self.policy.record_failure(now)
                    if not self.policy.should_restart(now):
                        report.failed.append((name, str(e)))
                        report.gave_up = True
                        return report
                    self.sleep(self.policy.backoff_s())
                    continue
                inject.fault_point(FP_SEND_POST_DELIVER)
                # ack only after the transport confirmed: a crash in
                # the window above re-delivers, and the daemon dedups
                os.unlink(path)
                report.delivered.append(name)
                break
        self.throttled = (len(self.spooled()) > self.spool_soft
                          or self.daemon_backpressured)
        return report
