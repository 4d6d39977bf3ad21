"""``python -m repro.fleet`` — run the aggregation daemon, deliver
shards, or inspect fleet state from the command line::

    python -m repro.fleet daemon DB --spool SPOOL --retain last=8
    python -m repro.fleet send SHARD_DB... --outbox OUT --to SPOOL/incoming
    python -m repro.fleet status DB --spool SPOOL

``daemon`` honors ``$REPRO_FAULT_POINTS`` / ``$REPRO_FAULT_MODE``
(``repro.ft.inject``) so the CI chaos job and subprocess crash tests
can kill it at any labeled point.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from repro_torch.ft import inject


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.fleet",
        description="Crash-tolerant fleet aggregation (docs/fleet.md).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("daemon", help="run the aggregation daemon")
    d.add_argument("db", help="fleet database directory")
    d.add_argument("--spool", required=True, help="spool directory")
    d.add_argument("--retain", default=None, metavar="SPEC",
                   help="retention at fold time, e.g. 'last=8,dedup'")
    d.add_argument("--interval", type=float, default=1.0,
                   help="poll interval seconds (default 1.0)")
    d.add_argument("--max-polls", type=int, default=None,
                   help="exit after N polls (default: run forever)")
    d.add_argument("--socket", default=None, metavar="PATH",
                   help="also accept envelopes on a unix socket")
    d.add_argument("--workers", type=int, default=2,
                   help="merge worker processes (default 2)")

    s = sub.add_parser("send", help="stage and deliver shard databases")
    s.add_argument("shards", nargs="+", help="shard database directories")
    s.add_argument("--outbox", required=True,
                   help="producer outbox directory")
    s.add_argument("--to", default=None, metavar="INCOMING",
                   help="daemon incoming spool directory")
    s.add_argument("--socket", default=None, metavar="PATH",
                   help="daemon unix socket (alternative to --to)")
    s.add_argument("--producer", default="producer")
    s.add_argument("--epoch", type=int, default=0)

    st = sub.add_parser("status", help="print fleet state as JSON")
    st.add_argument("db", help="fleet database directory")
    st.add_argument("--spool", required=True, help="spool directory")

    args = ap.parse_args(argv)

    if args.cmd == "daemon":
        from repro_torch.core.retention import parse_retention
        from repro_torch.fleet.daemon import FleetDaemon, SocketIngest
        if inject.arm_from_env():
            print(f"[fleet] fault injection armed: {inject.armed()}")
        daemon = FleetDaemon(
            args.db, args.spool, n_workers=args.workers,
            retention=parse_retention(args.retain) if args.retain
            else None)
        listener = None
        if args.socket:
            listener = SocketIngest(daemon, args.socket)
            listener.start()
        try:
            polls = daemon.run(interval_s=args.interval,
                               max_polls=args.max_polls)
        finally:
            if listener is not None:
                listener.stop()
        print(f"[fleet] daemon exiting after {polls} poll(s): "
              f"applied {daemon.total_applied}, "
              f"duplicates {daemon.total_duplicates}, "
              f"quarantined {daemon.total_quarantined}")
        return 0

    if args.cmd == "send":
        from repro_torch.fleet.client import (DirectoryTransport, ShardProducer,
                                        SocketTransport)
        if inject.arm_from_env():
            print(f"[fleet] fault injection armed: {inject.armed()}")
        if (args.to is None) == (args.socket is None):
            ap.error("send needs exactly one of --to / --socket")
        transport = DirectoryTransport(args.to) if args.to \
            else SocketTransport(args.socket)
        producer = ShardProducer(args.outbox, transport,
                                 producer=args.producer)
        for shard in args.shards:
            sid = producer.stage(shard, epoch=args.epoch)
            print(f"[fleet] staged {shard} as {sid}")
        report = producer.deliver()
        print(f"[fleet] delivered {len(report.delivered)}, "
              f"failed {len(report.failed)}"
              + (" (gave up)" if report.gave_up else ""))
        return 1 if report.gave_up else 0

    from repro_torch.fleet.daemon import FleetDaemon
    daemon = FleetDaemon(args.db, args.spool)
    print(json.dumps(daemon.status(), indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
