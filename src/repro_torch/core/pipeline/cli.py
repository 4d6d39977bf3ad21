"""``python -m repro.core.aggregate`` — aggregate measurement output
into a database from the command line.

Inputs are ``.rpro`` profile files, ``.rtrc`` trace files, and/or
measurement directories (expanded to the profiles and traces inside).
The shard driver and retention policy ride the same flags the API
exposes::

    python -m repro.core.aggregate MEASURE_DIR -o DB --workers 4
    python -m repro.core.aggregate epoch9/ -o DB --base DB --retain last=4
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.core.pipeline.acquire import expand_inputs
from repro_torch.core.pipeline.driver import DRIVERS


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.core.aggregate",
        description="Aggregate .rpro profiles (+ .rtrc traces) into a "
                    "performance database (docs/pipeline.md).")
    ap.add_argument("inputs", nargs="+",
                    help="profile/trace files or measurement directories")
    ap.add_argument("-o", "--out", required=True,
                    help="output database directory")
    ap.add_argument("--workers", type=int, default=None,
                    help="shard-driver worker count (default: "
                         "$REPRO_AGG_WORKERS, else 4 for parallel "
                         "drivers)")
    ap.add_argument("--driver", choices=DRIVERS, default=None,
                    help="shard executor (default: $REPRO_AGG_DRIVER, "
                         "else process when --workers > 1, else serial)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="unification ranks inside a shard (default 4)")
    ap.add_argument("--threads", type=int, default=4,
                    help="per-rank threads inside a shard (default 4)")
    ap.add_argument("--base", default=None, metavar="DB",
                    help="extend an existing database (incremental epoch "
                         "mode; may equal --out)")
    ap.add_argument("--retain", default=None, metavar="SPEC",
                    help="retention policy applied at merge time, e.g. "
                         "'last=2,max=64,dedup' (repro.core.retention)")
    ap.add_argument("--no-trace-db", action="store_true",
                    help="skip building the merged trace.db")
    ap.add_argument("--trace-pyramid", action="store_true",
                    help="also build the trace.pyr tile pyramid next to "
                         "trace.db (O(tile) zoom/pan; docs/traceview.md)")
    args = ap.parse_args(argv)

    from repro_torch.core.aggregate import aggregate
    from repro_torch.core.merge import summarize
    from repro_torch.core.retention import parse_retention

    profiles, traces = expand_inputs(args.inputs)
    db = aggregate(
        profiles, args.out, n_ranks=args.ranks, n_threads=args.threads,
        trace_paths=traces, trace_db=not args.no_trace_db,
        trace_pyramid=args.trace_pyramid,
        base_db=args.base, workers=args.workers, driver=args.driver,
        retention=parse_retention(args.retain) if args.retain else None)
    print(f"AGGREGATE  {len(profiles)} profile(s), {len(traces)} "
          f"trace(s)" + (f" + base {args.base}" if args.base else ""))
    print(summarize(db, [args.out]).split("\n", 2)[2])
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
