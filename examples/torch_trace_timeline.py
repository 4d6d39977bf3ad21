"""Time-centric trace analysis across ranks on the PyTorch port (paper
§4.4, §7 — hpctraceviewer; ``examples/trace_timeline.py`` on
``repro_torch``): merge per-rank/per-stream traces into one trace.db,
render the depth-over-time view at two zoom levels, and summarize
intervals (Summary tab, idleness/blame over time, top kernels).

    PYTHONPATH=src python examples/torch_trace_timeline.py
        [--device cpu|cuda]

Two "ranks" each run a two-stream pipeline of a small exported function
with a CPU-side stall in the middle; the zoomed view and the blame-over-
time bins both point at it.  The clock is deterministic (0.5 ms ticks),
so the views are the same on every device.  Runs on CUDA where there is a
card, else on the CPU.
"""
import argparse
import itertools
import os
import tempfile

import torch

from repro_torch.core import export
from repro_torch.core.aggregate import aggregate
from repro_torch.core.profiler import Profiler

clock_src = itertools.count(0, 500_000)   # deterministic 0.5 ms ticks


def step_fn(x):
    return torch.tanh(x @ x).sum()


def run_rank(out, rank, clock, device):
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    x = torch.ones((128, 128), device=device)
    module = export.module_from_export(
        "train_step", export.export_step(step_fn, (x,)))
    prof = Profiler(os.path.join(out, f"rank{rank}"), tracing=True,
                    rank=rank, rng_seed=rank, clock=clock, unwind=False)
    mid = prof.register_structure("train_step", module, export.cost(module))
    with prof:
        for i in range(8):
            with prof.dispatch("kernel", "train_step", stream=i % 2,
                               module_id=mid, duration_ns=3_000_000):
                step_fn(x)
                sync()
            if i == 4:
                with prof.cpu_region("jit_recompile_stall"):
                    for _ in range(40):   # the culprit: a long CPU stall
                        next(clock_src)
            with prof.cpu_region("host_preprocessing"):
                next(clock_src)
    return prof.write()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_timeline_")
    paths = {}
    for rank in range(2):
        paths[rank] = run_rank(out, rank, lambda: next(clock_src), device)

    profiles = [v for p in paths.values() for k, v in p.items()
                if "trace" not in k]
    traces = [v for p in paths.values() for k, v in p.items()
              if "trace" in k]
    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=2,
                   n_threads=2, trace_paths=traces)

    from repro_torch.traceview import (TraceDB, blame_over_time, render_view,
                                       top_kernels)
    tdb = TraceDB(db.trace_db_path())
    print(f"trace.db: {len(tdb.lines)} lines, {tdb.n_events} events, "
          f"[{tdb.t_min}, {tdb.t_max}) ns\n")
    lines = tdb.line_views()

    print("=== full run, depth 1 ===")
    print(render_view(lines, db, width=100, height=12, depth=1, top=5))

    t0, t1 = tdb.time_range()
    zt0 = t0 + (t1 - t0) * 2 // 5          # zoom into the middle fifth
    zt1 = t0 + (t1 - t0) * 3 // 5
    print("\n=== zoomed x2.5, depth 2 ===")
    print(render_view(lines, db, t0=zt0, t1=zt1, width=100, height=12,
                      depth=2, top=5))

    print("\n=== idleness / blame over time (8 bins) ===")
    for rank, d in blame_over_time(lines, t0, t1, 8).items():
        frac = " ".join(f"{v:4.0%}" for v in d["streams_idle_frac"])
        print(f"rank {rank} streams idle: {frac}")
        worst = sorted(d["blame"].items(), key=lambda kv: -kv[1].sum())[:2]
        for ctx, per_bin in worst:
            name = db.frames[ctx].pretty() if ctx < len(db.frames) \
                else f"ctx{ctx}"
            print(f"         blame {per_bin.sum() / 1e6:6.1f} ms  {name}")

    print("\n=== top kernels in the zoom window ===")
    for name, ns in top_kernels(lines, db, t0=zt0, t1=zt1, k=3):
        print(f"  {ns / 1e6:6.1f} ms  {name}")


if __name__ == "__main__":
    main()
