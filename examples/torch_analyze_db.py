"""hpcviewer-style analysis of an existing database on the PyTorch port:
the three code-centric views (top-down / bottom-up / flat), the
thread-centric plot, and a custom derived metric — all against a database
produced by any other example (``examples/analyze_db.py`` on
``repro_torch``).

    PYTHONPATH=src python examples/torch_analyze_db.py [db_dir]
        [--device cpu|cuda]

Without a database directory it first produces one by profiling a short
run of a small exported function from four threads, each dispatch ending
in a synchronize.  Runs on CUDA where there is a card, else on the CPU.
"""
import argparse
import os
import tempfile
import threading

import torch

from repro_torch.core import export, viewer
from repro_torch.core.aggregate import Database, aggregate
from repro_torch.core.derived import DerivedMetric, database_columns
from repro_torch.core.profiler import Profiler
from repro_torch.core.sparse import CMSReader


def kern(x):
    return torch.tanh(x @ x).sum()


def make_db(out: str, device: str) -> str:
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    x = torch.ones((256, 256), device=device)
    module = export.module_from_export("kern", export.export_step(kern, (x,)))
    prof = Profiler(os.path.join(out, "prof"), tracing=False, rng_seed=0,
                    unwind=False)
    mid = prof.register_structure("kern", module, export.cost(module))

    def worker(n):
        for _ in range(n):
            with prof.dispatch("kernel", "kern", stream=0, module_id=mid):
                kern(x)
                sync()

    with prof:
        ts = [threading.Thread(target=worker, args=(3 + i,))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    paths = prof.write()
    profiles = [v for k, v in paths.items() if "trace" not in k]
    aggregate(profiles, os.path.join(out, "db"), n_ranks=2, n_threads=2)
    return os.path.join(out, "db")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("db_dir", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    if args.db_dir:
        db_dir = args.db_dir
    else:
        device = args.device or ("cuda" if torch.cuda.is_available()
                                 else "cpu")
        print(f"device: {device}")
        db_dir = make_db(tempfile.mkdtemp(prefix="repro_torch_analyze_"),
                         device)
    db = Database.load(db_dir)

    metric = "gpu_inst/samples" if "gpu_inst/samples" in db.metrics \
        else db.metrics[0]
    print(viewer.top_down(db, metric, max_depth=6, max_children=4))
    print()
    print(viewer.bottom_up(db, metric, top=5))
    print()
    print(viewer.flat(db, metric, top=8))

    # thread-centric: one CCT node's metric across all profiles
    cms = CMSReader(db.cms_path())
    mid = db.metric_id("gpu_kernel/invocations")
    best, best_n = 0, 0
    for ctx in cms.contexts():
        pids, _ = cms.metric_values(int(ctx), mid)
        if len(pids) > best_n:
            best, best_n = int(ctx), len(pids)
    pids, vals = viewer.thread_plot(db, cms, best, "gpu_kernel/invocations")
    print(f"\nthread-centric plot of {db.frames[best].pretty()!r}:")
    for p, v in zip(pids, vals):
        ident = db.profile_ids.get(int(p), {})
        print(f"  profile {p} {ident.get('type', '?')}: "
              + "#" * int(v) + f" {v:.0f}")

    # a user-authored derived metric (spreadsheet formula, §7.1)
    imbalance = DerivedMetric(
        "imbalance", "gpu_kernel__time_ns / cpu__time_ns")
    cols = database_columns(db)
    try:
        vals = imbalance.evaluate(cols)
        print(f"\nderived 'gpu/cpu time' at root: {vals[0]:.3f}")
    except KeyError:
        pass


if __name__ == "__main__":
    main()
