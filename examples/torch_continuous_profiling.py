"""Continuous profiling with incremental & sharded database merge on the
PyTorch port (``examples/continuous_profiling.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_continuous_profiling.py
        [--device cpu|cuda]

Two production shapes on one measured workload (a small exported
function, dispatched with a synchronize inside each dispatch):

1. **Rank shards.**  Each rank's measurement directory is aggregated
   *independently* (in production: separate processes, no shared GIL),
   then ``merge_databases`` folds the shard databases into one.  The
   result is byte-identical to a one-shot ``aggregate()`` over all
   profiles — verified below.
2. **Epoch increments.**  A long-running job profiles epoch 2 while the
   epoch-1 database already serves queries; ``aggregate(...,
   base_db=...)`` extends the database in place, again landing on the
   same bytes a from-scratch aggregation of both epochs would produce.

Runs on CUDA where there is a card, else on the CPU.
"""
import argparse
import itertools
import os
import tempfile

import torch

from repro_torch.core import export, viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.core.merge import merge_databases, summarize
from repro_torch.core.profiler import Profiler

clock_src = itertools.count(0, 250_000)    # deterministic 0.25 ms ticks


def step_fn(x):
    return torch.tanh(x @ x).sum()


def run_rank(out, rank, epoch, device, n_steps=6):
    """One rank's measurement for one epoch."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    x = torch.ones((96, 96), device=device)
    module = export.module_from_export(
        "train_step", export.export_step(step_fn, (x,)))
    prof = Profiler(os.path.join(out, f"epoch{epoch}_rank{rank}"),
                    tracing=True, rank=rank, rng_seed=rank,
                    clock=lambda: next(clock_src), unwind=False,
                    tag=f"epoch{epoch}")   # keeps epochs distinct
    mid = prof.register_structure("train_step", module, export.cost(module))
    with prof:
        for _ in range(n_steps):
            with prof.dispatch("kernel", "train_step", stream=0,
                               module_id=mid, duration_ns=2_000_000):
                step_fn(x)
                sync()
            with prof.cpu_region(f"host_epoch{epoch}"):
                next(clock_src)
    written = prof.write()
    profiles = [v for k, v in written.items() if "trace" not in k]
    traces = [v for k, v in written.items() if "trace" in k]
    return profiles, traces


def db_fingerprint(d):
    out = {}
    for fn in ("stats.npz", "metrics.cms", "metrics.pms", "trace.db"):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    print(f"device: {device}")
    out = tempfile.mkdtemp(prefix="repro_torch_continuous_")

    # ---- epoch 1, two ranks, measured separately --------------------------
    measurements = {r: run_rank(out, r, 1, device) for r in range(2)}

    # shape 1: per-rank shard databases, then one merge
    shard_dirs = []
    for r, (profiles, traces) in measurements.items():
        d = os.path.join(out, f"shard_rank{r}")
        aggregate(profiles, d, n_ranks=1, n_threads=2, trace_paths=traces)
        shard_dirs.append(d)
    merged = os.path.join(out, "db_epoch1")
    db_epoch1 = merge_databases(shard_dirs, merged)
    print(summarize(db_epoch1, shard_dirs))

    # the check the whole subsystem is built around: shard-then-merge ==
    # one-shot, byte for byte
    all_profiles = [p for pr, _ in measurements.values() for p in pr]
    all_traces = [t for _, tr in measurements.values() for t in tr]
    one_shot = os.path.join(out, "db_one_shot")
    aggregate(all_profiles, one_shot, trace_paths=all_traces)
    assert db_fingerprint(merged) == db_fingerprint(one_shot), \
        "shard-then-merge diverged from one-shot aggregate()"
    print("\nshard-then-merge is byte-identical to one-shot: OK")

    # ---- epoch 2 arrives: extend the database in place --------------------
    ep2 = {r: run_rank(out, r, 2, device) for r in range(2)}
    ep2_profiles = [p for pr, _ in ep2.values() for p in pr]
    ep2_traces = [t for _, tr in ep2.values() for t in tr]
    db = aggregate(ep2_profiles, merged, base_db=merged,
                   trace_paths=ep2_traces)
    print(f"\nafter epoch 2 increment: {len(db.profile_ids)} profiles, "
          f"{len(db.frames)} contexts")

    both = os.path.join(out, "db_both_epochs")
    aggregate(all_profiles + ep2_profiles, both,
              trace_paths=all_traces + ep2_traces)
    assert db_fingerprint(merged) == db_fingerprint(both), \
        "incremental epoch extension diverged from one-shot aggregate()"
    print("incremental epoch extension is byte-identical to one-shot: OK")

    print("\n" + viewer.top_down(db, "gpu_kernel/time_ns", max_depth=3))


if __name__ == "__main__":
    main()
