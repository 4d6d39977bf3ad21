"""Hardware-counter kernel measurement on the PyTorch port, end to end
(paper §6; ``examples/counter_report.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_counter_report.py
        [--device cpu|cuda]

1. export a small attention-like step ("the GPU kernel") with
   ``torch.export``,
2. enable counter collection (``repro_torch.counters``) in
   serialized-replay mode on rank 0 and single-pass multiplexing on rank 1,
3. dispatch the step under both profilers, each dispatch ending in a
   synchronize,
4. aggregate the two ranks' profiles — counter values merge with the same
   bitwise-deterministic accumulator fold as every other kind,
5. print the multiplex schedule, the per-kernel counter table with the
   derived occupancy / efficiency columns, and the trace-side top-kernel
   join.

Runs on CUDA where there is a card, else on the CPU.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core import export, viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.counters import ALL_COUNTERS, build_schedule, describe


def attention_like(x, w):
    s = torch.einsum("bqd,bkd->bqk", x, x) * x.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, x) @ w


REQUEST = ["flops", "mxu_flops", "hbm_read_bytes", "hbm_write_bytes",
           "hbm_bytes", "active_ns", "inst_executed"]


def main(argv=None):
    from repro_torch.core.profiler import Profiler

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_counters_")
    x = torch.ones((4, 128, 64), device=device)
    w = torch.ones((64, 64), device=device) * 0.01
    module = export.module_from_export(
        "attention_like", export.export_step(attention_like, (x, w)))

    print("counter catalog:")
    print(describe())
    print()
    print(build_schedule(ALL_COUNTERS).describe())
    print()

    profiles = []
    for rank, replay in ((0, True), (1, False)):
        prof = Profiler(os.path.join(out, f"measure_r{rank}"),
                        tracing=True, rank=rank, rng_seed=rank)
        sched = prof.enable_counters(REQUEST, replay=replay)
        mid = prof.register_structure("attention_like", module,
                                      export.cost(module))
        with prof:
            for _ in range(6):
                with prof.dispatch("kernel", "attention_like", stream=0,
                                   module_id=mid):
                    attention_like(x, w)
                    sync()
        paths = prof.write()
        profiles += [v for k, v in paths.items() if "trace" not in k]
        mode = "replay" if replay else "single-pass multiplex"
        print(f"rank {rank} ({mode}): {sched.n_passes} pass(es)/kernel, "
              f"{prof._monitor.stats['counter_records']} counter records")

    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=2,
                   n_threads=2)
    print()
    print(viewer.counter_table(db, top=5))
    print(f"\ndatabase: {out}/db")


if __name__ == "__main__":
    main()
