"""Reproduce the Nyx case study (paper §8.5) on the PyTorch port:
attribute GPU idleness to the CPU code executing while every GPU stream is
idle (``examples/blame_analysis.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_blame_analysis.py
        [--device cpu|cuda]

A two-stream run of a small exported function is interleaved with
deliberate CPU-side stalls (the paper's culprits: cuCtxSynchronize before
an already-synchronizing copy, and JIT compilation at runtime).  The
blame analysis partitions all-streams-idle time across active CPU contexts
and ranks them — the paper used exactly this view to find and remove both
stalls (10.6s -> 9.8s, 1.08x on 640 streams).  The stalls are the JAX
example's: one 50 ms JIT stall, which ranks second to the six 10 ms
preprocessing regions.  It also prints how long each stall really lasted
(a sleep can run past its length on a busy host), which is what the blame
should find.  Runs on CUDA where there is a card, else on the CPU.
"""
import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch.core import export
from repro_torch.core.aggregate import aggregate
from repro_torch.core.blame import blame_gpu_idleness, blame_report
from repro_torch.core.profiler import Profiler
from repro_torch.core.trace import read_trace


def kernel_f(x):
    return torch.tanh(x @ x).sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_blame_")
    x = torch.ones((256, 256), device=device)
    module = export.module_from_export(
        "kernel_f", export.export_step(kernel_f, (x,)))

    prof = Profiler(os.path.join(out, "prof"), tracing=True, rng_seed=0)
    mid = prof.register_structure("kernel_f", module, export.cost(module))
    stalled = {"host_preprocessing": 0.0, "runtime_jit_compile": 0.0}

    def stall(name, seconds):
        with prof.cpu_region(name):
            t0 = time.perf_counter()
            time.sleep(seconds)
            stalled[name] += (time.perf_counter() - t0) * 1e3

    with prof:
        for i in range(6):
            with prof.dispatch("kernel", "kernel_f", stream=i % 2,
                               module_id=mid):
                kernel_f(x)
                sync()
            if i == 2:
                stall("runtime_jit_compile", 0.05)  # the paper's JIT stall
            stall("host_preprocessing", 0.01)
    paths = prof.write()

    profiles = [v for k, v in paths.items() if "trace" not in k
                and k.startswith("cpu")]
    cpu_trace_paths = [v for k, v in paths.items()
                       if k.startswith("cpu_trace")]
    # aggregation rewrites trace ctx ids into global calling-context ids
    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=1,
                   n_threads=1, trace_paths=cpu_trace_paths)
    cpu_traces = [read_trace(os.path.join(out, "db", os.path.basename(p)))
                  for p in cpu_trace_paths]
    gpu_traces = [read_trace(v) for k, v in paths.items()
                  if k.startswith("gpu_trace")]
    blame, idle = blame_gpu_idleness(cpu_traces, gpu_traces)
    print(f"stalls measured (ms): {json.dumps(stalled)}")
    print(f"total all-streams-idle time: {idle / 1e6:.1f} ms\n")
    print("GPU Idleness Blame (paper §7.2 tab), descending:")
    for name, frac in blame_report(blame, idle, db, top=8):
        print(f"  {frac:6.1%}  {name}")
    print("\npaper outcome: removing the two top culprits -> 1.08x "
          "end-to-end on 640 streams")


if __name__ == "__main__":
    main()
