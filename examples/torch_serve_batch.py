"""Batched serving under measurement on the PyTorch port: prefill +
decode dispatches with per-stream traces and a utilization report
(``examples/serve_batch.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch qwen2-1.5b]
        [--device cpu|cuda]

The reduced config is served through ``repro_torch.launch.serve.serve``
with a profile directory: both steps are exported and registered with the
kernels' interiors bound, every step's dispatch ends in a synchronize,
and the top-down view shows the kernels (on a card, the flash prefill and
decode kernels; the config runs in bf16 at head_dim 64 there, where the
kernels take it) under their steps.  Runs on CUDA where there is a card,
else on the CPU.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core import viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.core.derived import GPU_UTILIZATION, database_columns
from repro_torch.launch.serve import serve
from repro_torch.serving.sweep import scenario_config


def kernel_calls(db) -> dict:
    """{step: sorted names of the kernels' ``custom-call`` ops that drew
    PC samples under that step's dispatch placeholder}."""
    col = db.stats["sum"][:, db.metric_id("gpu_inst/samples")]
    out = {}
    for g, fr in enumerate(db.frames):
        if fr.kind != "gpu_op" or not fr.name.startswith("custom-call:") \
                or col[g] <= 0:
            continue
        p = db.parents[g]
        while p >= 0 and db.frames[p].kind != "placeholder":
            p = db.parents[p]
        if p >= 0:
            step = db.frames[p].name.split(":", 1)[-1]
            out.setdefault(step, set()).add(fr.name.split(":", 1)[-1])
    return {step: sorted(names) for step, names in sorted(out.items())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_serve_")
    cfg = scenario_config(args.arch, device)
    toks, paths = serve(cfg, n_requests=args.requests, batch=args.batch,
                        prompt_len=args.prompt_len, gen_len=args.gen_len,
                        profile_dir=os.path.join(out, "prof"), device=device)
    print(f"generated {toks.shape[0]} x {toks.shape[1]} tokens")

    profiles = [v for k, v in paths.items()
                if k.startswith(("cpu_", "gpu_")) and "trace" not in k]
    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=1,
                   n_threads=2)
    print()
    print(viewer.top_down(db, "gpu_kernel/time_ns", max_depth=6,
                          max_children=4))
    print(f"\nkernel calls with PC samples, by step: {kernel_calls(db)}")
    cols = database_columns(db)
    util = GPU_UTILIZATION.evaluate(cols)
    print(f"\nGPU utilization at root: {util[0]:.1%} "
          "(derived metric, paper §4.5)")
    print(f"artifacts under {out}")


if __name__ == "__main__":
    main()
