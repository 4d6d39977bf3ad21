"""Reproduce the PeleC case study (paper §8.4.1) on the PyTorch port: find
redundant GPU synchronizations with the derived metric  diff = sync_count -
kernel_count (``examples/find_redundant_sync.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_find_redundant_sync.py
        [--device cpu|cuda]

The serving loop (``repro_torch.launch.serve.serve(...,
redundant_sync=True)``) deliberately issues two device syncs per decode
step with no kernel between them (the paper's FillPatchIterator pattern: a
sync in a destructor that guards no computation).  The derived metric
pinpoints the calling contexts where syncs exceed kernel launches; in
PeleC, fixing three such contexts cut sync invocations 38% and sped the app
1.05x.  Runs on CUDA where there is a card, else on the CPU.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.aggregate import aggregate
from repro_torch.core.derived import SYNC_DIFF, database_columns
from repro_torch.launch.serve import serve
from repro_torch.serving.sweep import scenario_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_syncdiff_")
    cfg = scenario_config("qwen2-1.5b", device)
    _, paths = serve(cfg, n_requests=2, batch=2, prompt_len=16, gen_len=6,
                     profile_dir=os.path.join(out, "prof"),
                     redundant_sync=True, device=device)
    profiles = [v for k, v in paths.items()
                if k.startswith(("cpu_", "gpu_")) and "trace" not in k]
    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=1,
                   n_threads=2)

    cols = database_columns(db)
    diff = SYNC_DIFF.evaluate(cols)
    syncs = cols["gpu_sync/invocations"]
    kernels = cols["gpu_kernel/invocations"]

    print("contexts where sync_count > kernel_count "
          "(candidates for removal, cf. paper Fig. 7):\n")
    order = np.argsort(-diff)
    shown = 0
    for gid in order:
        if diff[gid] <= 0 or shown >= 6:
            break
        # inclusive counts: skip pure ancestors, report the deepest frames
        kids_diff = [diff[c] for c, par in enumerate(db.parents)
                     if par == gid]
        if kids_diff and max(kids_diff, default=0) == diff[gid]:
            continue
        print(f"  diff={int(diff[gid]):4d}  syncs={int(syncs[gid]):4d} "
              f"kernels={int(kernels[gid]):4d}  "
              f"{db.frames[gid].pretty()}")
        shown += 1
    assert (diff > 0).any(), "expected to find the injected redundant syncs"
    print("\nfix: drop the guard-nothing sync (paper: -38% sync calls, "
          "1.05x end to end)")


if __name__ == "__main__":
    main()
