"""Quickstart on the PyTorch port: measure a PyTorch program with the
HPCToolkit-analogue stack (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu|cuda]

1. export a small function ("the GPU kernel") with ``torch.export``,
2. register its program structure as the loaded GPU binary (hpcstruct
   input),
3. dispatch it a few times under the profiler (hpcrun), each dispatch
   ending in a synchronize so that its time is the device's,
4. aggregate the resulting profiles (hpcprof),
5. print the top-down / flat profile views (hpcviewer).

Runs on CUDA where there is a card, else on the CPU (``--device``).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.core import export, viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.core.profiler import Profiler


def attention_like(x, w):
    s = torch.einsum("bqd,bkd->bqk", x, x) * x.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, x) @ w


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    print(f"device: {device}")

    out = tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    x = torch.ones((4, 128, 64), device=device)
    w = torch.ones((64, 64), device=device) * 0.01
    module = export.module_from_export(
        "attention_like", export.export_step(attention_like, (x, w)))

    prof = Profiler(os.path.join(out, "measure"), tracing=True, rng_seed=0)
    module_id = prof.register_structure("attention_like", module,
                                        export.cost(module))
    with prof:
        for _ in range(10):
            with prof.dispatch("kernel", "attention_like", stream=0,
                               module_id=module_id):
                attention_like(x, w)
                sync()
        with prof.dispatch("copy", "weights_h2d", stream=1,
                           nbytes=w.numel() * 4):
            pass
    paths = prof.write()
    print(f"wrote {len(paths)} profile/trace files under {out}/measure\n")

    profiles = [v for k, v in paths.items() if "trace" not in k]
    db = aggregate(profiles, os.path.join(out, "db"), n_ranks=2,
                   n_threads=2)
    print(viewer.top_down(db, "gpu_inst/samples", max_depth=6))
    print()
    print(viewer.flat(db, "gpu_inst/samples", top=8))
    print(f"\ndatabase: {out}/db")


if __name__ == "__main__":
    main()
