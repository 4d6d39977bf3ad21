"""End-to-end training under measurement on the PyTorch port, then the
analysis: ``examples/profile_train.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch_profile_train.py          # quick
    PYTHONPATH=src python examples/torch_profile_train.py --full \
        --arch qwen2-1.5b --steps 6 --seq 512 --batch 4             # card

The quick mode trains the reduced qwen2 config for a few steps (on CUDA
where there is a card, in bf16 at head_dim 64 so that the kernels take
it, else on the CPU); ``--full`` is the published architecture, sized for
one H100.  Either way the workflow is the same: the whole train step
(forward, the remat recompute, the backward, AdamW) is traced and
registered with the kernels' interiors bound, every step's dispatch is
timed, PC samples are attributed below it and into the kernels'
interiors, a checkpoint is written, and the post-mortem prints where a
train step's time went: by phase (the named scopes ``fwd_bwd``,
``grad_compression``, ``optimizer`` under the ``train_step``
placeholder), then top-down and flat, in full calling context.
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import scope, viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.launch.train import train
from repro_torch.models import transformer as T
from repro_torch.serving.sweep import scenario_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="the published architecture, not the reduced one")
    ap.add_argument("--device", default=None,
                    help="default: cuda where there is a card, else cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")

    out = args.out or tempfile.mkdtemp(prefix="repro_torch_train_")
    cfg = get_config(args.arch) if args.full else scenario_config(
        args.arch, device)
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    opts = T.ModelOptions(q_chunk=min(256, args.seq),
                          kv_chunk=min(256, args.seq),
                          ssm_chunk=min(64, args.seq),
                          loss_chunk=min(512, args.seq))
    print(f"training {cfg.name} ({cfg.n_params() / 1e6:.1f}M params) for "
          f"{args.steps} steps on {device}, profiling on")
    _, history, paths = train(
        cfg, shape, n_steps=args.steps, device=device,
        ckpt_dir=os.path.join(out, "ckpt"),
        ckpt_every=max(args.steps // 2, 1),
        profile_dir=os.path.join(out, "prof"), opts=opts,
        log_every=max(args.steps // 4, 1))
    print(f"loss: {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    with open(paths["measurement"]) as f:
        step = json.load(f)["steps"]["train_step"]
    print(f"train step: {step['ops']} ops, {step['custom_calls']} kernel "
          f"calls bound, traced and registered in {step['seconds']:.1f} s")

    profiles = sorted(v for k, v in paths.items()
                      if k.startswith(("cpu_", "gpu_")) and "trace" not in k)
    db = aggregate(profiles, os.path.join(out, "db"))
    shares = {k: round(v, 4) for k, v in scope.shares(db).items() if v}
    print(f"PC samples under train_step by phase: {shares}")
    print()
    print(viewer.top_down(db, "gpu_inst/samples", max_depth=8,
                          max_children=4))
    print()
    print(viewer.flat(db, "gpu_inst/samples", top=10))
    print(f"\nartifacts under {out}")


if __name__ == "__main__":
    main()
