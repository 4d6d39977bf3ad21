"""Why chip_smoke.py's repeated-batch check (``time_train``) tempers the
seeded weights: on the card, at full width and depth, the loss of one
batch as training moves the untempered weights, and as it moves the
tempered ones (``chip_smoke._temper``: the attention's wq and wk by 1/8,
the mLSTM's wq, wk and wif by 1/16).

    python3 scripts/train_conditioning.py        # needs a CUDA card

For granite-moe-1b-a400m, xlstm-125m and qwen2-1.5b (chip_smoke's
training batch and options) it prints: the loss of the first step three
times on the same weights (is the step deterministic?), the losses of 6
steps on one repeated batch at lr 1e-6 and 3e-4 (``OptConfig(
warmup_steps=1)``) untempered, and at 3e-4 tempered.  A loss that moves
as much at lr 1e-6 as at 3e-4, on a step that repeats bitwise, is a loss
that jumps between nearby weights (a one-hot softmax whose winner flips,
an expert choice at the top-k boundary), not one that training is
failing to lower.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs                                    # noqa: E402
from repro_torch.configs import get_config                 # noqa: E402
from repro_torch.launch import steps as steps_mod          # noqa: E402
from repro_torch.models import transformer as T            # noqa: E402
from repro_torch.optim import adamw                        # noqa: E402

MODELS = ("granite-moe-1b-a400m", "xlstm-125m", "qwen2-1.5b")


def setup(name: str, temper: bool):
    cfg = get_config(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    if temper:
        cs._temper(params)
    spec = cs.TRAIN_PATHS[name]
    return (cfg, params, cs._lm_batch(cfg, spec["batch"], spec["seq"]),
            cs._train_opts(spec["seq"]))


def repeats(name: str) -> list:
    cfg, params, batch, opts = setup(name, False)
    return [float(steps_mod._value_and_grad(cfg, opts, params, batch)[0])
            for _ in range(3)]


def losses(name: str, temper: bool, lr: float, n: int = 6) -> list:
    cfg, params, batch, opts = setup(name, temper)
    state = adamw.init(params)
    step = steps_mod.make_train_step(cfg, opts, adamw.OptConfig(
        warmup_steps=1, total_steps=100, peak_lr=lr))
    out = []
    for _ in range(n):
        params, state, m = step(params, state, batch)
        out.append(float(m["loss"]))
    del params, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_conditioning: CUDA is not available", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    cs.build_kernels()
    for name in MODELS:
        row = {"repeats": repeats(name),
               "untempered lr 1e-6": losses(name, False, 1e-6),
               "untempered lr 3e-4": losses(name, False, 3e-4),
               "tempered lr 3e-4": losses(name, True, 3e-4)}
        print(f"{name}: {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
