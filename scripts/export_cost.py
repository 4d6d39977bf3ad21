"""Seconds and op count of ``torch.export`` over a model's serving steps,
at full width on the CPU: what ``serve`` pays to register its prefill and
decode steps with the profiler (``core.export``), measured without a card.

    PYTHONPATH=src python scripts/export_cost.py --arch xlstm-125m \\
        --prompt 112 512

Prints one line per prompt length: the prefill step's export seconds and
ops, then the decode step's (batch 4, 32 generated tokens, as
``chip_smoke.py`` serves).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import export
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.models import transformer as T

GEN_LEN = 32


def step_cost(name: str, fn, args, kwargs=None) -> tuple:
    t0 = time.perf_counter()
    module = export.module_from_export(
        name, export.export_step(fn, args, kwargs or {}))
    return time.perf_counter() - t0, len(module.all_ops())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--prompt", type=int, nargs="+", default=[112])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = get_config(args.arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    for prompt in args.prompt:
        opts = T.ModelOptions(q_chunk=min(256, prompt),
                              kv_chunk=min(256, prompt),
                              ssm_chunk=min(64, prompt))
        prefill = steps.make_prefill_step(cfg, opts)
        decode = steps.make_decode_step(cfg, opts)
        batch = {"tokens": torch.zeros((args.batch, prompt),
                                       dtype=torch.long)}
        with torch.no_grad():
            logits, cache = prefill(params, batch)
        cache = serve_mod._grow_cache(cache, prompt + GEN_LEN, prompt)
        p_s, p_ops = step_cost("prefill", prefill, (params, batch))
        d_s, d_ops = step_cost("decode_step", decode,
                               (params, cache, prompt),
                               {"token": logits.argmax(-1)})
        print(f"{args.arch} prompt {prompt}: prefill export {p_s:.2f} s, "
              f"{p_ops} ops; decode export {d_s:.2f} s, {d_ops} ops",
              flush=True)


if __name__ == "__main__":
    main()
