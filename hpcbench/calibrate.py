"""Readings that the limits of ``correct`` are set from, on the card, at
the cell's own sizes, in one process:

    python3 hpcbench/calibrate.py --workload <name> --seeds N --control K

For each of ``N`` seeds the program's numbers: prefill cells run the
cell's prefill step on its first batch and hold it to the reference;
train cells run the donated step through its checked steps and the
reference after them (the drivers' own set-up and check, no window).
For the first ``K`` seeds the control's: the reference in float8
(``reference.decoder.Fp8``) put in the program's place; train cells also
read the fault of half the batch left out (the reference on the first
half of the rows, the mean taken over them).  A state left unchanged
reads 1 on ``change_gap`` by construction and is not run.  Prints one
JSON line a reading; needs CUDA.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED0 = 2_147_483_659


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def prefill_readings(cell, seeds, control: int, device) -> None:
    import torch
    from hpcbench import harness
    from hpcbench.reference import compare
    from hpcbench.reference.data import ZipfTokens
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    t, m = cell.traffic, cell.config["model"]
    ref = harness.reference_module(cell)
    ref.precise()
    cfg = harness.port_config(m, cell.config["port_config"])
    B, S = t["batch"], t["prompt_len"]
    opts = T.ModelOptions(q_chunk=min(256, S), kv_chunk=min(256, S),
                          ssm_chunk=min(64, S))
    prefill_fn = steps_mod.make_prefill_step(cfg, opts)
    zipf = ZipfTokens(m["vocab"], device)
    for j, seed in enumerate(seeds):
        t0 = time.monotonic()
        params = ref.make_params(m, seed, device)
        toks = zipf.draw(seed, 0, B, S)
        logits, cache = prefill_fn(params, {"tokens": toks})
        c = cache["e0"]
        nums = compare.prefill_numbers(params, m, toks, logits, c["k"],
                                       c["v"], ref.Numerics())
        del logits, cache, c
        _emit(seed=seed, side="program", numbers=nums,
              seconds=time.monotonic() - t0)
        if j < control:
            ks, vs = [], []
            lg = ref.prefill(params, m, toks, ref.Fp8(),
                             lambda i, k, v: (ks.append(k), vs.append(v)))
            nums = compare.prefill_numbers(params, m, toks, lg, ks, vs,
                                           ref.Numerics())
            del ks, vs, lg
            _emit(seed=seed, side="control_fp8", numbers=nums)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()


def train_readings(cell, seeds, control: int, device) -> None:
    import torch
    from hpcbench import harness
    from hpcbench.drivers import train as train_driver
    from hpcbench.reference import compare
    t, m = cell.traffic, cell.config["model"]
    ref = harness.reference_module(cell)
    ref.precise()
    opt = dict(t["optimizer"])
    for j, seed in enumerate(seeds):
        t0 = time.monotonic()
        prog, batches = train_driver.checked_steps(cell, seed, device)
        t1 = time.monotonic()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        reference = ref.train_steps(m, opt, seed, batches, device,
                                    ref.Numerics())
        nums, where = compare.train_numbers(prog, reference)
        _emit(seed=seed, side="program", numbers=nums, worst=where,
              loss=prog["loss"], ref_loss=reference["loss"],
              program_s=t1 - t0, reference_s=time.monotonic() - t1)
        if j < control:
            for side, nx, rows in (("control_fp8", ref.Fp8(), None),
                                   ("fault_half_batch", ref.Numerics(),
                                    t["batch"] // 2)):
                other = ref.train_steps(m, opt, seed, batches, device, nx,
                                        rows)
                nums, where = compare.train_numbers(other, reference)
                _emit(seed=seed, side=side, numbers=nums, worst=where,
                      loss=other["loss"])
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=SEED0)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json names the cell")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses a tiny cell (tests)")
    args = ap.parse_args(argv)
    import torch
    from hpcbench import harness
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: needs CUDA", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.root, args.workload)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    kind = cell.traffic["kind"]
    fn = {"prefill": prefill_readings, "train": train_readings}[kind]
    fn(cell, seeds, args.control, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
