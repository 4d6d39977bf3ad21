"""Readings that the limits of a Mamba-2 hybrid prefill cell
(``drivers/prefill_hybrid.py``) are set from, on the card, at the cell's
own sizes, in one process, by ``calibrate.py``'s protocol:

    python3 hpcbench/calibrate_hybrid.py --workload <name> --seeds N \\
        --control K

For each of ``N`` seeds the program's numbers on its first batch; for the
first ``K`` seeds the control's: the reference in float8
(``reference.decoder.Fp8``) in the program's place.  Prints one JSON line
a reading; needs CUDA (``--device cpu`` rehearses a tiny cell).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED0 = 2_147_483_659


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=SEED0)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose BENCHMARK.json names the cell")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from hpcbench import harness
    from hpcbench.drivers import prefill_hybrid
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate_hybrid: needs CUDA", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.root, args.workload)
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    prefill_hybrid.calibrate(cell, seeds, args.control,
                             torch.device(args.device),
                             lambda **kw: print(json.dumps(kw), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
