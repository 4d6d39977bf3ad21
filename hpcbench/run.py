"""The port's benchmark: one cell, one run.

    python3 hpcbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; its traffic's ``kind`` picks the
driver (``hpcbench/drivers/<kind>.py``).  With ``--trace 0`` the result
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones (read from a traced segment after the window).  Every
run checks the window's outputs against the plain reference and prints
each compared number beside its limit, as the last lines of standard
error and under ``check``, last in the result line: the last line of
standard output.

Exits non-zero, with no result, where CUDA or the cell's cards are
missing, where the port cannot be imported, or where JAX or the JAX
package was loaded into the process.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from hpcbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hpcbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    driver = importlib.import_module("hpcbench.drivers."
                                     + cell.traffic["kind"])
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=torch.device("cuda"),
                     t_process=T_PROCESS)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"hpcbench: the process loaded {foreign}", file=sys.stderr)
        return 3
    emit(out)
    return 0


def emit(out: dict) -> None:
    """Notes, then the compared numbers as the last lines of standard
    error; the result as the last line of standard output."""
    from hpcbench import harness
    from hpcbench.reference import compare
    for line in out.get("notes", ()):
        print(line, file=sys.stderr)
    for line in compare.describe(out["shown"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], out["device"],
                              out["shown"], out.get("breakdown")),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
