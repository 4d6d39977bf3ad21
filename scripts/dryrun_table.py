"""The dry run's records (``python -m repro_torch.launch.dryrun --out D``)
as the table of ``PERF.md`` §6: one row per (arch x shape), each field
as "single / multi" (the (16, 16) and (2, 16, 16) meshes): status, peak
GB a card (and whether it fits one H100's 85.0 GB), the roofline's
three terms in ms, the dominant term, useful_ratio, mfu_model and the
record's trace seconds.  Skipped cells are listed after the table.

    python scripts/dryrun_table.py D
"""
import glob
import json
import os
import sys

MESHES = ("pod16x16", "pod2x16x16")


def fmt(x, spec):
    return "-" if x is None else format(x, spec)


def main(out_dir: str) -> int:
    recs = {}
    for path in glob.glob(os.path.join(out_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[r["arch"], r["shape"], r["mesh"]] = r
    cells = sorted({(a, s) for a, s, _ in recs})
    print("| cell | status | peak GB a card (fits) | compute ms | memory ms "
          "| collective ms | dominant | useful_ratio | mfu_model | trace s |")
    print("| --- " * 10 + "|")
    skipped, failed = [], []
    for arch, shape in cells:
        rs = [recs.get((arch, shape, m)) for m in MESHES]
        status = " / ".join(r["status"] if r else "missing" for r in rs)
        if all(r and r["status"] == "skipped" for r in rs):
            skipped.append(f"{arch} x {shape}")
            continue
        failed += [f"{arch} x {shape} x {m}" for r, m in zip(rs, MESHES)
                   if not r or r["status"] != "ok"]

        def col(fn):
            return " / ".join(fn(r) if r and r["status"] == "ok" else "-"
                              for r in rs)
        print(f"| {arch} x {shape} | {status} | "
              + col(lambda r: f"{r['memory']['peak_per_device'] / 1e9:.2f}"
                    f" ({'y' if r['memory']['fits_hbm'] else 'n'})") + " | "
              + col(lambda r: f"{r['roofline']['t_compute_s'] * 1e3:.4g}")
              + " | "
              + col(lambda r: f"{r['roofline']['t_memory_s'] * 1e3:.4g}")
              + " | "
              + col(lambda r: f"{r['roofline']['t_collective_s'] * 1e3:.4g}")
              + " | " + col(lambda r: r["roofline"]["dominant"]) + " | "
              + col(lambda r: f"{r['roofline']['useful_ratio']:.3g}") + " | "
              + col(lambda r: f"{r['roofline']['mfu_model']:.3g}") + " | "
              + col(lambda r: f"{r['trace_s']:.1f}") + " |")
    print(f"\nskipped (both meshes, shape_applicable): {', '.join(skipped)}")
    if failed:
        print(f"not ok: {', '.join(failed)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
