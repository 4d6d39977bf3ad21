"""Does torch.profiler lose device records in a window after a large one?

    python scripts/profiler_drops.py            # on a card

For each size N of a first profiled window (0, 1,000, 10,000 and 40,000
launches of one small elementwise kernel), a fresh process profiles that
window, then three windows of 20 launches, and counts the device records
each of the 20-launch windows returns (20 when nothing is lost).  Each
size runs twice: with Kineto's defaults, and with a Kineto configuration
file (``KINETO_CONFIG``) that raises the CUPTI activity buffer
(``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB``) to 1024 MB.  Prints one JSON
line per process and a summary line with the card's name and power
limit.  Needs CUDA; exits 1 without it.
"""
import json
import os
import subprocess
import sys
import tempfile

SIZES = (0, 1_000, 10_000, 40_000)
SMALL = 20


def child(n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1024, device="cuda")
    for _ in range(10):
        x.add_(1.0)
    torch.cuda.synchronize()

    def window(k: int) -> int:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                x.add_(1.0)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.self_device_time_total > 0)
    first = window(n) if n else None
    return dict(first=first, after=[window(SMALL) for _ in range(3)])


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(child(int(sys.argv[2]))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_drops: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    conf = tempfile.NamedTemporaryFile("w", suffix=".conf", delete=False)
    conf.write("ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB=1024\n")
    conf.close()
    rows = []
    for setting, extra in (("default", {}),
                           ("buffer_1024MB", {"KINETO_CONFIG": conf.name})):
        for n in SIZES:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(n)], capture_output=True, text=True,
                env=dict(os.environ, **extra))
            if out.returncode:
                raise RuntimeError(out.stderr[-2000:])
            row = dict(setting=setting, first_window=n,
                       **json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.unlink(conf.name)
    lost = {f"{r['setting']}:{r['first_window']}":
            [SMALL - a for a in r["after"]] for r in rows}
    print(f"profiler_drops ({card}): records lost in each 20-launch window "
          f"after a first window of N launches: {json.dumps(lost)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
