"""How often the serving governor sheds fidelity under CPU contention.

Runs the generous-budget half of the JAX package's
``tests/test_serving.py::test_governor_converges_under_real_load``
(budget 5.0, 16 requests of 2 ms wall-clock spins, 1 MHz sampling; the
test asserts level 0 and no throttle at the end) ``--reps`` times, alone
or while ``--load`` runs in a subprocess, and prints each run's final
level, SLO sheds and measured overhead, then how many runs shed.

    PYTHONPATH=src python scripts/governor_contention.py --reps 15 \\
        --load "python -m pytest -q -p no:cacheprovider -n 6 \\
                --dist loadfile tests/test_torch_structure.py ..."

``--load-cwd`` runs the load from another checkout (e.g. a parent
commit's), ``--load-env KEY=VALUE`` adds to its environment, and
``--every-s`` spreads the runs over the load.
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import tempfile
import time

from repro.serving.governor import GovernorConfig
from repro.serving.live import ServingProfiler
from repro.serving.window import DECODE


def _spin(ns: int) -> None:
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def generous_run(out_dir: str) -> dict:
    sp = ServingProfiler(out_dir, governor=GovernorConfig(budget=5.0,
                                                          interval=4),
                         sample_rate_hz=1e6)
    with sp:
        for i in range(16):
            with sp.request(f"r{i}", DECODE, tokens=1):
                with sp.profiler.dispatch("kernel", "step", stream=0):
                    _spin(2_000_000)
    return sp.governor.state()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--load", default=None)
    ap.add_argument("--load-cwd", default=None)
    ap.add_argument("--load-env", action="append", default=[])
    ap.add_argument("--warmup-s", type=float, default=5.0,
                    help="seconds between starting the load and run 1")
    ap.add_argument("--every-s", type=float, default=0.0,
                    help="seconds between runs, to spread them over the "
                         "load")
    args = ap.parse_args(argv)
    load = None
    if args.load:
        env = dict(os.environ)
        env.update(kv.split("=", 1) for kv in args.load_env)
        load = subprocess.Popen(shlex.split(args.load), cwd=args.load_cwd,
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        time.sleep(args.warmup_s)
    shed = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for rep in range(args.reps):
                st = generous_run(os.path.join(tmp, str(rep)))
                shed += st["level"] != 0 or st["throttle_downs"] != 0
                print(f"run {rep}: level {st['level']}, throttle downs "
                      f"{st['throttle_downs']}, SLO sheds {st['slo_sheds']},"
                      f" overhead {st['overhead']:.4f}", flush=True)
                if load is not None and load.poll() is not None:
                    print("the load ended", flush=True)
                    break
                time.sleep(args.every_s)
    finally:
        if load is not None:
            load.terminate()
            load.wait(timeout=60)
    print(f"shed in {shed} of {rep + 1} runs"
          f"{' under load' if args.load else ' alone'}", flush=True)


if __name__ == "__main__":
    main()
