"""Serving-scenario sweep over the model zoo, on the port.

One scenario = one architecture family (dense transformer / MoE / SSM)
x one traffic mix (prefill-heavy long prompts vs decode-heavy long
generations), served through the full always-on stack: per-request
windows, the overhead governor, live stats.  Each run is aggregated and
the sweep reports per-request GPU attribution and phase latency
percentiles straight out of the database/trace, alongside the governor's
steady state.  The scenarios, the report row and the CLI are the JAX
package's (``repro.serving.sweep``); ``serve`` is the port's, which runs
on ``device``.

On a CUDA device the reduced configurations run in bf16 at head_dim 64:
the Hopper attention kernels take bf16 at head_dim 64 or 128, and the
port has no fallback, while ``reduced()`` (a CPU smoke shape) is float32
at head_dim 16.  On the CPU they run as ``reduced()`` gives them.

CLI::

    python -m repro_torch.serving.sweep --small --device cpu --out /tmp/sweep
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Tuple

from repro_torch.serving.governor import GovernorConfig
from repro_torch.serving.live import ServingProfiler

CUDA_HEAD_DIM = 64


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    arch: str
    prompt_len: int
    gen_len: int

    @property
    def family(self) -> str:
        return self.name.split("-", 1)[0]

    @property
    def mix(self) -> str:
        return ("prefill-heavy" if self.prompt_len >= 4 * self.gen_len
                else "decode-heavy")


SCENARIOS: Tuple[Scenario, ...] = (
    Scenario("dense-prefill", "qwen2-1.5b", 64, 4),
    Scenario("dense-decode", "qwen2-1.5b", 8, 24),
    Scenario("moe-prefill", "granite-moe-1b-a400m", 64, 4),
    Scenario("moe-decode", "granite-moe-1b-a400m", 8, 24),
    Scenario("ssm-prefill", "xlstm-125m", 64, 4),
    Scenario("ssm-decode", "xlstm-125m", 8, 24),
)


def scenario_config(arch: str, device="cuda"):
    """The reduced configuration of ``arch`` on ``device``: as
    ``reduced()`` gives it on the CPU; in bf16 at head_dim
    ``CUDA_HEAD_DIM`` on a CUDA device, where the kernels run."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if torch.device(device).type == "cuda":
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  head_dim=CUDA_HEAD_DIM)
    return cfg


def run_scenario(scn: Scenario, out_dir: str, *, n_requests: int = 4,
                 batch: int = 2, small: bool = False, budget: float = 0.5,
                 producer=None, device="cuda") -> dict:
    """Serve one scenario end to end; returns the report row."""
    from repro_torch.core.aggregate import aggregate
    from repro_torch.launch.serve import serve
    from repro_torch.traceview.stats import (request_attribution,
                                             request_latency_percentiles)
    from repro_torch.traceview.tracedb import TraceDB

    cfg = scenario_config(scn.arch, device)
    prompt = min(scn.prompt_len, 16) if small else scn.prompt_len
    gen = min(scn.gen_len, 6) if small else scn.gen_len
    os.makedirs(out_dir, exist_ok=True)
    sp = ServingProfiler(out_dir,
                         governor=GovernorConfig(budget=budget, interval=4),
                         producer=producer)
    sp.start()
    serve(cfg, n_requests=n_requests, batch=batch, prompt_len=prompt,
          gen_len=gen, serving=sp, device=device)
    sp.profiler.flush()
    paths = sp.write()
    status = sp.status()
    governor = sp.governor.state() if sp.governor else {}
    sp.stop()

    profs = [v for k, v in sorted(paths.items()) if "trace" not in k]
    traces = [v for k, v in sorted(paths.items()) if "trace" in k]
    db = aggregate(profs, os.path.join(out_dir, "db"), n_ranks=1,
                   n_threads=1, trace_paths=traces)
    lines = TraceDB(db.trace_db_path()).line_views()
    attribution = [
        {"request": rid, "total_ns": total,
         "by_phase": {p: ns for p, ns in by.items()}}
        for rid, total, by in request_attribution(lines, db)]
    percentiles = request_latency_percentiles(lines, db)
    return {
        "scenario": scn.name, "arch": scn.arch, "family": scn.family,
        "mix": scn.mix, "prompt_len": prompt, "gen_len": gen,
        "status": status, "governor": governor,
        "attribution": attribution,
        "trace_latency_ms": {p: {str(int(q)): v for q, v in d.items()}
                             for p, d in percentiles.items()},
    }


def run_sweep(out_root: str, *, scenarios=SCENARIOS, small: bool = False,
              n_requests: int = 4, batch: int = 2,
              budget: float = 0.5, device="cuda") -> list:
    rows = []
    for scn in scenarios:
        row = run_scenario(scn, os.path.join(out_root, scn.name),
                           n_requests=n_requests, batch=batch,
                           small=small, budget=budget, device=device)
        rows.append(row)
    return rows


def report_line(row: dict) -> str:
    """One row of the sweep's report, as the CLI prints it."""
    st = row["status"]
    top = row["attribution"][0]["request"] if row["attribution"] else "-"
    return (f"{row['scenario']:>16} {row['mix']:>13} "
            f"tok/s={st['tok_s']:8.1f} "
            f"prefill_p50={st['prefill_p50_ms']:7.2f}ms "
            f"decode_p50={st['decode_p50_ms']:7.2f}ms "
            f"overhead={st['overhead_frac']:.3f} "
            f"level={row['governor'].get('level_name', '-')} "
            f"top_request={top}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_serving_sweep"))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--families", default=None,
                    help="comma list: dense,moe,ssm (default all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scns = SCENARIOS
    if args.families:
        keep = set(args.families.split(","))
        scns = tuple(s for s in scns if s.family in keep)
    rows = run_sweep(args.out, scenarios=scns, small=args.small,
                     n_requests=args.requests, batch=args.batch,
                     budget=args.budget, device=args.device)
    for row in rows:
        print(report_line(row))
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print("report:", os.path.join(args.out, "sweep.json"))


if __name__ == "__main__":
    main()
