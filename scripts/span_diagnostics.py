"""Diagnostics behind the port's spans and counters, on a card.

    python3 scripts/span_diagnostics.py --out spans.json \
        [--steps 30] [--seed 7] [--parts attribution,window,cost]

Three parts, printed as they finish and written to ``--out``:

- ``attribution``: one granite-moe-1b-a400m train step (the
  ``granite.train1k`` cell's step, after its three checked steps) under
  torch.profiler with host ops.  Each ``indexing_backward_kernel`` launch
  is put down to the backward node that launched it, the forward op of
  the same autograd sequence number, and the innermost span (``rt.*``)
  that op ran in, in launch order with its device ms.
- ``window``: ``--steps`` more steps, each under a device-only
  torch.profiler (so the MoE counts, ``models.moe.dispatch_counts``),
  with each step's dropped share, its ``indexing_backward_kernel`` ms
  (the last launch apart: the embedding's, by launch order) and its wall
  seconds.
- ``cost``: the same train step, and yi-6b prefill batches of the
  ``yi6b.prefill4k.prof`` cell's shape, under torch.profiler (host ops and
  device) with the spans and counters on (``on``), the spans alone
  (``spans``: the MoE's counter stubbed out) and neither (``off``: under
  ``scope.no_ranges``), in turns, host seconds a step or batch.

Run from the root of a checkout on a CUDA card.
"""
import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from hpcbench import harness  # noqa: E402
from hpcbench.drivers import train as train_driver  # noqa: E402
from hpcbench.reference.data import ZipfTokens  # noqa: E402
from repro_torch.core import scope  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

KERNEL = "indexing_backward_kernel"
MODES = ("on", "spans", "off")
ROUNDS = 5


@contextlib.contextmanager
def _mode(mode: str):
    """Spans and counters on, the spans alone, or neither."""
    if mode == "off":
        with scope.no_ranges():
            yield
        return
    count = moe._count
    if mode == "spans":
        moe._count = lambda *a: None
    try:
        yield
    finally:
        moe._count = count


def sync():
    torch.cuda.synchronize()


def _inner(events, tid, t, pick):
    """The innermost (latest-started) event of ``events`` on thread
    ``tid`` that holds time ``t`` and satisfies ``pick``."""
    best = None
    for e in events:
        if e["tid"] == tid and e["ts"] <= t <= e["ts"] + e["dur"] \
                and pick(e) and (best is None or e["ts"] >= best["ts"]):
            best = e
    return best


def attribution(events) -> list:
    """[{order, ms, node, fwd_op, span}] of each index-put backward
    kernel of one traced step, in launch order."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e["name"].startswith(scope.SPAN_PREFIX)]
    fwd = {}
    for e in ops:
        seq = e.get("args", {}).get("Sequence number")
        if seq is not None and not e["name"].startswith("autograd") \
                and "Backward" not in e["name"]:
            fwd.setdefault(seq, []).append(e)

    def forward_op(node):
        """The forward op of the node's sequence number: the one named
        after the node (``IndexBackward0`` -> ``aten::index``), else the
        longest."""
        cands = fwd.get(node["args"]["Sequence number"], [])
        want = "aten::" + node["name"].split("Backward")[0].lower()
        named = [e for e in cands if e["name"] == want]
        return (named or sorted(cands, key=lambda e: -e["dur"]) or
                [None])[0]
    out = []
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and KERNEL in e.get("name", "")),
                     key=lambda e: e["ts"])
    for i, k in enumerate(kernels):
        row = {"order": i, "ms": k["dur"] / 1e3, "node": None,
               "fwd_op": None, "span": None}
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            node = _inner(ops, launch["tid"], launch["ts"],
                          lambda e: "Sequence number" in e.get("args", {})
                          and "Backward" in e["name"]
                          and not e["name"].startswith("autograd"))
            if node is not None:
                row["node"] = node["name"]
                f = forward_op(node)
                if f is not None:
                    row["fwd_op"] = f["name"]
                    s = _inner(spans, f["tid"], f["ts"], lambda e: True)
                    row["span"] = s["name"] if s else None
        out.append(row)
    return out


def kernel_ms(prof) -> list:
    """Device ms of each index-put backward kernel, in launch order."""
    got = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in prof.events()
                 if KERNEL in e.name
                 and e.device_type == torch.autograd.DeviceType.CUDA)
    if not got:                       # no per-launch events: the sum
        return [sum(getattr(e, "device_time_total", 0) / 1e3
                    for e in prof.key_averages() if KERNEL in e.key)]
    return [us / 1e3 for _, us in got]


def train_parts(seed: int, n_steps: int, parts, out: dict) -> None:
    cell = harness.find_cell(ROOT, "granite.train1k")
    st = train_driver.Started(cell, seed, torch.device("cuda"))
    state = {"p": st.params, "o": st.opt_state, "i": cell.traffic[
        "check_steps"]}

    def step(mode: str = "on"):
        batch = st.feed(state["i"])
        state["i"] += 1
        t0 = time.perf_counter()
        with _mode(mode):
            state["p"], state["o"], _ = st.step_fn(state["p"], state["o"],
                                                   batch)
        sync()
        return time.perf_counter() - t0

    for _ in range(2):
        step()
    if "attribution" in parts:
        attribute(step, out)
    if "window" in parts:
        out["window"] = window(step, n_steps, lambda: state["i"] - 1)
    if "cost" in parts:
        cost = {m: [] for m in MODES}
        for _ in range(ROUNDS):
            for mode in MODES:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    cost[mode].append(step(mode))
        out["cost_train_s"] = cost
        print("cost train", json.dumps(cost), flush=True)


def attribute(step, out: dict) -> None:
    """One traced step with host ops: which launches are whose."""
    moe.reset_dispatch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    path = os.path.join(tempfile.gettempdir(), "span_diag_step.json")
    prof.export_chrome_trace(path)
    del prof
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    rows = attribution(events)
    del events
    out["attribution"] = {"counts": moe.dispatch_counts(), "launches": rows}
    print("attribution", json.dumps(out["attribution"]), flush=True)


def window(step, n_steps: int, index) -> list:
    """Drops and the kernel's time, step by step."""
    win = []
    for i in range(n_steps):
        moe.reset_dispatch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = step()
        ks = kernel_ms(prof)
        c = moe.dispatch_counts()
        win.append({"step": index(), "wall_s": wall,
                    "drop_pct": 100.0 * c["dropped"] / max(c["routed"], 1),
                    "dropped": c["dropped"], "routed": c["routed"],
                    "max_load": c["max_load"], "capacity": c["capacity"],
                    "index_bwd_ms": sum(ks), "last_ms": ks[-1] if ks else 0,
                    "launches": len(ks)})
        print("window", json.dumps(win[-1]), flush=True)
    return win


def prefill_cost(seed: int, out: dict) -> None:
    from repro_torch.launch import steps as steps_mod
    cell = harness.find_cell(ROOT, "yi6b.prefill4k.prof")
    t, m = cell.traffic, cell.config["model"]
    ref = harness.reference_module(cell)
    cfg = harness.port_config(m, cell.config["port_config"])
    B, S = t["batch"], t["prompt_len"]
    params = ref.make_params(m, seed, torch.device("cuda"))
    fn = steps_mod.make_prefill_step(cfg, T.ModelOptions(
        q_chunk=min(256, S), kv_chunk=min(256, S), ssm_chunk=min(64, S)))
    zipf = ZipfTokens(m["vocab"], torch.device("cuda"))
    toks = [zipf.draw(seed, i, B, S) for i in range(3)]

    def batches(mode: str) -> float:
        sync()
        t0 = time.perf_counter()
        with _mode(mode):
            for x in toks:
                fn(params, {"tokens": x})
        sync()
        return (time.perf_counter() - t0) / len(toks)

    for _ in range(2):
        batches("on")
    cost = {m: [] for m in MODES}
    for _ in range(ROUNDS):
        for mode in MODES:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                cost[mode].append(batches(mode))
    out["cost_prefill_s"] = cost
    print("cost prefill", json.dumps(cost), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--parts", default="attribution,window,cost")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("span_diagnostics: no CUDA device", file=sys.stderr)
        return 2
    out = {"device": torch.cuda.get_device_name(0), "seed": args.seed}
    train_parts(args.seed, args.steps, parts, out)
    torch.cuda.empty_cache()
    if "cost" in parts:
        prefill_cost(args.seed, out)
        for k in ("cost_train_s", "cost_prefill_s"):
            out[k + "_median"] = {m: statistics.median(v)
                                  for m, v in out[k].items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("medians", json.dumps({k: out[k] for k in out
                                 if k.endswith("_median")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
