"""Prefill cells: batches of prompts through the port's prefill step, one
batch in flight (a closed loop), one new token a prompt.

Set-up makes the weights from the seed on the device, builds the step as
``repro_torch.launch.serve.serve`` does (``steps.make_prefill_step`` with
serve's options), warms it up on the cell's one shape and, with
``"profiler": "port"``, does what ``serve(profile_dir=...)`` does before
it measures: a ``core.profiler.Profiler`` with both steps (prefill and
decode) registered by ``serve.register_steps``, then ``prof.start()``.
The window then issues batch after batch, each prefill inside
``prof.dispatch("kernel", "prefill", ...)``, until ``--seconds`` have
passed; ``flush``, ``write`` and ``stop`` follow the window (and the
traced segment, which runs under the profiler too; the profiler's
counters are read at the window's end, after a flush).  (The
harness holds the loop because ``serve`` warms up and registers on
every call and takes a number of requests, not a time.)

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``prompt_len``,
``new_tokens``, ``profiler`` (``port`` or ``none``), ``check_batches``
(batches of the window kept for the check, drawn from the seed),
``trace_units`` and ``trace_attempts`` (batches in a traced segment
after the window, and segments tried) and ``kernels`` (the port's
kernels a segment's records are held to: the launch counter in
``kernels.ops`` and the device kernel's name).
"""
from __future__ import annotations

import os
import random
import shutil
import tempfile
import time

import torch

from hpcbench import harness, trace as trace_mod
from hpcbench.reference import compare, work
from hpcbench.reference.data import STREAM_SAMPLE, ZipfTokens, mix

WARM_INDEX = -1           # the warm-up batch's key, apart from the window's


class Reservoir:
    """``k`` items of a stream, each kept with equal chance, the choices
    drawn from the seed (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(mix(seed, STREAM_SAMPLE))

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def grown(cache: dict, max_len: int) -> dict:
    """The prefill cache with every k / v grown to ``max_len`` slots, as
    a decode step takes it."""
    out = {}
    for e, c in cache.items():
        out[e] = {}
        for name, leaf in c.items():
            big = torch.zeros(leaf.shape[:2] + (max_len,) + leaf.shape[3:],
                              dtype=leaf.dtype, device=leaf.device)
            big[:, :, :leaf.shape[2]] = leaf
            out[e][name] = big
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T

    t, m = cell.traffic, cell.config["model"]
    ref = harness.reference_module(cell)
    cfg = harness.port_config(m, cell.config["port_config"])
    B, S = t["batch"], t["prompt_len"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # --- set-up: weights, step, warm-up, registration ---------------------
    params = ref.make_params(m, seed, device)
    opts = T.ModelOptions(q_chunk=min(256, S), kv_chunk=min(256, S),
                          ssm_chunk=min(64, S))
    prefill_fn = steps_mod.make_prefill_step(cfg, opts)
    zipf = ZipfTokens(m["vocab"], device)
    warm = {"tokens": zipf.draw(seed, WARM_INDEX, B, S)}
    for _ in range(2):
        logits, cache = prefill_fn(params, warm)
        sync()
    prof = mid = None
    register_s = None
    prof_dir = os.path.join(tempfile.gettempdir(), "hpcbench-profile",
                            cell.name)
    if t["profiler"] == "port":
        from repro_torch.core.profiler import Profiler
        shutil.rmtree(prof_dir, ignore_errors=True)
        prof = Profiler(prof_dir, tracing=True, rng_seed=seed)
        decode_fn = steps_mod.make_decode_step(cfg, opts)
        max_len = S + t["new_tokens"]
        mid, _, info = serve_mod.register_steps(
            prof, cfg, opts, params, warm, grown(cache, max_len),
            logits.argmax(-1), B, S, max_len, prefill_fn, decode_fn)
        register_s = sum(v["seconds"] for v in info.values())
        prof.start()
    del logits, cache, warm
    keep = Reservoir(t["check_batches"], seed)
    ttft, finite = [], []

    def one(i: int) -> tuple:
        """Batch ``i``: its prompts issued, prefilled (inside the
        profiler's dispatch), the first tokens on the host."""
        toks = zipf.draw(seed, i, B, S)
        t_issue = time.perf_counter()
        if prof is not None:
            with prof.dispatch("kernel", "prefill", stream=0,
                               module_id=mid):
                logits, cache = prefill_fn(params, {"tokens": toks})
                sync()
        else:
            logits, cache = prefill_fn(params, {"tokens": toks})
        logits.argmax(-1).tolist()            # the first tokens, on the host
        return toks, logits, cache, time.perf_counter() - t_issue

    n = 0
    sync()

    # --- the measured window ----------------------------------------------
    unit_s = []
    t0 = t_end = time.perf_counter()
    setup_s = time.monotonic() - t_process
    while n == 0 or time.perf_counter() - t0 < seconds:
        toks, logits, cache, wait = one(n)
        t_prev, t_end = t_end, time.perf_counter()
        unit_s.append(t_end - t_prev)
        ttft.extend([wait] * B)
        finite.append(torch.isfinite(logits).all(-1))
        keep.offer((n, toks, logits, cache))
        n += 1
    window_s = t_end - t0
    del logits, cache
    counters = {}
    if prof is not None:
        prof.flush()          # the monitor drained: the window's counters
        counters = prof.overhead_counters()

    # --- a traced segment after the window (``--trace 1``) ----------------
    tracer = None
    if trace:
        tracer = trace_mod.Segments(
            t["trace_units"], t["trace_attempts"],
            [(k["records"], lambda k=k: getattr(ops, k["launches"])
              .launches) for k in t["kernels"]],
            os.path.join(tempfile.gettempdir(), "hpcbench-trace",
                         cell.name), sync)
        tracer.take(one, n)

    # --- after the window -------------------------------------------------
    notes = []
    if prof is not None:
        prof.flush()
        paths = prof.write()
        prof.stop()
        size = sum(os.path.getsize(p) for p in paths.values()
                   if os.path.isfile(p))
        notes.append(f"profile: {len(paths)} files, {size} bytes; "
                     f"window's counters {counters}; with the traced "
                     f"segment {prof.overhead_counters()}")
        shutil.rmtree(prof_dir, ignore_errors=True)
        del prof
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int(sum(int((~f).sum()) for f in finite))
    attempted = n * B

    metrics: dict = {}
    breakdown = None
    dev_line = harness.device_line(device, 1, peak)
    if not trace:
        values = {"prefill_tok_s": n * B * S / window_s,
                  "ttft_p95_ms": harness.p95(ttft) * 1e3,
                  "setup_s": setup_s}
        units = {x["name"]: x["unit"] for x in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    else:
        seg = tracer.result
        if seg is None:
            raise RuntimeError(
                f"no traced segment of {t['trace_units']} batches kept "
                f"every record of the port's kernels in the window: "
                f"{tracer.rejected}")
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        rec = {"kind": "prefill", "trace": seg, "counters": counters,
               "spans": {"register_s": register_s},
               "window": {"units": n, "seconds": window_s},
               "work": {"unit_flops": work.prefill_flops(m, B, S),
                        "kernels": {k["records"]: work.flash_work(
                            B, S, H, Hkv, D) for k in t["kernels"]}}}
        metrics = harness.read_metrics(cell, rec)
        dev_line.update(busy_s=seg["busy_s"], window_s=seg["window_s"])
        breakdown = {"device_ops": seg["device_ops"],
                     "idle_gaps": seg["idle_gaps"]}
        notes.append(f"traced segment: {seg['units']} batches, launches "
                     f"{seg['launches']}, records {seg['records']}, costs "
                     f"{seg['costs']}, retaken {len(tracer.rejected)}: "
                     f"{tracer.rejected}")
    notes.append(f"window: {n} batches of {B} x {S} in {window_s!r} s; "
                 f"checked batches {[it[0] for it in keep.items]}; batch "
                 f"seconds {[round(x, 4) for x in unit_s]}")

    # --- the check: the kept batches against the reference ----------------
    del params
    kept = keep.items
    keep.items = []
    if cuda:
        torch.cuda.empty_cache()
    params = ref.make_params(m, seed, device)
    ref.precise()
    nums = []
    for _, toks, logits, cache in kept:
        c = cache["e0"]
        nums.append(compare.prefill_numbers(
            params, m, toks, logits, c["k"], c["v"], ref.Numerics()))
    del kept
    numbers = compare.worst(nums)
    ok, shown = compare.judge(numbers, cell.limits["numbers"])
    notes.append(f"numbers by batch: {nums}")
    return {"correct": ok and failed == 0 and n > 0, "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev_line,
            "breakdown": breakdown, "shown": shown, "notes": notes}
