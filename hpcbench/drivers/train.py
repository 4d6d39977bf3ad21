"""Train cells: the port's donated train step, step after step.

Set-up makes the weights from the seed on the device, the AdamW state
(``optim.adamw.init``) and the step as ``launch.train.train`` builds it
(``steps.make_train_step(cfg, T.ModelOptions(), opt_cfg, donate=True)``:
remat ``dots_no_batch``, the flash kernel), then drives that same step
through its first ``check_steps`` steps on the window's own feed.  Those
steps are the warm-up and what the check reads: each step's loss, the
norm of each leaf's first gradient as AdamW got it (its first moment
after step 1 over 1 - b1) and, after the last of them, the norm of each
leaf's change from the seeded weights.  The window then runs whole
steps on fresh rows until ``--seconds`` have passed.

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``seq_len``,
``optimizer`` (every field of ``optim.adamw.OptConfig``),
``check_steps``, ``trace_units`` and ``trace_attempts`` (as for
prefill), ``scopes`` (the step's named scopes whose device time the
traced segment reads) and ``kernels`` (as for prefill).
"""
from __future__ import annotations

import os
import tempfile
import time

import torch

from hpcbench import harness, trace as trace_mod
from hpcbench.reference import compare, work
from hpcbench.reference.data import ZipfTokens


def _norm(x: torch.Tensor, y=None) -> float:
    """||x|| (or ||x - y||) in float64, one leading slice at a time."""
    total = 0.0
    xs = x.unbind(0) if x.dim() > 1 else [x]
    ys = [None] * len(xs) if y is None else (
        y.unbind(0) if y.dim() > 1 else [y])
    for a, b in zip(xs, ys):
        d = a.double() if b is None else a.double() - b.double()
        total += float(d.square().sum())
    return total ** 0.5


class Started:
    """The train step after its checked first steps: the step object,
    the donated params and AdamW state it hands on, its feed and what the
    check read from those steps (``prog``)."""

    def __init__(self, cell, seed: int, device):
        from repro_torch import tree
        from repro_torch.launch import steps as steps_mod
        from repro_torch.models import transformer as T
        from repro_torch.optim import adamw
        t, m = cell.traffic, cell.config["model"]
        ref = harness.reference_module(cell)
        cfg = harness.port_config(m, cell.config["port_config"])
        B, S = t["batch"], t["seq_len"]
        zipf = ZipfTokens(m["vocab"], device)

        def feed(i: int) -> dict:
            rows = zipf.draw(seed, i, B, S + 1)
            return {"tokens": rows[:, :-1],
                    "labels": rows[:, 1:].to(torch.int32)}
        self.feed = feed
        params = ref.make_params(m, seed, device)
        opt_cfg = adamw.OptConfig(**t["optimizer"])
        opt_state = adamw.init(params)
        self.step_fn = steps_mod.make_train_step(cfg, T.ModelOptions(),
                                                 opt_cfg, donate=True)
        prog = {"loss": [], "grad": {}, "change": {}}
        self.step_s = []
        for i in range(t["check_steps"]):
            t0 = time.perf_counter()
            params, opt_state, met = self.step_fn(params, opt_state,
                                                  feed(i))
            prog["loss"].append(float(met["loss"]))
            self.step_s.append(time.perf_counter() - t0)
            if i == 0:
                prog["grad"] = {".".join(p): _norm(mu) / (1 - opt_cfg.b1)
                                for p, mu in tree.leaves_with_paths(
                                    opt_state.mu)}
        first = ref.make_params(m, seed, device)
        now = dict(tree.leaves_with_paths(params))
        prog["change"] = {".".join(p): _norm(now[p], x)
                          for p, x in tree.leaves_with_paths(first)}
        self.params, self.opt_state, self.prog = params, opt_state, prog

    def batches(self, n: int) -> list:
        """The first ``n`` steps' rows, as the reference takes them."""
        return [(b["tokens"], b["labels"].long())
                for b in (self.feed(i) for i in range(n))]


def checked_steps(cell, seed: int, device) -> tuple:
    """(what the check reads from the program, the rows of its checked
    steps), the program's state freed."""
    st = Started(cell, seed, device)
    return st.prog, st.batches(cell.traffic["check_steps"])


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    from repro_torch.kernels import ops

    t, m = cell.traffic, cell.config["model"]
    ref = harness.reference_module(cell)
    B, S = t["batch"], t["seq_len"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # --- set-up: weights, state, step, the checked first steps ------------
    st = Started(cell, seed, device)
    params, opt_state, step_fn, prog = (st.params, st.opt_state,
                                        st.step_fn, st.prog)
    st.params = st.opt_state = None
    losses = []

    def one(i: int) -> None:
        nonlocal params, opt_state
        batch = st.feed(t["check_steps"] + i)
        params, opt_state, met = step_fn(params, opt_state, batch)
        sync()
        losses.append(met["loss"])

    n = 0
    sync()

    # --- the measured window ----------------------------------------------
    unit_s = []
    t0 = t_end = time.perf_counter()
    setup_s = time.monotonic() - t_process
    while n == 0 or time.perf_counter() - t0 < seconds:
        one(n)
        t_prev, t_end = t_end, time.perf_counter()
        unit_s.append(t_end - t_prev)
        n += 1
    window_s = t_end - t0

    # --- a traced segment after the window (``--trace 1``) ----------------
    tracer = None
    if trace:
        tracer = trace_mod.Segments(
            t["trace_units"], t["trace_attempts"],
            [(k["records"], lambda k=k: getattr(ops, k["launches"])
              .launches) for k in t["kernels"]],
            os.path.join(tempfile.gettempdir(), "hpcbench-trace",
                         cell.name), sync, t.get("scopes", ()))
        tracer.take(one, n)

    # --- after the window -------------------------------------------------
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = sum(1 for x in losses[:n] if not bool(torch.isfinite(x)))
    notes = [f"window: {n} steps of {B} x {S} in {window_s!r} s; step "
             f"seconds {unit_s}; set-up {setup_s!r} s, checked steps "
             f"{st.step_s}; losses {[float(x) for x in losses]}",
             f"program: {prog}"]
    metrics: dict = {}
    breakdown = None
    dev_line = harness.device_line(device, 1, peak)
    if not trace:
        values = {"train_tok_s": n * B * S / window_s, "setup_s": setup_s}
        units = {x["name"]: x["unit"] for x in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    else:
        seg = tracer.result
        if seg is None:
            raise RuntimeError(
                f"no traced segment of {t['trace_units']} steps kept every "
                f"record of the port's kernels in the window: "
                f"{tracer.rejected}")
        H, Hkv, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        rec = {"kind": "train", "trace": seg,
               "window": {"units": n, "seconds": window_s},
               "work": {"unit_flops": work.train_flops(m, B, S),
                        "kernels": {k["records"]: work.flash_work(
                            B, S, H, Hkv, D) for k in t["kernels"]}}}
        metrics = harness.read_metrics(cell, rec)
        dev_line.update(busy_s=seg["busy_s"], window_s=seg["window_s"])
        breakdown = {"device_ops": seg["device_ops"],
                     "idle_gaps": seg["idle_gaps"]}
        notes.append(f"traced segment: {seg['units']} steps, launches "
                     f"{seg['launches']}, records {seg['records']}, scopes "
                     f"{seg['scopes']}, costs "
                     f"{seg['costs']}, retaken {len(tracer.rejected)}: "
                     f"{tracer.rejected}")

    # --- the check: the reference follows the first steps -----------------
    del params, opt_state, step_fn, losses
    if cuda:
        torch.cuda.empty_cache()
    ref.precise()
    batches = st.batches(t["check_steps"])
    opt = dict(t["optimizer"])
    reference = ref.train_steps(m, opt, seed, batches, device,
                                ref.Numerics())
    numbers, where = compare.train_numbers(prog, reference)
    ok, shown = compare.judge(numbers, cell.limits["numbers"])
    notes.append(f"reference: {reference}")
    notes.append(f"worst leaves: {where}")
    return {"correct": ok and failed == 0, "attempted": n,
            "failed": failed, "metrics": metrics, "device": dev_line,
            "breakdown": breakdown, "shown": shown, "notes": notes}
