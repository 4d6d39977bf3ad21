"""Prefill cells of the Mamba-2 hybrid (``reference/granite_hybrid.py``):
batches of prompts through the port's prefill step, one batch in flight
(a closed loop), one new token a prompt, with no profiler.

The loop is ``drivers/prefill.py``'s; what differs is the configuration
and the check.  The port's configuration is resolved first, before any
weight is made (``port_config``: the registered configuration with the
sizes of ``model``, its share of the experts among them), so a program
that does not have it fails at once.  The check holds each kept batch to
the reference layer by layer:

- ``kv_err``: the worst attention layer's ||k or v - ref|| / ||ref||;
- ``state_err``: the worst mixer's final ``ssm`` state, ||h - ref|| /
  ||ref||;
- ``logit_err``: the last-position logits, the same;
- ``token_gap``: as the prefill cells' (not compared).

The traced segment hands the readers a record of kind ``prefill`` whose
``work`` carries the unit's FLOPs (``work_hybrid.prefill_flops``) and the
kernels' per-call work (flash's ``work.flash_work``, the scan's
``work_hybrid.ssd_work``), and the device seconds under the scopes the
traffic names; its segments are held to both kernels' launch counters.
The MoE's dispatch counts are reset before it, so that they cover the
traced segment alone.

Traffic parameters as ``drivers/prefill.py``'s (``profiler`` must be
``none``), and ``ssm_chunk`` (the scan's chunk, ``ModelOptions``) and
``scopes``.  ``calibrate`` takes the readings the limits are set from
(``hpcbench/calibrate_hybrid.py``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from hpcbench import harness, trace as trace_mod
from hpcbench.drivers.prefill import WARM_INDEX, Reservoir
from hpcbench.reference import compare, work, work_hybrid
from hpcbench.reference.data import ZipfTokens

# the model description's keys that are fields of the port's
# configuration under the same name
SAME = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab", "dtype", "ssm_state", "mamba_heads", "mamba_head_dim",
        "shared_ff", "embedding_multiplier",
        "residual_multiplier", "attention_multiplier", "logits_scaling")


def port_config(model: dict, port_name: str):
    """The port's registered configuration with the sizes of ``model``
    and its share of the experts; raises where the port lacks it or would
    run something else than the reference models."""
    from repro_torch.configs import get_config
    cfg = get_config(port_name)
    moe = model["moe"]
    repl = {k: model[k] for k in SAME}
    repl.update(
        block_pattern=tuple(model["block_pattern"]),
        norm_eps=model["rms_norm_eps"], use_rope=False,
        tie_embeddings=bool(model["tie_word_embeddings"]),
        experts_held=moe["held"],
        moe=dataclasses.replace(cfg.moe, n_experts=moe["n_experts"],
                                top_k=moe["top_k"],
                                capacity_factor=moe["capacity_factor"]))
    cfg = dataclasses.replace(cfg, **repl)
    bad = [k for k, v in {"window": cfg.window != 0, "qk_norm": cfg.qk_norm,
                          "qkv_bias": cfg.qkv_bias,
                          "conv_width": model["conv_width"] != 4,
                          "mamba_groups": model["mamba_groups"] != 1,
                          "shared_expert": not cfg.moe.shared_expert,
                          "experts_first": moe.get("first", 0) != 0,
                          "moe_every": cfg.moe.moe_every != 1}.items() if v]
    if bad:
        raise ValueError(f"{port_name}: the reference does not model {bad}")
    return cfg


def numbers(ref, params, m: dict, tokens, logits, cache, nx) -> dict:
    """The compared numbers of one batch: the program's ``logits`` and
    ``cache`` for ``tokens`` against the reference run beside them."""
    period = len(m["block_pattern"])
    worst = {"kv_err": 0.0, "state_err": 0.0}

    def on_layer(i, kind, state):
        c = cache[f"e{i % period}"]
        p = i // period
        if kind == "mamba":
            worst["state_err"] = max(worst["state_err"],
                                     compare.rel_err(c["ssm"][p], state))
        else:
            worst["kv_err"] = max(worst["kv_err"],
                                  compare.rel_err(c["k"][p], state[0]),
                                  compare.rel_err(c["v"][p], state[1]))
    want = ref.prefill(params, m, tokens, nx, on_layer)
    bad = not bool(torch.isfinite(logits).all())
    served = logits.float().argmax(-1)
    gap = float((want.max(-1).values
                 - want.gather(-1, served[:, None])[:, 0]).max())
    return dict(worst, logit_err=float("inf") if bad
                else compare.rel_err(logits, want),
                token_gap=float("inf") if bad else gap)


def _setup(cell, device):
    """(cfg, model, traffic, reference, prefill step): the configuration
    resolved before anything else."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    t, m = cell.traffic, cell.config["model"]
    cfg = port_config(m, cell.config["port_config"])
    if t["profiler"] != "none":
        raise ValueError("prefill_hybrid: cells run with no profiler")
    S = t["prompt_len"]
    opts = T.ModelOptions(q_chunk=min(256, S), kv_chunk=min(256, S),
                          ssm_chunk=min(t["ssm_chunk"], S))
    return cfg, m, t, harness.reference_module(cell), \
        steps_mod.make_prefill_step(cfg, opts)


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod

    cfg, m, t, ref, prefill_fn = _setup(cell, device)
    B, S = t["batch"], t["prompt_len"]
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # --- set-up: weights, warm-up -----------------------------------------
    params = ref.make_params(m, seed, device)
    zipf = ZipfTokens(m["vocab"], device)
    warm = {"tokens": zipf.draw(seed, WARM_INDEX, B, S)}
    for _ in range(2):
        logits, cache = prefill_fn(params, warm)
        sync()
    del logits, cache, warm
    keep = Reservoir(t["check_batches"], seed)
    ttft, finite = [], []

    def one(i: int) -> tuple:
        toks = zipf.draw(seed, i, B, S)
        t_issue = time.perf_counter()
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

    # --- a traced segment after the window (``--trace 1``) ----------------
    tracer = None
    if trace:
        moe_mod.reset_dispatch_counts()
        tracer = trace_mod.Segments(
            t["trace_units"], t["trace_attempts"],
            [(k["records"], lambda k=k: getattr(ops, k["launches"])
              .launches) for k in t["kernels"]],
            os.path.join(tempfile.gettempdir(), "hpcbench-trace",
                         cell.name), sync, scopes=t.get("scopes", ()))
        tracer.take(one, n)

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int(sum(int((~f).sum()) for f in finite))
    metrics: dict = {}
    breakdown = None
    notes = []
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
        rec = {"kind": "prefill", "trace": seg, "counters": {}, "spans": {},
               "window": {"units": n, "seconds": window_s},
               "work": {"unit_flops": work_hybrid.prefill_flops(m, B, S),
                        "kernels": {
                            "flash_fwd_kernel": work.flash_work(
                                B, S, m["n_heads"], m["n_kv_heads"],
                                m["head_dim"]),
                            "ssd_chunk_out_kernel": work_hybrid.ssd_work(
                                B, S, m["mamba_heads"], m["mamba_head_dim"],
                                m["ssm_state"])}}}
        metrics = harness.read_metrics(cell, rec)
        dev_line.update(busy_s=seg["busy_s"], window_s=seg["window_s"])
        breakdown = {"device_ops": seg["device_ops"],
                     "idle_gaps": seg["idle_gaps"], "scopes": seg["scopes"]}
        notes.append(f"traced segment: {seg['units']} batches, launches "
                     f"{seg['launches']}, records {seg['records']}, costs "
                     f"{seg['costs']}, retaken {len(tracer.rejected)}: "
                     f"{tracer.rejected}; MoE {moe_mod.dispatch_counts()}")
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
        nums.append(numbers(ref, params, m, toks, logits, cache,
                            ref.Numerics()))
    del kept
    ok, shown = compare.judge(compare.worst(nums), cell.limits["numbers"])
    notes.append(f"numbers by batch: {nums}")
    return {"correct": ok and failed == 0 and n > 0, "attempted": n * B,
            "failed": failed, "metrics": metrics, "device": dev_line,
            "breakdown": breakdown, "shown": shown, "notes": notes}


def calibrate(cell, seeds, control: int, device, emit) -> None:
    """``calibrate.py``'s protocol for this driver: for each seed the
    program's numbers on its first batch; for the first ``control`` seeds
    the reference in float8 (``Fp8``) in the program's place.  ``emit``
    takes each reading's keywords."""
    cfg, m, t, ref, prefill_fn = _setup(cell, device)
    ref.precise()
    B, S = t["batch"], t["prompt_len"]
    zipf = ZipfTokens(m["vocab"], device)
    period = len(m["block_pattern"])
    for j, seed in enumerate(seeds):
        t0 = time.monotonic()
        params = ref.make_params(m, seed, device)
        toks = zipf.draw(seed, 0, B, S)
        logits, cache = prefill_fn(params, {"tokens": toks})
        nums = numbers(ref, params, m, toks, logits, cache, ref.Numerics())
        del logits, cache
        emit(seed=seed, side="program", numbers=nums,
             seconds=time.monotonic() - t0)
        if j < control:
            got: dict = {}

            def keep(i, kind, state):
                got[i] = state
            lg = ref.prefill(params, m, toks, ref.Fp8(), keep)
            # the control's states laid out as the program's cache
            fake = {}
            for i, state in got.items():
                e = fake.setdefault(f"e{i % period}", {})
                if isinstance(state, tuple):
                    e.setdefault("k", []).append(state[0])
                    e.setdefault("v", []).append(state[1])
                else:
                    e.setdefault("ssm", []).append(state)
            del got
            nums = numbers(ref, params, m, toks, lg, fake, ref.Numerics())
            del fake, lg
            emit(seed=seed, side="control_fp8", numbers=nums)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
