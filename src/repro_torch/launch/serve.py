"""Batched serving driver: prefill + decode with the measurement stack
attached.

Serving shape: a queue of synthetic requests is served in fixed-size
batches.  Prefill runs per request batch; decode steps run against the
batch's KV cache.  Every device-side step goes through
``Profiler.dispatch`` and ends in ``torch.cuda.synchronize()`` inside the
dispatch, so the profile's kernel times are device times.  Prompts come
from the same ``numpy`` generator calls as the JAX package's driver, so
both packages serve identical requests for one seed.

With a profile directory, the warm-up also registers both steps as the
profiler's "GPU binaries" before measurement starts: each step is
exported (``core.export``), the kernels' interiors recovered from their
CUDA source at the path's shapes (``kernels.kernel_structures``) are
bound to its ``custom-call`` ops, and every dispatch then draws PC
samples over the step's ops that descend into the kernels.

With ``serving=`` (the always-on ``serving.ServingProfiler``, started by
the caller) the steps are registered the same way on its profiler, which
is already running: the interiors are bound into each exported module
before ``register_structure`` publishes the module's id, so the monitor
thread's op-context cache never holds an entry of that id unbound.  Each
prefill and decode dispatch then runs inside a per-request, per-phase
window (``request:<id>``, ``phase:<prefill|decode>``) that feeds the
serving stats, the overhead governor and telemetry.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
from repro_torch.serving.window import DECODE, PREFILL


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _maybe_window(serving, rid: str, phase: str, tokens: int):
    if serving is None:
        return contextlib.nullcontext()
    return serving.request(rid, phase, tokens=tokens)


def serve(cfg: ModelConfig, *, n_requests: int = 8, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 16, seed: int = 0,
          profile_dir: Optional[str] = None, redundant_sync: bool = False,
          opts: Optional[T.ModelOptions] = None, serving=None,
          rid_prefix: str = "", device="cuda", params=None,
          counters: Optional[Sequence[str]] = None):
    """Returns (generated tokens (n_requests, gen_len) int64 on ``device``,
    profile paths; with a profile directory, ``paths["measurement"]`` is a
    JSON file of each registered step's op count, custom-calls, export
    seconds and cost under ``steps``, and the profiler's own overhead
    counters under ``profiler``).

    ``params`` takes a parameter tree (e.g. from ``convert.params_from_jax``)
    instead of the seeded initialisation.  ``serving`` takes a started
    ``repro_torch.serving.ServingProfiler``: every dispatch then runs
    through its profiler inside per-request/per-phase windows (``r<lo>`` /
    ``r<lo>-r<hi>`` for a batch, prefixed by ``rid_prefix``), and the
    caller owns its lifecycle and output; the paths returned are None and
    the steps' op counts and export seconds go to ``measurement.json`` in
    its profiler's directory (the last call's).  Mutually exclusive with
    ``profile_dir``.  ``counters`` (with a profile directory) turns on the
    profiler's hardware-counter collection for these counter names.
    """
    if serving is not None and profile_dir:
        raise ValueError("pass either serving= or profile_dir=, not both")
    dev = resolve_device(device)
    opts = opts or T.ModelOptions(q_chunk=min(256, prompt_len),
                                  kv_chunk=min(256, prompt_len),
                                  ssm_chunk=min(64, prompt_len))
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = T.init_params(gen, cfg)
    max_len = prompt_len + gen_len

    prefill_fn = steps_mod.make_prefill_step(cfg, opts)
    decode_fn = steps_mod.make_decode_step(cfg, opts)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    prof = serving.profiler if serving is not None else None
    if profile_dir:
        from repro_torch.core.profiler import Profiler
        prof = Profiler(profile_dir, tracing=True, rng_seed=seed)
        if counters:
            prof.enable_counters(counters)

    # --- warm-up: build and load the kernels and run both steps once
    # before the measured loop, so the first batch's dispatch does not
    # carry the kernel build
    warm_in = {"tokens": torch.zeros((batch, prompt_len), dtype=torch.long,
                                     device=dev)}
    logits, cache = prefill_fn(params, warm_in)
    cache = _grow_cache(cache, max_len, prompt_len)
    tok = logits.argmax(-1)
    decode_fn(params, cache, prompt_len, token=tok)
    sync()
    mid_p = mid_d = None
    structure = {}
    if prof is not None:
        # register both steps, each with the kernels' interiors bound
        # before its id is published (the op-context cache belongs to the
        # monitor thread of a running profiler).  decode's structure does
        # not depend on pos.
        mid_p, mid_d, structure = register_steps(
            prof, cfg, opts, params, warm_in, cache, tok, batch, prompt_len,
            max_len, prefill_fn, decode_fn)
        if serving is None:
            prof.start()

    rng = np.random.default_rng(seed)
    outs = []
    n_batches = (n_requests + batch - 1) // batch
    for bi in range(n_batches):
        lo, hi = bi * batch, min(bi * batch + batch, n_requests)
        rid = f"{rid_prefix}r{lo}" if hi - lo <= 1 \
            else f"{rid_prefix}r{lo}-r{hi - 1}"
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, prompt_len), np.int32)
        ).to(dev, torch.long)
        batch_in = {"tokens": toks}
        # --- prefill ------------------------------------------------------
        with _maybe_window(serving, rid, PREFILL, batch * prompt_len):
            if prof is not None:
                with prof.dispatch("kernel", "prefill", stream=0,
                                   module_id=mid_p):
                    logits, cache = prefill_fn(params, batch_in)
                    sync()
            else:
                logits, cache = prefill_fn(params, batch_in)
        # cache is sized prompt_len by prefill; decode needs max_len slots
        cache = _grow_cache(cache, max_len, prompt_len)
        tok = logits.argmax(-1)
        gen = [tok]
        # --- decode -------------------------------------------------------
        for t in range(gen_len - 1):
            pos = prompt_len + t
            with _maybe_window(serving, rid, DECODE, batch):
                if prof is not None:
                    with prof.dispatch("kernel", "decode_step", stream=0,
                                       module_id=mid_d):
                        logits, cache = decode_fn(params, cache, pos,
                                                  token=tok)
                        sync()
                    if redundant_sync:
                        # a sync with no kernel between it and the
                        # previous sync, found by diff = sync - kernels
                        with prof.dispatch("sync", "device_sync", stream=0):
                            sync()
                        with prof.dispatch("sync", "device_sync", stream=0):
                            sync()
                else:
                    logits, cache = decode_fn(params, cache, pos, token=tok)
            tok = logits.argmax(-1)
            gen.append(tok)
        outs.append(torch.stack(gen, dim=1))
    paths = None
    if prof is not None:
        if serving is None:
            prof.flush()
            paths = prof.write()
            prof.stop()
        measurement = os.path.join(prof.out_dir, "measurement.json")
        with open(measurement, "w") as f:
            json.dump({"steps": structure,
                       "profiler": prof.overhead_counters(),
                       "clock_anchor": prof.clock_anchor}, f, indent=1,
                      sort_keys=True)
        if paths is not None:
            paths["measurement"] = measurement
    return torch.cat(outs, dim=0)[:n_requests], paths


def register_steps(prof, cfg: ModelConfig, opts: T.ModelOptions, params,
                   batch_in, cache, token, batch: int, prompt_len: int,
                   max_len: int, prefill_fn, decode_fn) -> tuple:
    """Export the prefill and decode steps at these inputs, bind the
    kernels' interiors at the path's shapes to their ``custom-call`` ops
    (the MoE combine's at each step's own, ``kernels.graph_structures``)
    and register both modules with ``prof`` (with their cost).  Returns
    (prefill module id, decode module id, {step: op count, custom-calls
    bound, export and registration seconds, cost})."""
    from repro_torch.core import export
    from repro_torch.kernels import graph_structures, kernel_structures
    structures = kernel_structures(cfg, batch, prompt_len, max_len,
                                   ssm_chunk=opts.ssm_chunk)
    steps = (("prefill", prefill_fn, (params, batch_in), {}),
             ("decode_step", decode_fn, (params, cache, prompt_len),
              {"token": token}))
    mids, info = [], {}
    for name, fn, args, kwargs in steps:
        t0 = time.perf_counter()
        program = export.export_step(fn, args, kwargs)
        module = export.module_from_export(name, program)
        combine = tuple(ks for ks in graph_structures(program.graph_module)
                        if ks.name == "moe_combine")
        bound = sum(module.bind_kernel_structure(ks)
                    for ks in structures + combine)
        cost = export.cost(module)
        mids.append(prof.register_structure(name, module, cost))
        info[name] = dict(ops=len(module.all_ops()), custom_calls=bound,
                          seconds=time.perf_counter() - t0, **cost)
    return mids[0], mids[1], info


def _grow_cache(cache, max_len: int, cur_len: int):
    """Pad prefill KV caches out to max_len slots (attention layers only).
    As in the JAX package's ``serve``, the rule is by name and shape: a ``k``/``v`` of
    ``cur_len`` slots grows, so a window ring shorter than the prompt and
    the ``ssm``/``conv`` states stay as they are, while a ring whose
    window is at least the prompt grows to ``max_len`` (and decode then
    attends to every position, as the reference does)."""
    def grow(name, leaf):
        if name in ("k", "v") and leaf.dim() == 5 and \
                leaf.shape[2] == cur_len:
            out = torch.zeros(leaf.shape[:2] + (max_len,) + leaf.shape[3:],
                              dtype=leaf.dtype, device=leaf.device)
            out[:, :, :cur_len] = leaf
            return out
        return leaf
    return {e: {name: grow(name, leaf) for name, leaf in c.items()}
            for e, c in cache.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=args.requests, batch=args.batch,
                        prompt_len=args.prompt_len, gen_len=args.gen_len,
                        profile_dir=args.profile_dir, device=args.device)
    dt = time.monotonic() - t0
    n_tok = toks.shape[0] * toks.shape[1]
    print(f"served {toks.shape[0]} requests x {toks.shape[1]} tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    if paths:
        print("profiles:", sorted(paths)[:4], "...")


if __name__ == "__main__":
    main()
