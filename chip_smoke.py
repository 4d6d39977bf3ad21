"""Drive the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. refuse to run without CUDA; print the card's name and power limit;
2. build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
   (one nvcc per source, in parallel) and print the build seconds;
3. hold each kernel, through the wrapper the main path calls, against its
   plain torch version on the card, in bf16, at the tolerance of the JAX
   package's kernel tests (rtol = atol = 2e-2) and with each output row
   within 2e-2 of its largest reference value;
4. time each kernel, its plain version and one library call computing the
   same function (a yardstick the port never calls), beside the least time
   the card could take for the same work;
5. serve qwen2-1.5b at full width and depth with seeded random weights
   through ``repro_torch.launch.serve.serve`` under the port's profiler,
   with every kernel launch counter set to 0 just before and read just
   after; check token shape, launch counts and profile files, and read the
   prefill/decode latencies back from the profile;
6. check the output: replay every request batch outside ``serve``
   (same tokens, every logit finite), and hold a 2-layer full-width model on
   the card against the same bf16 weights run on the CPU through the
   plain versions.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
TOL = dict(rtol=2e-2, atol=2e-2)
ROW_TOL = 2e-2   # per row: max abs error over max |reference|
# main-path shapes: qwen2-1.5b, batch 4, prompt 512, 32 generated tokens
B, S, H, HKV, D = 4, 512, 12, 2, 128
N_REQUESTS, GEN_LEN = 8, 32
SMAX = S + GEN_LEN


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def build_kernels() -> float:
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.build(["flash_attention", "decode_attention"])
    return time.monotonic() - t0


def _randn(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _err(out, want) -> tuple:
    """Hold ``out`` against ``want`` elementwise at TOL, and each row (the
    last axis) at ROW_TOL of that row's largest |want|.  Attention over a
    long, flat softmax gives outputs far below TOL's atol, so the row check
    is what catches a wrong split merge there.  Returns (max abs error,
    largest row ratio)."""
    out, want = out.float(), want.float()
    torch.testing.assert_close(out, want, **TOL)
    err = (out - want).abs().amax(-1)
    ratio = float((err / want.abs().amax(-1).clamp_min(1e-30)).max())
    if ratio > ROW_TOL:
        raise AssertionError(f"a row's max abs error is {ratio:.4f} of its "
                             f"largest value (limit {ROW_TOL})")
    return float(err.max()), ratio


def check_kernels() -> tuple:
    """Each kernel, through the wrapper the main path calls, against its
    plain version.  Returns ({kernel: max abs error}, {kernel: largest
    row ratio}) over all cases."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"flash_attention": 0.0, "flash_decode": 0.0}
    ratios = dict(errs)

    def note(name, out, want):
        torch.cuda.synchronize()
        e, r = _err(out, want)
        errs[name] = max(errs[name], e)
        ratios[name] = max(ratios[name], r)

    # (B, S, Sk, H, Hkv, window, q_offset, q scale): the main path, the
    # main path with a peaked softmax, a window, a top-left q_offset, and
    # a ragged tail.  ops.flash_attention has no q_offset (the main path
    # never shifts q), so that case calls the launcher itself.
    for b, s, sk, h, hkv, window, q_off, q_scale in [
            (B, S, S, H, HKV, 0, 0, 1.0), (B, S, S, H, HKV, 0, 0, 4.0),
            (B, S, S, H, HKV, 128, 0, 1.0), (2, 256, 512, H, HKV, 0, 256, 1.0),
            (1, 300, 300, 8, 2, 0, 0, 1.0), (1, 300, 300, 8, 2, 64, 0, 1.0)]:
        q = _randn((b, s, h, D), gen, q_scale)
        k = _randn((b, sk, hkv, D), gen)
        v = _randn((b, sk, hkv, D), gen)
        kw = dict(causal=True, window=window)
        out = (ops.flash_attention(q, k, v, **kw) if q_off == 0 else
               fa.flash_attention_cuda(q, k, v, q_offset=q_off, **kw))
        note("flash_attention", out,
             fa.flash_attention_plain(q, k, v, q_offset=q_off, **kw))
    # decode: the JAX test's flat softmax (all inputs x0.5) and a peaked
    # one (scores of std 4), where a wrong split merge is large
    for smax in (SMAX, 4096):
        for q_scale, kv_scale in ((0.5, 0.5), (4.0, 1.0)):
            q = _randn((B, H, D), gen, q_scale)
            kc = _randn((B, smax, HKV, D), gen, kv_scale)
            vc = _randn((B, smax, HKV, D), gen, kv_scale)
            for length in (1, smax // 3, smax):
                note("flash_decode", ops.flash_decode(q, kc, vc, length),
                     fd.flash_decode_plain(q, kc, vc, length))
    # stale cache: what lies at or beyond `length` must not leak in
    q = _randn((1, 2, D), gen)
    kc = _randn((1, 256, 2, D), gen)
    vc = _randn((1, 256, 2, D), gen)
    kp, vp = kc.clone(), vc.clone()
    kp[:, 100:] = 1e9
    vp[:, 100:] = -1e9
    note("flash_decode", ops.flash_decode(q, kp, vp, 100),
         fd.flash_decode_plain(q, kc, vc, 100))
    return errs, ratios


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call (ms): the CUDA kernels' time under
    torch.profiler over ``iters`` calls after a warm-up, divided by
    ``iters``.  Host overhead between launches is not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / iters / 1e3


def call_ms(fn, iters: int = 20) -> float:
    """Wall time of one back-to-back call (ms) by CUDA events: the device
    time or the host's launch overhead, whichever is larger."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(flops: float, nbytes: float) -> tuple:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels() -> dict:
    """Kernel (through the main path's wrapper), plain version, library
    yardstick and bound at main-path shapes."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    res = {}
    q = _randn((B, S, H, D), gen)
    k = _randn((B, S, HKV, D), gen)
    v = _randn((B, S, HKV, D), gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = S * (S + 1) // 2            # causal (q, k) pairs per head
    flops = 4.0 * B * H * pairs * D     # QK^T and PV
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(flops, nbytes)
    fns = dict(ms=lambda: ops.flash_attention(q, k, v),
               plain_ms=lambda: fa.flash_attention_plain(q, k, v),
               library_ms=lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True))
    res["flash_attention"] = _timed(fns, bound_ms, bound_by)
    length = S + GEN_LEN // 2           # a mid-generation decode step
    qd = _randn((B, H, D), gen, 0.5)
    kc = _randn((B, SMAX, HKV, D), gen, 0.5)
    vc = _randn((B, SMAX, HKV, D), gen, 0.5)
    kl = kc[:, :length].transpose(1, 2)
    vl = vc[:, :length].transpose(1, 2)
    flops = 4.0 * B * H * length * D
    nbytes = 2.0 * (2 * qd.numel() + 2 * B * length * HKV * D)
    bound_ms, bound_by = _bound(flops, nbytes)
    fns = dict(ms=lambda: ops.flash_decode(qd, kc, vc, length),
               plain_ms=lambda: fd.flash_decode_plain(qd, kc, vc, length),
               library_ms=lambda: F.scaled_dot_product_attention(
                   qd[:, :, None], kl, vl, enable_gqa=True))
    res["flash_decode"] = _timed(fns, bound_ms, bound_by)
    return res


def _timed(fns: dict, bound_ms: float, bound_by: str) -> tuple:
    """({ms, plain_ms, library_ms: device ms, bound_ms, bound_by},
    {same keys: back-to-back call ms})."""
    dev = {k: device_ms(f) for k, f in fns.items()}
    calls = {k: call_ms(f) for k, f in fns.items()}
    return dict(dev, bound_ms=bound_ms, bound_by=bound_by), calls


def _profile_latencies(path: str) -> dict:
    """Mean device latency (ms) and invocations per dispatch placeholder
    of the GPU-stream profile."""
    from repro_torch.core.profmt import read_profile
    prof = read_profile(path)
    i_n = prof.metrics.index("gpu_kernel/invocations")
    i_t = prof.metrics.index("gpu_kernel/time_ns")
    out = {}
    for nid, frame in zip(prof.node_ids.tolist(), prof.frames):
        vals = prof.node_values(nid)
        if frame.name.startswith("kernel:") and i_n in vals:
            out[frame.name[len("kernel:"):]] = (
                vals[i_t] / vals[i_n] * 1e-6, int(vals[i_n]))
    return out


def run_serve(cfg, params) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    prof_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    ops.flash_attention.launches = 0
    ops.flash_decode.launches = 0
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=N_REQUESTS, batch=B, prompt_len=S,
                        gen_len=GEN_LEN, profile_dir=prof_dir,
                        device="cuda", params=params)
    wall = time.monotonic() - t0
    launches = {"flash_attention": ops.flash_attention.launches,
                "flash_decode": ops.flash_decode.launches}
    n_batches = -(-N_REQUESTS // B)
    want = {"flash_attention": cfg.n_layers * (n_batches + 1),
            "flash_decode": cfg.n_layers * ((GEN_LEN - 1) * n_batches + 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if tuple(toks.shape) != (N_REQUESTS, GEN_LEN):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if not paths or not all(os.path.getsize(p) > 0 for p in paths.values()):
        raise AssertionError(f"profile files missing: {paths}")
    lat = _profile_latencies(paths["gpu_0"])
    step_s = sum(ms * n for ms, n in lat.values()) * 1e-3
    return dict(tokens=toks, launches=launches, wall_s=wall,
                prefill_ms=lat["prefill"][0], decode_ms=lat["decode_step"][0],
                tok_per_s_in_steps=N_REQUESTS * GEN_LEN / step_s)


def check_replay(cfg, params, toks) -> None:
    """Every request batch again, outside serve, from the same prompts:
    every logit finite, the same tokens."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    opts = T.ModelOptions(q_chunk=256, kv_chunk=256)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    rng = np.random.default_rng(0)         # serve's prompt generator
    for bi in range(-(-N_REQUESTS // B)):
        prompts = rng.integers(0, cfg.vocab, (B, S), np.int32)
        logits, cache = prefill(
            params, {"tokens": torch.from_numpy(prompts).cuda().long()})
        cache = serve_mod._grow_cache(cache, SMAX, S)
        got = [logits.argmax(-1)]
        finite = [torch.isfinite(logits).all()]
        for t in range(GEN_LEN - 1):
            logits, cache = decode(params, cache, S + t, token=got[-1])
            finite.append(torch.isfinite(logits).all())
            got.append(logits.argmax(-1))
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"batch {bi}: non-finite logits")
        want = toks[bi * B:(bi + 1) * B]
        if not torch.equal(torch.stack(got, 1)[:len(want)], want):
            raise AssertionError(f"batch {bi}: replay differs from serve")


def step_breakdown(cfg, params, n_decode: int = 8) -> dict:
    """Where a serving step's time goes, under torch.profiler: host wall
    time per step against the device's busy time (sum of CUDA kernel
    time), the idle share, the number of device kernels per step, and the
    kernels that take most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    opts = T.ModelOptions(q_chunk=256, kv_chunk=256)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.long, device="cuda")}
    out = {}
    for phase in ("prefill", "decode"):
        logits, cache = prefill(params, batch)
        cache = serve_mod._grow_cache(cache, SMAX, S)
        tok = logits.argmax(-1)
        n = 1 if phase == "prefill" else n_decode
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(n):
                if phase == "prefill":
                    prefill(params, batch)
                else:
                    decode(params, cache, S + t, token=tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in ka) / 1e3 / n
        top = sorted(ka, key=lambda e: -e.self_device_time_total)[:4]
        out[phase] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            kernels_per_step=sum(e.count for e in ka) / n,
            top_kernels=[(e.key[:48], e.self_device_time_total / 1e3 / n,
                          e.count // n) for e in top])
    return out


def check_against_cpu(cfg) -> float:
    """A 2-layer model at full width: kernels on the card against the same
    bf16 weights on the CPU through the plain versions, prefill plus 4
    teacher-forced decode steps.  Both sides round to bf16 at the same
    points and differ by accumulation order (and the decode kernel's fp32
    p) only, a few bf16 ulps at the logits' scale; so the max abs logit
    error is held to 2e-2 of the largest reference logit, per step.

    The seeded init takes wq/wk's fan-in from the head axis, as the JAX
    package does, which at this width gives raw attention scores of std
    about 128: a one-hot softmax whose winner flips under any rounding.
    wq and wk are scaled by 1/8 here so that scores are of unit scale and
    the comparison measures the kernels, not near-ties.  Returns the
    largest error ratio."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as T
    small = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    p_gpu = T.init_params(gen, small)
    for attn in (e["attn"] for e in p_gpu["layers"].values()):
        attn["wq"].mul_(0.125)
        attn["wk"].mul_(0.125)
    p_cpu = _tree(p_gpu, lambda x: x.cpu())
    opts = T.ModelOptions(q_chunk=64, kv_chunk=64)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 64), np.int64))
    worst = 0.0
    with torch.no_grad():
        lg, cg = T.prefill(p_gpu, small, toks.cuda(), opts=opts)
        lc, cc = T.prefill(p_cpu, small, toks, opts=opts)
        cg = serve_mod._grow_cache(cg, 72, 64)
        cc = serve_mod._grow_cache(cc, 72, 64)
        for t in range(5):
            if not torch.isfinite(lg).all():
                raise AssertionError(f"step {t}: non-finite logits")
            rel = float((lg.cpu() - lc).abs().max() / lc.abs().max())
            if rel > 2e-2:
                raise AssertionError(f"step {t}: max abs logit error is "
                                     f"{rel:.4f} of the largest logit")
            worst = max(worst, rel)
            if t == 4:
                break
            nxt = lg.argmax(-1)
            lg, cg = T.decode_step(p_gpu, small, cg, token=nxt, pos=64 + t,
                                   opts=opts)
            lc, cc = T.decode_step(p_cpu, small, cc, token=nxt.cpu(),
                                   pos=64 + t, opts=opts)
    return worst


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"build_s: {build_kernels():.1f}", flush=True)
    errs, ratios = check_kernels()
    print(f"kernel checks passed: max abs err {errs}, largest row "
          f"err / row max {ratios}", flush=True)

    cfg = get_config("qwen2-1.5b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    srv = run_serve(cfg, params)
    print(f"serve qwen2-1.5b: {N_REQUESTS} requests x {GEN_LEN} tokens, "
          f"batch {B}, prompt {S}: wall {srv['wall_s']:.2f} s (incl. warm-up),"
          f" prefill {srv['prefill_ms']:.3f} ms/batch, decode "
          f"{srv['decode_ms']:.3f} ms/step, "
          f"{srv['tok_per_s_in_steps']:.1f} tok/s over measured steps",
          flush=True)
    check_replay(cfg, params, srv["tokens"])
    # everything under torch.profiler comes after serve, whose latencies
    # it would otherwise inflate
    times = time_kernels()
    for name, (t, calls) in times.items():
        print(f"{name}: device {json.dumps(t)}; back-to-back call "
              f"{json.dumps(calls)}", flush=True)
    print(f"step breakdown: {json.dumps(step_breakdown(cfg, params))}",
          flush=True)
    print(f"2-layer full-width vs CPU bf16 plain: max abs logit err / "
          f"max abs logit "
          f"{check_against_cpu(cfg):.4f}", flush=True)

    src = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:36"),
           "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:30")}
    kernels = [dict(name=n, route="cuda", source=src[n][0],
                    replaces=src[n][1], launches=srv["launches"][n],
                    max_abs_err=errs[n], **times[n][0]) for n in src]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
