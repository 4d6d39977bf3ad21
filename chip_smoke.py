"""Drive the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. refuse to run without CUDA; print the card's name and power limit;
2. build every CUDA kernel of the serving paths from ``src/repro_torch/csrc``
   (one nvcc per source, in parallel) and print the build seconds and each
   kernel's registers, shared memory and spills as ptxas reports them;
   ground the kernel structures recovered from the CUDA source in the
   binaries: every dot_general leaf's line has a SASS instruction in the
   built library's line table (``cuobjdump -xelf all``, ``nvdisasm -gi``);
3. hold each kernel, through the wrapper the main paths call, against its
   plain torch version on the card, in bf16, at the tolerance of the JAX
   package's kernel tests (rtol = atol = 2e-2; the SSD scan's final state
   at 1e-2) and with each output row within 2e-2 of its largest
   reference value, at the three attention paths' shapes (qwen2, hymba,
   granite-moe at D = 64, G = 2) and at each kernel's edges (ragged tiles
   and splits, small windows, q_offset, G = 1 and 8, peaked scores);
   every decode call is repeated and must be bitwise equal, and must run
   exactly one device kernel under torch.profiler; every SSD call
   likewise, with its three device kernels (chunk state, state pass,
   chunk output), at 10 cases including a partial group of heads, 25
   chunks with a ragged tail and unpadded X rows; hold the gradients of
   the two differentiable wrappers (the kernel forward, the plain
   recompute backward) against the plain versions' autograd at the
   training shapes and windowed, ragged edges, and show under
   torch.profiler that the forward runs the port's kernel and the
   backward none;
4. time a train step of qwen2-1.5b and hymba-1.5b at full width and
   depth under torch.profiler (host wall, device busy, idle share,
   tokens/s, the kernels' share) on a repeated batch whose loss must
   fall, and each kernel at the training shapes; time each kernel at
   each serving path's shapes, its plain version and one
   library call computing the same function where there is one (a
   yardstick the port never calls), beside the least time the card could
   take for the same work (the kernel modules' own ``work`` counts), and
   the decode kernel at every split count the planner could choose, and
   the SSD scan's device time by step; break a serving step's time down
   by device kernel.  All of this runs under torch.profiler, for all four
   models, before the first profiled serve (see ``time_path``);
5. serve qwen2-1.5b and then hymba-1.5b at full width and depth with
   seeded random weights through ``repro_torch.launch.serve.serve`` under
   the port's profiler, with every kernel launch counter set to 0 just
   before each and read just after; check token shape, launch counts and
   profile files, and read the prefill/decode latencies back from the
   profile; aggregate the profiles with the port's ``aggregate`` into a
   database under ``chiprun_out/chip_smoke_db``, check PC samples under
   both step placeholders and samples that reach a dot_general leaf of
   every kernel's own .cu file, and print the top-down view; serve the
   same requests without a profile directory before and after, for the
   profiler's overhead; serve 2 layers with hardware counters on and
   check every counter column;
6. check the output of each: replay every request batch outside ``serve``
   (same tokens, every logit finite), and hold a 2-layer full-width model
   on the card against the same bf16 weights run on the CPU through the
   plain versions;
7. serve granite-moe-1b-a400m (MoE, 32 experts top 8; both attention
   kernels) and xlstm-125m (mLSTM + sLSTM; no kernel: the JAX package has
   none for it) at full width and depth under the always-on serving
   profiler (``serve(serving=...)``, the governor at budget 0.5), launch
   counters set to 0 just before and read just after; check launches,
   every request batch's GPU time in both phases from the aggregated
   database and PC samples in both attention kernels' interiors; print
   the governor's final level and the serve wall over that without a
   profiler; replay and the 2-layer CPU check as in 6 (profiles and
   databases under ``build/chip_smoke``);
8. run the port's six-scenario serving sweep (``serving.sweep``) on the
   card and check every row's per-request attribution;
9. train qwen2-1.5b (6 steps of 4 x 512, under the port's profiler) and
   hymba-1.5b (3 steps of 2 x 1536) at full width and depth through
   ``repro_torch.launch.train.train``, launch counters set to 0 just
   before and read just after each: the launch counts the remat policy
   implies, finite losses, one custom-call per launch in the registered
   train step, PC samples under its placeholder and in the flash
   kernel's dot_general leaves; one 2-layer full-width train step (loss
   and every gradient leaf) against the same bf16 weights on the CPU;
   a resume from an async checkpoint whose first loss is bitwise the
   uninterrupted run's.

The line before the last is a JSON object with one entry per kernel and
path; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=2e-2, atol=2e-2)
STATE_TOL = dict(rtol=1e-2, atol=1e-2)   # SSD final state, tests/test_kernels.py
ROW_TOL = 2e-2   # per row: max abs error over max |reference|
SSM_STEPS = 3    # device kernels per SSD scan: state, state pass, output
PORT_KERNEL = re.compile(
    r"flash_fwd_kernel|flash_decode_kernel|ssd_\w+_kernel")
B, N_REQUESTS, GEN_LEN = 4, 8, 32
# each serving path: its prompt, and the 2-layer CPU check's prompt and
# window (hymba's reduced so that the ring wraps and the CPU side stays
# small).  hymba's prompt of 1536 > window 1024 keeps the ring at 1024
# slots through decode and puts a roll of 1536 % 1024 = 512 on the path.
PATHS = {"qwen2-1.5b": dict(prompt=512, cpu_prompt=64, cpu_window=0),
         "hymba-1.5b": dict(prompt=1536, cpu_prompt=192, cpu_window=128)}
# the paths served under the always-on serving profiler (governor at the
# sweep's budget): granite-moe runs both attention kernels at D = 64,
# G = 2; xlstm runs none (the JAX package has no mLSTM kernel), and its
# 2-layer CPU check keeps one layer of each block kind.  xlstm's prompt
# is cut from 512 to 96: torch.export unrolls the sLSTM's time loop
# (about 74 ops a token), and on the card's host the prefill step's
# export took 235.6 s at 512 (38,931 ops) and 56.9-63.8 s at 112 (9471)
SERVING_PATHS = {
    "granite-moe-1b-a400m": dict(prompt=512, cpu_prompt=64, cpu_window=0),
    "xlstm-125m": dict(prompt=96, cpu_prompt=64, cpu_window=0,
                       cpu_blocks=("mlstm", "slstm"))}
# where the serving paths and the sweep write their profiles and
# databases (tens of MB a model)
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
BUDGET = 0.5     # the serving sweep's overhead budget
KERNELS = ("flash_attention", "flash_decode", "ssm_scan")
COUNTERS = ("flops", "mxu_flops", "hbm_bytes", "inst_executed", "active_ns",
            "elapsed_ns")
SOURCES = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:36"),
           "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:30"),
           "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan.py:34")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def build_kernels() -> tuple:
    """Build every kernel; returns (seconds, ptxas's lines: each kernel's
    registers, shared memory and spills)."""
    from repro_torch.kernels import build
    t0 = time.monotonic()
    build.build(["flash_attention", "decode_attention", "ssm_scan"])
    seconds = time.monotonic() - t0
    lines = []
    for name, text in build.PTXAS.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ("Used" in line or "spill" in line):
                lines.append(f"{name}: {entry}: "
                             f"{line.split('info    :')[-1].strip()}")
    return seconds, lines


def _randn(shape, gen, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def _err(out, want, tol=TOL, rows=True) -> tuple:
    """Hold ``out`` against ``want`` elementwise at ``tol`` and, with
    ``rows``, each row (the last axis) at ROW_TOL of that row's largest
    |want|.  Attention over a long, flat softmax gives outputs far below
    TOL's atol, so the row check is what catches a wrong split merge
    there.  Returns (max abs error, largest row ratio)."""
    out, want = out.float(), want.float()
    torch.testing.assert_close(out, want, **tol)
    err = (out - want).abs().amax(-1)
    ratio = float((err / want.abs().amax(-1).clamp_min(1e-30)).max())
    if rows and ratio > ROW_TOL:
        raise AssertionError(f"a row's max abs error is {ratio:.4f} of its "
                             f"largest value (limit {ROW_TOL})")
    return float(err.max()), ratio


def _ssm_inputs(gen, b, s, nh, hd, st, decay=None, with_h0=False):
    """The JAX kernel tests' draws: xv N*0.5, logdecay -softplus(N) (or
    the constant ``decay``), B/C N*0.3, h0 N*0.1 (fp32)."""
    xv = _randn((b, s, nh, hd), gen, 0.5)
    ld = -F.softplus(torch.randn((b, s, nh), generator=gen, device="cuda"))
    if decay is not None:
        ld = torch.full_like(ld, decay)
    Bm = _randn((b, s, st), gen, 0.3)
    Cm = _randn((b, s, st), gen, 0.3)
    h0 = _randn((b, nh, hd, st), gen, 0.1, torch.float32) if with_h0 \
        else None
    return xv, ld, Bm, Cm, h0


def check_kernels() -> tuple:
    """Each kernel, through the wrapper the main paths call, against its
    plain version.  Returns ({kernel: max abs error}, {kernel: largest
    row ratio}) over all cases."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {k: 0.0 for k in KERNELS}
    ratios = dict(errs)

    def note(name, out, want, **kw):
        torch.cuda.synchronize()
        e, r = _err(out, want, **kw)
        errs[name] = max(errs[name], e)
        ratios[name] = max(ratios[name], r)

    # (B, S, Sk, H, Hkv, D, window, q_offset, q scale): qwen2's main path,
    # the same with a peaked softmax, a window, a top-left q_offset, ragged
    # tails; hymba's main path with its window and without.
    # ops.flash_attention has no q_offset (the main paths never shift q),
    # so that case calls the launcher itself.
    for b, s, sk, h, hkv, d, window, q_off, q_scale in [
            (B, 512, 512, 12, 2, 128, 0, 0, 1.0),
            (B, 512, 512, 12, 2, 128, 0, 0, 4.0),
            (B, 512, 512, 12, 2, 128, 128, 0, 1.0),
            (2, 256, 512, 12, 2, 128, 0, 256, 1.0),
            (1, 300, 300, 8, 2, 128, 0, 0, 1.0),
            (1, 300, 300, 8, 2, 128, 64, 0, 1.0),
            (B, 1536, 1536, 25, 5, 64, 1024, 0, 1.0),
            (B, 1536, 1536, 25, 5, 64, 0, 0, 1.0),
            (1, 300, 300, 10, 2, 64, 64, 0, 4.0),
            # granite-moe's main path: D = 64, G = 2, causal, no window
            (B, 512, 512, 16, 8, 64, 0, 0, 1.0),
            (B, 512, 512, 16, 8, 64, 0, 0, 4.0),
            # the wgmma kernel's edges: S and Sk off its 64-row tiles, a
            # window under one kv tile, q_offset at D = 64, peaked scores
            (1, 200, 200, 4, 1, 64, 48, 0, 4.0),
            (2, 100, 356, 8, 2, 64, 0, 256, 1.0),
            (1, 130, 130, 12, 2, 128, 16, 0, 4.0),
            (2, 77, 333, 12, 2, 128, 40, 256, 4.0)]:
        q = _randn((b, s, h, d), gen, q_scale)
        k = _randn((b, sk, hkv, d), gen)
        v = _randn((b, sk, hkv, d), gen)
        kw = dict(causal=True, window=window)
        out = (ops.flash_attention(q, k, v, **kw) if q_off == 0 else
               fa.flash_attention_cuda(q, k, v, q_offset=q_off, **kw))
        note("flash_attention", out,
             fa.flash_attention_plain(q, k, v, q_offset=q_off, **kw))
    # decode: the JAX test's flat softmax (all inputs x0.5) and a peaked
    # one (scores of std 4), where a wrong split merge is large; qwen2's
    # cache and a long one at D=128 G=6, hymba's full ring at D=64 G=5,
    # granite-moe's cache at D=64 G=2
    for h, hkv, d, smax in ((12, 2, 128, 544), (12, 2, 128, 4096),
                            (25, 5, 64, 1024), (16, 8, 64, 544)):
        for q_scale, kv_scale in ((0.5, 0.5), (4.0, 1.0)):
            q = _randn((B, h, d), gen, q_scale)
            kc = _randn((B, smax, hkv, d), gen, kv_scale)
            vc = _randn((B, smax, hkv, d), gen, kv_scale)
            for length in (1, smax // 3, smax):
                note("flash_decode", ops.flash_decode(q, kc, vc, length),
                     fd.flash_decode_plain(q, kc, vc, length))
    # the one-launch cluster kernel's edges, each twice (bitwise equal):
    # lengths off 16/32/64 and 1, G = 1 and G = 8 at both head dims, flat
    # and peaked scores
    for h, hkv, d, smax, lengths in (
            (12, 2, 128, 544, (1, 17, 33, 100, 527)),
            (25, 5, 64, 1024, (1, 47, 1000)),
            (16, 8, 64, 544, (1, 33, 528)),
            (2, 2, 128, 300, (1, 31, 299)), (2, 2, 64, 300, (5, 129)),
            (16, 2, 128, 600, (1, 63, 600)), (16, 2, 64, 600, (9, 257))):
        for q_scale, kv_scale in ((0.5, 0.5), (4.0, 1.0)):
            q = _randn((B, h, d), gen, q_scale)
            kc = _randn((B, smax, hkv, d), gen, kv_scale)
            vc = _randn((B, smax, hkv, d), gen, kv_scale)
            for length in lengths:
                out = ops.flash_decode(q, kc, vc, length)
                again = ops.flash_decode(q, kc, vc, length)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"flash_decode not deterministic at "
                                         f"{(h, hkv, d, smax, length)}")
                note("flash_decode", out,
                     fd.flash_decode_plain(q, kc, vc, length))
    # a last split one key long (the planner never cuts one, so the
    # launcher is called with the splits): 8 x 64 keys over 449, 8 x 128
    # over 897
    for h, hkv, d, smax, length, splits in ((12, 2, 128, 544, 449, (8, 64)),
                                            (25, 5, 64, 1024, 897, (8, 128))):
        q = _randn((B, h, d), gen, 4.0)
        kc = _randn((B, smax, hkv, d), gen)
        vc = _randn((B, smax, hkv, d), gen)
        note("flash_decode", _decode_at(q, kc, vc, length, *splits),
             fd.flash_decode_plain(q, kc, vc, length))
    # stale cache: what lies at or beyond `length` must not leak in
    for d in (128, 64):
        q = _randn((1, 2, d), gen)
        kc = _randn((1, 256, 2, d), gen)
        vc = _randn((1, 256, 2, d), gen)
        kp, vp = kc.clone(), vc.clone()
        kp[:, 100:] = 1e9
        vp[:, 100:] = -1e9
        note("flash_decode", ops.flash_decode(q, kp, vp, 100),
             fd.flash_decode_plain(q, kc, vc, 100))
    # SSD scan (B, S, nh, hd, st, chunk, with h0, decay): hymba's main path
    # with and without h0, the JAX sweep (tests/test_kernels.py:93-97), a
    # ragged S, a strong decay whose unmasked exp would overflow, nh = 7
    # (not a multiple of the heads per block), 25 chunks with a ragged tail
    # of 40, and chunks of 225 at hd 120, st 50 (unpadded X rows in shared
    # memory, B/C rows not 16-byte aligned).  Every call is repeated and must
    # be bitwise equal; the launcher refuses a call whose plan's shared
    # memory is not where its kernels' carve-up ends, so every case also
    # holds the plan against the kernels.
    for b, s, nh, hd, st, chunk, with_h0, decay in [
            (B, 1536, 25, 64, 16, 64, False, None),
            (B, 1536, 25, 64, 16, 64, True, None),
            (1, 128, 2, 16, 16, 64, True, None),
            (2, 256, 4, 32, 16, 128, True, None),
            (1, 256, 1, 64, 32, 256, True, None),
            (2, 200, 3, 64, 16, 64, True, None),
            (2, 256, 4, 64, 16, 64, True, -20.0),
            (2, 256, 7, 64, 16, 64, True, None),
            (1, 1576, 25, 64, 16, 64, True, None),
            (1, 500, 2, 120, 50, 225, True, None)]:
        xv, ld, Bm, Cm, h0 = _ssm_inputs(gen, b, s, nh, hd, st, decay,
                                         with_h0)
        y, hf = ops.ssm_scan(xv, ld, Bm, Cm, h0, chunk)
        y2, hf2 = ops.ssm_scan(xv, ld, Bm, Cm, h0, chunk)
        yp, hp = ss.ssm_scan_plain(xv, ld, Bm, Cm, h0, chunk=chunk)
        torch.cuda.synchronize()
        case = (b, s, nh, hd, st, chunk, decay)
        if not (torch.isfinite(y).all() and torch.isfinite(hf).all()):
            raise AssertionError(f"ssm_scan: non-finite output at {case}")
        if not (torch.equal(y, y2) and torch.equal(hf, hf2)):
            raise AssertionError(f"ssm_scan not deterministic at {case}")
        note("ssm_scan", y, yp)
        _err(hf, hp, STATE_TOL, rows=False)
    if 7 % ss.plan(2, 256, 7, 64, 16, 64).heads_per_block == 0:
        raise AssertionError("ssm_scan: the nh = 7 case no longer leaves a "
                             "partial group of heads")
    # B whose rows are not 16-byte aligned is refused before any launch
    xv, ld, Bm, Cm, h0 = _ssm_inputs(gen, 1, 64, 2, 64, 16)
    Bm_off = torch.empty(Bm.numel() + 1, dtype=Bm.dtype,
                         device=Bm.device)[1:].view(Bm.shape)
    Bm_off.copy_(Bm)
    try:
        ops.ssm_scan(xv, ld, Bm_off, Cm, None, 64)
    except ValueError:
        pass
    else:
        raise AssertionError("ssm_scan took a B that is not 16-byte "
                             "aligned")
    # the SSD scan's three steps per call, at hymba's shape
    xv, ld, Bm, Cm, h0 = _ssm_inputs(gen, B, 1536, 25, 64, 16)
    distinct, per_call = device_kernels(
        lambda: ops.ssm_scan(xv, ld, Bm, Cm, None, 64))
    if distinct != SSM_STEPS or per_call > SSM_STEPS:
        raise AssertionError(f"ssm_scan ran {distinct} distinct device "
                             f"kernels, {per_call} per call; want "
                             f"{SSM_STEPS}")
    # one device kernel per decode call, at the three paths' shapes
    for h, hkv, d, smax in ((12, 2, 128, 544), (25, 5, 64, 1024),
                            (16, 8, 64, 544)):
        q = _randn((B, h, d), gen, 0.5)
        kc = _randn((B, smax, hkv, d), gen, 0.5)
        distinct, per_call = device_kernels(
            lambda: ops.flash_decode(q, kc, kc, smax - 7))
        if distinct != 1 or per_call > 1:
            raise AssertionError(f"flash_decode ran {distinct} distinct "
                                 f"device kernels, {per_call} per call; "
                                 f"want one")
    return errs, ratios


def device_kernels(fn, iters: int = 5, attempts: int = 3) -> tuple:
    """(distinct device kernels, launches per call) of ``fn`` under
    torch.profiler.  A process's first profiled windows can drop activity
    records (seen on an H100: all of them, or 1 of 5), never add any; so
    one window is profiled first and discarded, a window with no record
    is taken again, and the distinct kernel names are what a check should
    rest on (launches per call can only read low)."""
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.self_device_time_total > 0]

    window()
    for _ in range(attempts):
        kernels = window()
        if kernels:
            return len(kernels), sum(e.count for e in kernels) / iters
    raise RuntimeError("torch.profiler recorded no device kernel")


def device_ms_by_kernel(fn, iters: int = 20, attempts: int = 5) -> dict:
    """Device time of one call (ms) by device kernel name: each kernel's
    time under torch.profiler over ``iters`` calls after a warm-up,
    divided by ``iters``.  Host overhead between launches is not
    counted.  A window in which a kernel's launches are not a whole
    multiple of ``iters`` dropped records (torch.profiler does, on an
    "NVIDIA H100 80GB HBM3" at 700 W, once the port's profiler has drawn
    PC samples in the process: see ``time_path``) and is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        seen.append({e.key: e.count for e in ka})
        if ka and all(e.count % iters == 0 for e in ka):
            return {e.key: e.self_device_time_total / iters / 1e3
                    for e in ka}
    raise RuntimeError(f"torch.profiler dropped device records in every "
                       f"window of {iters} calls: {seen}")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call (ms), all its device kernels together."""
    return sum(device_ms_by_kernel(fn, iters).values())


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
    """(least ms, "operations" or "bytes") of a call's work at the H100
    SXM's dense bf16 peak and HBM3 rate (NVIDIA's data sheet)."""
    from repro_torch.core.sampling import HBM_BW, PEAK_FLOPS
    t_ops = flops / PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _decode_at(q, kc, vc, length: int, n_splits: int, keys_per_split: int):
    """The decode kernel's launcher with the splits given, bypassing the
    planner and the launch counter: [0, length) in ``n_splits`` ranges of
    ``keys_per_split`` keys."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as fd
    if not (n_splits - 1) * keys_per_split < length \
            <= n_splits * keys_per_split:
        raise ValueError(f"{n_splits} x {keys_per_split} keys do not cover "
                         f"length {length}")
    b, h, d = q.shape
    out = torch.empty_like(q)
    err = fd._lib().flash_decode_fwd_bf16(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, h,
        kc.shape[2], kc.shape[1], d, length, n_splits, keys_per_split,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_decode_fwd_bf16")
    return out


def time_kernels(cfg, prompt: int) -> tuple:
    """Each kernel of the path (through the main path's wrapper), its plain
    version, a library yardstick and the bound, at the path's shapes:
    prefill attention over the prompt, a decode step against the cache a
    mid-generation step sees, and the SSD scan of a prefill.  Returns
    ({kernel: times}, {split count: decode kernel device ms} over every
    count up to ``MAX_SPLITS``, with the planner's own count, {device
    kernel: ms} of the SSD scan's steps, empty without a mamba layer)."""
    from repro_torch.configs.base import HYBRID, SWA
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    windowed = any(k in (SWA, HYBRID) for k in cfg.blocks)
    window = cfg.window if windowed else 0
    res, steps = {}, {}
    res["flash_attention"] = _timed(*_flash_fns(gen, B, prompt, h, hkv, d,
                                                window))
    # decode: a mid-generation step; a window layer's ring is full
    smax = prompt + GEN_LEN
    length = prompt + GEN_LEN // 2
    if window:
        smax = length = min(window, prompt)
    qd = _randn((B, h, d), gen, 0.5)
    kc = _randn((B, smax, hkv, d), gen, 0.5)
    vc = _randn((B, smax, hkv, d), gen, 0.5)
    kl = kc[:, :length].transpose(1, 2)
    vl = vc[:, :length].transpose(1, 2)
    flops, nbytes = fd.work(B, h, hkv, d, length)
    fns = dict(ms=lambda: ops.flash_decode(qd, kc, vc, length),
               plain_ms=lambda: fd.flash_decode_plain(qd, kc, vc, length),
               library_ms=lambda: F.scaled_dot_product_attention(
                   qd[:, :, None], kl, vl, enable_gqa=True))
    res["flash_decode"] = _timed(fns, flops, nbytes)
    # the same call at every split count, [0, length) cut as the planner
    # cuts it, to hold the planner's choice against the alternatives
    splits = {}
    for want in range(1, fd.MAX_SPLITS + 1):
        per = -(-length // want)
        n = -(-length // per)
        splits.setdefault(n, device_ms(
            lambda n=n, per=per: _decode_at(qd, kc, vc, length, n, per),
            iters=50))
    plan = fd.plan_splits(B, hkv, length, fd._sm_count(qd.device))
    if HYBRID in cfg.blocks:
        # serve's ssm_chunk
        fns, flops, nbytes = _ssm_fns(gen, B, prompt, h, d, cfg.ssm_state,
                                      min(64, prompt))
        res["ssm_scan"] = _timed(fns, flops, nbytes)
        steps = {(PORT_KERNEL.search(k) or re.search(".*", k)).group(0): v
                 for k, v in device_ms_by_kernel(fns["ms"]).items()}
    return res, dict(planner=list(plan), device_ms=splits), steps


def _flash_fns(gen, b: int, s: int, h: int, hkv: int, d: int,
               window: int) -> tuple:
    """({ms: the wrapper, plain_ms: the plain version, library_ms: SDPA,
    causal or with a boolean band mask under a window}, FLOPs, bytes) of
    flash prefill attention at these shapes, on fresh inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = _randn((b, s, h, d), gen)
    k = _randn((b, s, hkv, d), gen)
    v = _randn((b, s, hkv, d), gen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        i = torch.arange(s, device="cuda")
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        library = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    fns = dict(ms=lambda: ops.flash_attention(q, k, v, window=window),
               plain_ms=lambda: fa.flash_attention_plain(q, k, v,
                                                         window=window),
               library_ms=library)
    return (fns, *fa.work(b, s, h, hkv, d, window))


def _ssm_fns(gen, b: int, s: int, h: int, d: int, st: int,
             chunk: int) -> tuple:
    """({ms, plain_ms}, FLOPs, bytes) of the SSD scan at these shapes, on
    fresh inputs; no single PyTorch call computes a selective scan, so
    there is no library yardstick."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    xv, ld, Bm, Cm, _ = _ssm_inputs(gen, b, s, h, d, st)
    fns = dict(ms=lambda: ops.ssm_scan(xv, ld, Bm, Cm, None, chunk),
               plain_ms=lambda: ss.ssm_scan_plain(xv, ld, Bm, Cm,
                                                  chunk=chunk))
    return (fns, *ss.work(b, s, h, d, st, chunk))


def host_us(fn, n: int = 200) -> float:
    """Host time of one call (µs): ``n`` calls back to back without a
    synchronise, after a warm-up (what the dispatching thread spends)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def wrapper_host_us(cfg, prompt: int) -> dict:
    """Each wrapper's host time per call at the path's shapes, through
    the custom op (``ops.*``, as the main path calls it) and through the
    launcher alone (``*_cuda``, what the wrapper called before the custom
    ops), in turns: op, launcher, launcher, op."""
    from repro_torch.configs.base import HYBRID, SWA
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.window if any(k in (SWA, HYBRID) for k in cfg.blocks) \
        else 0
    q = _randn((B, prompt, h, d), gen)
    k = _randn((B, prompt, hkv, d), gen)
    if window:        # time_kernels' decode shapes: a full ring
        smax = length = min(window, prompt)
    else:
        smax, length = prompt + GEN_LEN, prompt + GEN_LEN // 2
    qd = _randn((B, h, d), gen)
    kc = _randn((B, smax, hkv, d), gen)
    pairs = {"flash_attention": (
        lambda: ops.flash_attention(q, k, k, window=window),
        lambda: fa.flash_attention_cuda(q, k, k, window=window)),
        "flash_decode": (
        lambda: ops.flash_decode(qd, kc, kc, length),
        lambda: fd.flash_decode_cuda(qd, kc, kc, length))}
    if HYBRID in cfg.blocks:
        xv, ld, Bm, Cm, _ = _ssm_inputs(gen, B, prompt, h, d, cfg.ssm_state)
        chunk = min(64, prompt)
        pairs["ssm_scan"] = (
            lambda: ops.ssm_scan(xv, ld, Bm, Cm, None, chunk),
            lambda: ss.ssm_scan_cuda(xv, ld, Bm, Cm, None, chunk=chunk))
    out = {}
    with torch.no_grad():
        for name, (op, launcher) in pairs.items():
            t = [host_us(op), host_us(launcher), host_us(launcher),
                 host_us(op)]
            out[name] = dict(op_us=[t[0], t[3]], launcher_us=[t[1], t[2]])
    return out


def _timed(fns: dict, flops: float, nbytes: float) -> tuple:
    """({ms, plain_ms, library_ms: device ms (library_ms None where no
    library call computes the function), bound_ms, bound_by: the bound of
    this work}, {same keys: back-to-back call ms})."""
    bound_ms, bound_by = _bound(flops, nbytes)
    dev = {k: device_ms(f) for k, f in fns.items()}
    calls = {k: call_ms(f) for k, f in fns.items()}
    dev.setdefault("library_ms", None)
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


def interior_samples(db) -> dict:
    """PC samples (``gpu_inst/samples``) of an aggregated database by
    dispatch placeholder: {step: {"samples": under the placeholder,
    "kernels": {kernel: {"samples": of its interior leaves,
    "dot_general": of its dot_general leaves, "dot_lines": the (file,
    line) of each dot_general leaf that drew samples in the kernel's own
    .cu file}}}}.  A kernel is the interior root right below a
    ``custom-call`` op."""
    col = db.stats["sum"][:, db.metric_id("gpu_inst/samples")]
    out = {}
    for g, fr in enumerate(db.frames):
        if fr.kind == "placeholder" and fr.name.startswith("kernel:"):
            step = out.setdefault(fr.name[len("kernel:"):],
                                  {"samples": 0.0, "kernels": {}})
            step["samples"] += float(col[g])
    for g, fr in enumerate(db.frames):
        if fr.kind != "gpu_op" or not fr.module.endswith(".cu") \
                or col[g] <= 0:
            continue
        chain = [g]
        while db.parents[chain[-1]] >= 0:
            chain.append(int(db.parents[chain[-1]]))
        root = step = None
        for child, par in zip(chain, chain[1:]):
            pf = db.frames[par]
            if root is None and pf.kind == "gpu_op" \
                    and pf.name.startswith("custom-call:"):
                root = db.frames[child]
            if pf.kind == "placeholder" and pf.name.startswith("kernel:"):
                step = pf.name[len("kernel:"):]
                break
        if root is None or step is None:
            continue
        k = out[step]["kernels"].setdefault(root.name, {
            "samples": 0.0, "dot_general": 0.0, "dot_lines": set()})
        k["samples"] += float(col[g])
        if fr.name == "dot_general":
            k["dot_general"] += float(col[g])
            if fr.module == root.module:
                k["dot_lines"].add((fr.module, fr.line))
    return out


def _serve_opts(prompt: int):
    """The options ``serve`` builds by default for this prompt."""
    from repro_torch.models import transformer as T
    return T.ModelOptions(q_chunk=min(256, prompt), kv_chunk=min(256, prompt),
                          ssm_chunk=min(64, prompt))


def run_serve(cfg, params, prompt: int) -> dict:
    """The main path: serve under the port's profiler, every kernel launch
    counter set to 0 just before and read just after."""
    from repro_torch.configs.base import HYBRID
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    prof_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke_profile")
    prof_dir = os.path.join(prof_dir, cfg.name)
    shutil.rmtree(prof_dir, ignore_errors=True)
    for name in KERNELS:
        getattr(ops, name).launches = 0
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=N_REQUESTS, batch=B,
                        prompt_len=prompt, gen_len=GEN_LEN,
                        profile_dir=prof_dir, device="cuda", params=params)
    wall = time.monotonic() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    n_batches = -(-N_REQUESTS // B)
    n_hybrid = sum(k == HYBRID for k in cfg.blocks)
    want = {"flash_attention": cfg.n_layers * (n_batches + 1),
            "flash_decode": cfg.n_layers * ((GEN_LEN - 1) * n_batches + 1),
            "ssm_scan": n_hybrid * (n_batches + 1)}
    if launches != want:
        raise AssertionError(f"{cfg.name}: launch counts {launches}, "
                             f"expected {want}")
    if tuple(toks.shape) != (N_REQUESTS, GEN_LEN):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    if not paths or not all(os.path.getsize(p) > 0 for p in paths.values()):
        raise AssertionError(f"profile files missing: {paths}")
    lat = _profile_latencies(paths["gpu_0"])
    step_s = sum(ms * n for ms, n in lat.values()) * 1e-3
    return dict(tokens=toks, launches=launches, wall_s=wall, paths=paths,
                prefill_ms=lat["prefill"][0], decode_ms=lat["decode_step"][0],
                tok_per_s_in_steps=N_REQUESTS * GEN_LEN / step_s)


def serve_wall(cfg, params, prompt: int) -> float:
    """Wall seconds of the same serve as ``run_serve`` without a profile
    directory (no profiler, no registration)."""
    from repro_torch.launch.serve import serve
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=N_REQUESTS, batch=B,
                        prompt_len=prompt, gen_len=GEN_LEN, profile_dir=None,
                        device="cuda", params=params)
    wall = time.monotonic() - t0
    if paths is not None or tuple(toks.shape) != (N_REQUESTS, GEN_LEN):
        raise AssertionError(f"serve without a profile: {paths}, "
                             f"{tuple(toks.shape)}")
    return wall


def _database(paths: dict, out_dir: str):
    """The port's canonical database of one serve's profiles and traces."""
    from repro_torch.core.aggregate import aggregate
    shutil.rmtree(out_dir, ignore_errors=True)
    profiles = sorted(v for k, v in paths.items()
                      if k.startswith(("cpu_", "gpu_")) and "trace" not in k)
    traces = sorted(v for k, v in paths.items() if "trace" in k)
    return aggregate(profiles, out_dir, trace_paths=traces)


def check_profile(cfg, paths: dict) -> dict:
    """Aggregate the main path's profiles with the port's ``aggregate``
    into ``chiprun_out/chip_smoke_db/<model>`` and check them: PC samples
    under both step placeholders, and under every kernel's custom-call
    samples that reach a dot_general leaf of its own .cu file.  Prints
    the top-down view.  Returns {step: samples, export seconds, ops,
    kernels' samples}."""
    from repro_torch.core import viewer
    db = _database(paths, os.path.join(ROOT, "chiprun_out", "chip_smoke_db",
                                       cfg.name))
    got = interior_samples(db)
    with open(paths["measurement"]) as f:
        measurement = json.load(f)
    structure = measurement["steps"]
    want = {"prefill": {"flash_attention"}, "decode_step":
            {"decode_attention"}}
    if "hybrid" in cfg.blocks:
        want["prefill"].add("ssm_scan")
    out = {}
    for step, kernels in want.items():
        if got.get(step, {}).get("samples", 0) <= 0:
            raise AssertionError(f"{cfg.name}: no gpu_inst/samples under "
                                 f"kernel:{step}")
        for kname in kernels:
            k = got[step]["kernels"].get(kname)
            if not k or k["dot_general"] <= 0 or not k["dot_lines"]:
                raise AssertionError(f"{cfg.name} {step}: no sample of "
                                     f"{kname} reached a dot_general leaf "
                                     f"of {kname}.cu: {k}")
        out[step] = dict(
            samples=got[step]["samples"], ops=structure[step]["ops"],
            custom_calls=structure[step]["custom_calls"],
            export_s=structure[step]["seconds"],
            kernels={kname: dict(samples=k["samples"],
                                 dot_general=k["dot_general"],
                                 dot_lines=sorted(k["dot_lines"]))
                     for kname, k in got[step]["kernels"].items()})
    out["profiler"] = measurement["profiler"]
    print(viewer.top_down(db, "gpu_inst/samples", max_depth=8), flush=True)
    return out


def check_counters(cfg, prompt: int) -> None:
    """A second, short serve (2 layers at full width, 4 requests of 4
    tokens) with hardware counters on: every counter column non-zero at
    both step placeholders.  Prints the counter table."""
    from repro_torch.core import derived, viewer
    from repro_torch.launch.serve import serve
    small = dataclasses.replace(cfg, n_layers=2)
    prof_dir = os.path.join(ROOT, "chiprun_out", "chip_smoke_counters",
                            cfg.name)
    shutil.rmtree(prof_dir, ignore_errors=True)
    _, paths = serve(small, n_requests=B, batch=B, prompt_len=prompt,
                     gen_len=4, profile_dir=prof_dir, device="cuda",
                     counters=COUNTERS)
    db = _database(paths, prof_dir + "_db")
    cols = derived.database_columns(db, "sum")
    steps = [g for g, f in enumerate(db.frames) if f.kind == "placeholder"
             and f.name in ("kernel:prefill", "kernel:decode_step")]
    if len(steps) < 2:
        raise AssertionError(f"counters: step placeholders {steps}")
    for c in COUNTERS:
        col = cols.get(f"gpu_counter/{c}")
        if col is None or not all(col[g] > 0 for g in steps):
            raise AssertionError(f"{cfg.name}: counter {c} missing or zero")
    print(viewer.counter_table(db), flush=True)


_SASS_LOC = re.compile(r'"([^"]+)",?\s*line\s*(\d+)')
_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/")


def sass_lines(lib: str, work_dir: str) -> set:
    """(file name, line) of every source line with at least one SASS
    instruction in the library's cubins: ``cuobjdump -xelf all`` extracts
    them, ``nvdisasm -gi`` gives the line table, inlined call sites
    included (the build passes ``-lineinfo``)."""
    from repro_torch.kernels import build
    bindir = os.path.dirname(build._nvcc())
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    subprocess.run([os.path.join(bindir, "cuobjdump"), "-xelf", "all",
                    os.path.abspath(lib)], cwd=work_dir, check=True,
                   capture_output=True)
    cubins = sorted(f for f in os.listdir(work_dir) if f.endswith(".cubin"))
    if not cubins:
        raise AssertionError(f"no cubin in {lib}")
    out = set()
    for cub in cubins:
        out |= line_table(subprocess.run(
            [os.path.join(bindir, "nvdisasm"), "-gi",
             os.path.join(work_dir, cub)], check=True, capture_output=True,
            text=True).stdout)
    return out


def line_table(sass: str) -> set:
    """(file name, line) of every location that an instruction of
    ``nvdisasm -gi`` output is attributed to.  An instruction's location
    is the block of "//##" lines above it, one per inlining level ("File
    a, line n inlined at b, line m"), up to the outermost call site."""
    out, locs, fresh = set(), [], True
    for line in sass.splitlines():
        if "//##" in line:
            if fresh:
                locs, fresh = [], False
            locs += _SASS_LOC.findall(line)
        elif _SASS_INSN.search(line):
            out.update((os.path.basename(f), int(n)) for f, n in locs)
            fresh = True
    return out


def check_sass() -> dict:
    """Ground the source-derived kernel structures in the binaries: at
    every path's shapes, every dot_general leaf's line has at least one
    SASS instruction.  Returns {kernel: dot_general lines checked}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, kernel_structures
    libs = build.build(["flash_attention", "decode_attention", "ssm_scan"])
    tables = {name: sass_lines(str(path), os.path.join(
        str(build.BUILD_DIR), "sass", name)) for name, path in libs.items()}
    checked = {}
    for name, spec in {**PATHS, **SERVING_PATHS}.items():
        prompt = spec["prompt"]
        for ks in kernel_structures(get_config(name), B, prompt,
                                    prompt + GEN_LEN):
            lib = ks.file[:-len(".cu")]
            dots = {(lf.frames[-1].module, lf.line) for lf in ks.leaves
                    if lf.frames[-1].name == "dot_general"}
            missing = sorted(dots - tables[lib])
            if not dots or missing:
                raise AssertionError(f"{ks.name}: dot_general leaves "
                                     f"without SASS: {missing or 'none'}")
            checked.setdefault(ks.name, set()).update(dots)
    return {k: sorted(v) for k, v in checked.items()}


def check_replay(cfg, params, toks, prompt: int) -> None:
    """Every request batch again, outside serve, from the same prompts:
    every logit finite, the same tokens."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    opts = _serve_opts(prompt)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    rng = np.random.default_rng(0)         # serve's prompt generator
    for bi in range(-(-N_REQUESTS // B)):
        prompts = rng.integers(0, cfg.vocab, (B, prompt), np.int32)
        logits, cache = prefill(
            params, {"tokens": torch.from_numpy(prompts).cuda().long()})
        cache = serve_mod._grow_cache(cache, prompt + GEN_LEN, prompt)
        got = [logits.argmax(-1)]
        finite = [torch.isfinite(logits).all()]
        for t in range(GEN_LEN - 1):
            logits, cache = decode(params, cache, prompt + t, token=got[-1])
            finite.append(torch.isfinite(logits).all())
            got.append(logits.argmax(-1))
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{cfg.name} batch {bi}: non-finite logits")
        want = toks[bi * B:(bi + 1) * B]
        if not torch.equal(torch.stack(got, 1)[:len(want)], want):
            raise AssertionError(f"{cfg.name} batch {bi}: replay differs "
                                 f"from serve")


def step_breakdown(cfg, params, prompt: int, n_decode: int = 8) -> dict:
    """Where a serving step's time goes, under torch.profiler
    (``profiled_steps``): one prefill, ``n_decode`` decode steps."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    opts = _serve_opts(prompt)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    batch = {"tokens": torch.zeros((B, prompt), dtype=torch.long,
                                   device="cuda")}
    out = {}
    for phase in ("prefill", "decode"):
        logits, cache = prefill(params, batch)
        cache = serve_mod._grow_cache(cache, prompt + GEN_LEN, prompt)
        tok = logits.argmax(-1)
        steps_run = iter(range(prompt, prompt + n_decode))
        out[phase] = profiled_steps(
            (lambda: prefill(params, batch)) if phase == "prefill" else
            (lambda: decode(params, cache, next(steps_run), token=tok)),
            1 if phase == "prefill" else n_decode)
    return out


def profiled_steps(step, n: int, top: int = 5) -> dict:
    """``step()`` ``n`` times under torch.profiler: host wall time per step
    (ending in a synchronize) against the device's busy time (the sum of
    CUDA kernel time), the idle share, device kernels per step, the port's
    own kernels' ms per step by name, and the ``top`` kernels that take
    most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ka = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ka) / 1e3 / n
    port = {}
    for e in ka:
        m = PORT_KERNEL.search(e.key)
        if m:
            port[m.group(0)] = (port.get(m.group(0), 0.0)
                                + e.self_device_time_total / 1e3 / n)
    ranked = sorted(ka, key=lambda e: -e.self_device_time_total)[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                kernels_per_step=sum(e.count for e in ka) / n,
                port_kernels_ms=port,
                top_kernels=[(e.key[:48], e.self_device_time_total / 1e3 / n,
                              e.count // n) for e in ranked])


def check_against_cpu(cfg, prompt: int, window: int, blocks=None) -> float:
    """A 2-layer model at full width (window layers at ``window``; with
    ``blocks``, that block pattern): kernels on the card against the same
    bf16 weights on the CPU through the plain versions, prefill plus 4
    teacher-forced decode steps.  Both sides round
    to bf16 at the same points and differ by accumulation order only, a
    few bf16 ulps at the logits' scale; so the max abs logit error is held
    to 2e-2 of the largest reference logit, per step.

    The seeded init takes wq/wk's fan-in from the head axis, as the JAX
    package does, which at these widths gives raw attention scores of std
    about 128 (qwen2; hymba's are of the same order): a one-hot softmax
    whose winner flips under any rounding.  wq and wk are scaled by 1/8
    here so that scores are of unit scale and the comparison measures the
    kernels, not near-ties.  The mLSTM's wq, wk and gate projection wif
    take their fan-in from the head axis too (4 heads at xlstm-125m's
    width): its q.k scores and exponential gates' pre-activations are then
    tens, where bf16 rounding alone moves the output by a large fraction
    (73% of the largest logit between JAX in bf16 and in f32 at the
    reduced width, scripts/xlstm_conditioning.py); they are scaled by 1/16
    here, about the ratio of that fan-in to the projection's width.
    Returns the largest error ratio."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    small = dataclasses.replace(cfg, n_layers=2, window=window)
    if blocks:
        small = dataclasses.replace(small, block_pattern=tuple(blocks))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    p_gpu = T.init_params(gen, small)
    for e in p_gpu["layers"].values():
        for w in ("wq", "wk") if "attn" in e else ():
            e["attn"][w].mul_(0.125)
        for w in ("wq", "wk", "wif") if "mlstm" in e else ():
            e["mlstm"][w].mul_(1 / 16)
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    opts = T.ModelOptions(q_chunk=64, kv_chunk=64, ssm_chunk=64)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, prompt), np.int64))
    worst = 0.0
    with torch.no_grad():
        lg, cg = T.prefill(p_gpu, small, toks.cuda(), opts=opts)
        lc, cc = T.prefill(p_cpu, small, toks, opts=opts)
        cg = serve_mod._grow_cache(cg, prompt + 8, prompt)
        cc = serve_mod._grow_cache(cc, prompt + 8, prompt)
        for t in range(5):
            if not torch.isfinite(lg).all():
                raise AssertionError(f"step {t}: non-finite logits")
            rel = float((lg.cpu() - lc).abs().max() / lc.abs().max())
            if rel > 2e-2:
                raise AssertionError(f"{cfg.name} step {t}: max abs logit "
                                     f"error is {rel:.4f} of the largest "
                                     f"logit")
            worst = max(worst, rel)
            if t == 4:
                break
            nxt = lg.argmax(-1)
            lg, cg = T.decode_step(p_gpu, small, cg, token=nxt,
                                   pos=prompt + t, opts=opts)
            lc, cc = T.decode_step(p_cpu, small, cc, token=nxt.cpu(),
                                   pos=prompt + t, opts=opts)
    return worst


def init_params(name: str) -> dict:
    """Seeded random weights of one model at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return T.init_params(gen, get_config(name))


def _has_attention(cfg) -> bool:
    from repro_torch.configs.base import ATTN, HYBRID, SWA
    return any(k in (ATTN, SWA, HYBRID) for k in cfg.blocks)


def time_path(name: str, params) -> dict:
    """Time one model's kernels and break its steps down under
    torch.profiler.  Runs before any of the port's profiled serves: once
    the port's profiler has drawn PC samples in a process, torch.profiler
    drops device records (on an "NVIDIA H100 80GB HBM3" at 700 W, 1 of
    20 launches a window after a 2-layer serve, 4 after a full-depth one;
    none after an export, a registration or a profiled serve that draws
    no samples).  Returns the kernel times."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    prompt = {**PATHS, **SERVING_PATHS}[name]["prompt"]
    if not _has_attention(cfg):
        print(f"{name} step breakdown: "
              f"{json.dumps(step_breakdown(cfg, params, prompt))}",
              flush=True)
        return {}
    times, splits, steps = time_kernels(cfg, prompt)
    for kname, (t, calls) in times.items():
        by_step = (f"; device ms by step {json.dumps(steps)}"
                   if kname == "ssm_scan" else "")
        print(f"{name} {kname}: device {json.dumps(t)}; back-to-back call "
              f"{json.dumps(calls)}{by_step}", flush=True)
    print(f"{name} flash_decode by split count: {json.dumps(splits)}",
          flush=True)
    if "ssm_scan" in times:
        print("ssm_scan library_ms: null, no single PyTorch call computes "
              "a selective (SSD) scan", flush=True)
    print(f"{name} step breakdown: "
          f"{json.dumps(step_breakdown(cfg, params, prompt))}", flush=True)
    return times


def serve_path(name: str, params) -> dict:
    """Serve one model under the port's profiler, check its output, its
    profile and database, the profiler's overhead, the 2-layer CPU check
    and a counters serve.  Frees ``params`` on the way.  Returns the
    serve result."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    prompt = PATHS[name]["prompt"]
    plain_s = [serve_wall(cfg, params, prompt)]
    srv = run_serve(cfg, params, prompt)
    plain_s.append(serve_wall(cfg, params, prompt))
    print(f"serve {name}: {N_REQUESTS} requests x {GEN_LEN} tokens, "
          f"batch {B}, prompt {prompt}: wall {srv['wall_s']:.2f} s (incl. "
          f"warm-up), prefill {srv['prefill_ms']:.3f} ms/batch, decode "
          f"{srv['decode_ms']:.3f} ms/step, "
          f"{srv['tok_per_s_in_steps']:.1f} tok/s over measured steps; "
          f"launches {json.dumps(srv['launches'])}", flush=True)
    prof = check_profile(cfg, srv["paths"])
    print(f"profile {name}: {json.dumps(prof)}", flush=True)
    reg_s = sum(v["export_s"] for k, v in prof.items() if k != "profiler")
    plain = sum(plain_s) / len(plain_s)
    print(f"profiler overhead {name}: serve wall with a profile directory "
          f"{srv['wall_s']:.3f} s (export and registration of both steps "
          f"{reg_s:.3f} s), without {plain_s[0]:.3f} / {plain_s[1]:.3f} s; "
          f"ratio {srv['wall_s'] / plain:.4f}, without the registration "
          f"{(srv['wall_s'] - reg_s) / plain:.4f}", flush=True)
    check_replay(cfg, params, srv["tokens"], prompt)
    print(f"replay {name}: every batch reproduces serve's tokens",
          flush=True)
    print(f"{name} wrapper host us per call (custom op, launcher alone): "
          f"{json.dumps(wrapper_host_us(cfg, prompt))}", flush=True)
    del params
    torch.cuda.empty_cache()
    cpu = PATHS[name]
    worst = check_against_cpu(cfg, cpu["cpu_prompt"], cpu["cpu_window"])
    print(f"{name}: 2-layer full-width (prompt {cpu['cpu_prompt']}, window "
          f"{cpu['cpu_window']}) vs CPU bf16 plain: max abs logit err / max "
          f"abs logit {worst:.4f}", flush=True)
    check_counters(cfg, prompt)
    print(f"{name}: counters on a 2-layer serve: every column non-zero",
          flush=True)
    return srv


def run_serving(cfg, params, prompt: int) -> dict:
    """A main path under the always-on serving profiler (the governor at
    the sweep's budget): ``serve(serving=...)`` with every kernel launch
    counter set to 0 just before and read just after; the profiles are
    written and the profiler stopped after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.serving import GovernorConfig, ServingProfiler
    out_dir = os.path.join(SCRATCH, "serving", cfg.name)
    shutil.rmtree(out_dir, ignore_errors=True)
    sp = ServingProfiler(out_dir, governor=GovernorConfig(budget=BUDGET,
                                                          interval=4))
    sp.start()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=N_REQUESTS, batch=B,
                        prompt_len=prompt, gen_len=GEN_LEN, serving=sp,
                        device="cuda", params=params)
    wall = time.monotonic() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    sp.profiler.flush()
    paths = sp.write()
    status, governor = sp.status(), sp.governor.state()
    sp.stop()
    n_batches = -(-N_REQUESTS // B)
    n_attn = cfg.n_layers if _has_attention(cfg) else 0
    want = {"flash_attention": n_attn * (n_batches + 1),
            "flash_decode": n_attn * ((GEN_LEN - 1) * n_batches + 1),
            "ssm_scan": 0}
    if launches != want:
        raise AssertionError(f"{cfg.name}: launch counts {launches}, "
                             f"expected {want}")
    if tuple(toks.shape) != (N_REQUESTS, GEN_LEN):
        raise AssertionError(f"tokens shape {tuple(toks.shape)}")
    with open(os.path.join(out_dir, "measurement.json")) as f:
        steps = json.load(f)["steps"]
    return dict(tokens=toks, launches=launches, wall_s=wall, paths=paths,
                status=status, governor=governor, steps=steps)


def check_attribution(cfg, paths: dict) -> dict:
    """Aggregate a serving-profiler run into ``build/chip_smoke/db/<model>``
    and read back what its operator reads: every request batch's GPU time in both phases, the latency
    percentiles, and PC samples in each kernel's interior under its step.
    Returns {attribution rows, percentiles, samples}."""
    from repro_torch.serving.window import DECODE, PREFILL
    from repro_torch.traceview.stats import (request_attribution,
                                             request_latency_percentiles)
    from repro_torch.traceview.tracedb import TraceDB
    db = _database(paths, os.path.join(SCRATCH, "db", cfg.name))
    lines = TraceDB(db.trace_db_path()).line_views()
    rows = request_attribution(lines, db)
    rids = {f"r{lo}-r{min(lo + B, N_REQUESTS) - 1}"
            for lo in range(0, N_REQUESTS, B)}
    got = {rid: by for rid, _, by in rows}
    if set(got) != rids or not all(
            by.get(PREFILL, 0) > 0 and by.get(DECODE, 0) > 0
            for by in got.values()):
        raise AssertionError(f"{cfg.name}: request attribution {rows}, "
                             f"want GPU time in both phases of {rids}")
    samples = interior_samples(db)
    want = {"prefill": "flash_attention", "decode_step": "decode_attention"}
    for step, kname in want.items() if _has_attention(cfg) else ():
        k = samples.get(step, {}).get("kernels", {}).get(kname)
        if not k or k["samples"] <= 0:
            raise AssertionError(f"{cfg.name} {step}: no PC sample in "
                                 f"{kname}'s interior: {k}")
    return dict(
        attribution=[(rid, total, by) for rid, total, by in rows],
        latency_ms=request_latency_percentiles(lines, db),
        samples={step: dict(samples=v["samples"], kernels={
            kname: k["samples"] for kname, k in v["kernels"].items()})
            for step, v in samples.items()})


def serving_path(name: str, params) -> dict:
    """Serve one model under the serving profiler, check its launches,
    request attribution and kernel interiors, the replays and the 2-layer
    CPU check, and print the governor's final level and the serve wall
    over that of the same serve without a profiler.  Frees ``params`` on
    the way.  Returns the serve result."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    spec = SERVING_PATHS[name]
    prompt = spec["prompt"]
    plain_s = [serve_wall(cfg, params, prompt)]
    srv = run_serving(cfg, params, prompt)
    plain_s.append(serve_wall(cfg, params, prompt))
    gov = srv["governor"]
    print(f"serve {name} under the serving profiler (budget {BUDGET}): "
          f"{N_REQUESTS} requests x {GEN_LEN} tokens, batch {B}, prompt "
          f"{prompt}: wall {srv['wall_s']:.2f} s (incl. warm-up, export "
          f"and registration); launches {json.dumps(srv['launches'])}; "
          f"governor level {gov['level']} ({gov['level_name']}), "
          f"{gov['decisions']} decisions, {gov['slo_sheds']} SLO sheds, "
          f"overhead {gov['overhead']:.4f}; status "
          f"{json.dumps(srv['status'])}", flush=True)
    print(f"export {name}: {json.dumps(srv['steps'])}", flush=True)
    got = check_attribution(cfg, srv["paths"])
    print(f"attribution {name}: {json.dumps(got)}", flush=True)
    reg_s = sum(v["seconds"] for v in srv["steps"].values())
    plain = sum(plain_s) / len(plain_s)
    print(f"serving profiler overhead {name}: serve wall under the serving "
          f"profiler {srv['wall_s']:.3f} s (export and registration of both "
          f"steps {reg_s:.3f} s), without a profiler {plain_s[0]:.3f} / "
          f"{plain_s[1]:.3f} s; ratio {srv['wall_s'] / plain:.4f}, without "
          f"the registration {(srv['wall_s'] - reg_s) / plain:.4f}",
          flush=True)
    check_replay(cfg, params, srv["tokens"], prompt)
    print(f"replay {name}: every batch reproduces serve's tokens",
          flush=True)
    del params
    torch.cuda.empty_cache()
    worst = check_against_cpu(cfg, spec["cpu_prompt"], spec["cpu_window"],
                              spec.get("cpu_blocks"))
    print(f"{name}: 2-layer full-width (prompt {spec['cpu_prompt']}, blocks "
          f"{spec.get('cpu_blocks', 'as configured')}) vs CPU bf16 plain: "
          f"max abs logit err / max abs logit {worst:.4f}", flush=True)
    return srv


def run_sweep_on_card() -> list:
    """The port's six-scenario serving sweep on the card (reduced
    configurations in bf16 at head_dim 64, prompts 64 / 8, generations 4 /
    24, 4 requests in batches of 2, budget 0.5); every row must attribute
    GPU time to every request batch in both phases.  Prints the report
    lines; returns the rows."""
    from repro_torch.serving import sweep
    out = os.path.join(SCRATCH, "sweep")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.monotonic()
    rows = sweep.run_sweep(out, budget=BUDGET, device="cuda")
    seconds = time.monotonic() - t0
    for row in rows:
        print(f"sweep {sweep.report_line(row)}", flush=True)
        by = {a["request"]: a["by_phase"] for a in row["attribution"]}
        if set(by) != {"r0-r1", "r2-r3"} or not all(
                p.get("prefill", 0) > 0 and p.get("decode", 0) > 0
                for p in by.values()):
            raise AssertionError(f"sweep {row['scenario']}: attribution "
                                 f"{row['attribution']}")
    if [r["scenario"] for r in rows] != [s.name for s in sweep.SCENARIOS]:
        raise AssertionError("sweep: not every scenario ran")
    print(f"sweep: {len(rows)} scenarios in {seconds:.1f} s; rows "
          f"{json.dumps([dict(scenario=r['scenario'], status=r['status'], governor=r['governor'], trace_latency_ms=r['trace_latency_ms'], attribution=r['attribution']) for r in rows])}",
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
# the training paths at published widths: batch, sequence, steps of the
# main run through ``launch.train.train`` (hymba's 1536 > its window of
# 1024, so the window bites), whether the run is under the port's
# profiler (hymba's step traces to about 8000 ops a layer: the plain
# recompute backward of its 36 attention block pairs and 24 scan chunks)
TRAIN_PATHS = {"qwen2-1.5b": dict(batch=4, seq=512, steps=6, profile=True),
               "hymba-1.5b": dict(batch=2, seq=1536, steps=3,
                                  profile=False)}
# forward launches of each kernel per layer and train step under the
# default remat (``dots_no_batch``): the forward, and its recompute in the
# backward (the policy saves matmul outputs only); the backward itself is
# plain torch and launches no kernel of the port
LAUNCHES_PER_LAYER = 2
TRAIN_TIMED_STEPS = 2


def _train_opts(seq: int):
    from repro_torch.models import transformer as T
    return T.ModelOptions(q_chunk=min(256, seq), kv_chunk=min(256, seq),
                          ssm_chunk=64, loss_chunk=512)


def _lm_batch(cfg, batch: int, seq: int, step: int = 0) -> dict:
    """The synthetic pipeline's batch at ``step`` (seed 0) on the card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import to_device
    ds = SyntheticLM(cfg, ShapeConfig("train", seq, batch, "train"))
    return to_device(ds.batch_at(step), "cuda")


def check_kernel_grads() -> tuple:
    """Each differentiable wrapper's forward and gradients on the card.
    The forward (the Hopper kernel) is held against the plain version's on
    the same bf16 inputs as ``check_kernels`` holds it (TOL and ROW_TOL by
    row, STATE_TOL for h_final), at the qwen2 and hymba training shapes
    (B = 4 and 2) and at windowed, ragged edges.  The gradients (the
    plain recompute backward, which takes the saved inputs and not the
    kernel's output) are held against the plain version's autograd with
    the same cotangents: elementwise at TOL (STATE_TOL for the fp32
    dlogdecay and dh0) and each tensor's max abs error within ROW_TOL of
    its largest value (a row-wise check would divide by rows that are
    zero in exact arithmetic, such as dq of a query that sees one key).
    That checks the backward's wiring: the recompute's mask and window,
    h0 given or None, the cotangent on h_final.  Under torch.profiler the
    forward runs the port's kernel and the backward none of them.
    Returns ({(training path or "edge", kernel): forward max abs error},
    {kernel: gradient max abs error})."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    fwd = {}
    errs = {"flash_attention": 0.0, "ssm_scan": 0.0}

    def grads(fn, ins, cots):
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return [o.detach() for o in outs], torch.autograd.grad(
            outs, [t for t in ins if t is not None], cots)

    def forward(key, outs, want, tols):
        torch.cuda.synchronize()
        for i, (o, w, tol) in enumerate(zip(outs, want, tols)):
            e, _ = _err(o, w.detach(), tol, rows=i == 0)
            fwd[key] = max(fwd.get(key, 0.0), e)

    def hold(name, got, want, tols):
        torch.cuda.synchronize()
        for g, w, tol in zip(got, want, tols):
            torch.testing.assert_close(g.float(), w.float(), **tol)
            err = float((g.float() - w.float()).abs().max())
            if err > ROW_TOL * float(w.float().abs().max()):
                raise AssertionError(f"{name} gradient: max abs error {err} "
                                     f"over {ROW_TOL} of its largest value")
            errs[name] = max(errs[name], err)

    # (path, B, S, H, Hkv, D, window): qwen2's and hymba's training
    # shapes, a window under a kv tile on ragged tiles, and G = 1 at D = 64
    for path, b, s, h, hkv, d, window in [
            ("qwen2-1.5b", 4, 512, 12, 2, 128, 0),
            ("hymba-1.5b", 2, 1536, 25, 5, 64, 1024),
            ("edge", 1, 300, 8, 2, 128, 40),
            ("edge", 2, 200, 4, 4, 64, 48)]:
        ins = [_randn(shape, gen).requires_grad_(True) for shape in
               ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
        do = _randn((b, s, h, d), gen)
        out, got = grads(lambda *a: ops.flash_attention(*a, window=window),
                         ins, (do,))
        want_out, want = grads(
            lambda *a: fa.flash_attention_plain(*a, window=window), ins,
            (do,))
        forward((path, "flash_attention"), out, want_out, [TOL])
        hold("flash_attention", got, want, [TOL] * 3)
    # (path, B, S, nh, hd, st, chunk, h0): hymba's training shape (no h0)
    # and with h0, a ragged S, unpadded rows (hd 120, st 50)
    for path, b, s, nh, hd, st, chunk, with_h0 in [
            ("hymba-1.5b", 2, 1536, 25, 64, 16, 64, False),
            ("edge", 2, 1536, 25, 64, 16, 64, True),
            ("edge", 2, 200, 3, 64, 16, 64, True),
            ("edge", 1, 500, 2, 120, 50, 225, True)]:
        xv, ld, Bm, Cm, h0 = _ssm_inputs(gen, b, s, nh, hd, st,
                                         with_h0=with_h0)
        ins = [t.requires_grad_(True) if t is not None else None
               for t in (xv, ld, Bm, Cm, h0)]
        cots = (_randn(xv.shape, gen), _randn((b, nh, hd, st), gen, 1.0,
                                              torch.float32))
        out, got = grads(lambda *a: ops.ssm_scan(*a, chunk), ins, cots)
        want_out, want = grads(
            lambda *a: ss.ssm_scan_plain(*a, chunk=chunk), ins, cots)
        forward((path, "ssm_scan"), out, want_out, [TOL, STATE_TOL])
        hold("ssm_scan", got, want,
             [TOL, STATE_TOL, TOL, TOL, STATE_TOL][:len(got)])
    # the forward runs the kernel, the backward none of the port's
    q, k, v = (_randn((2, 512, 12 if i == 0 else 2, 128), gen)
               .requires_grad_(True) for i in range(3))
    xv, ld, Bm, Cm, _ = _ssm_inputs(gen, 2, 256, 4, 64, 16)
    for t in (xv, ld, Bm, Cm):
        t.requires_grad_(True)
    outs = []
    ran = [profiled_steps(fn, 1) for fn in (
        lambda: outs.append(ops.flash_attention(q, k, v)),
        lambda: outs[0].sum().backward(),
        lambda: outs.append(ops.ssm_scan(xv, ld, Bm, Cm, None, 64)[0]),
        lambda: outs[1].float().sum().backward())]
    names = [set(r["port_kernels_ms"]) for r in ran]
    if names[0] != {"flash_fwd_kernel"} or len(names[2]) != SSM_STEPS \
            or names[1] or names[3] \
            or not all(r["kernels_per_step"] for r in ran):
        raise AssertionError(f"the port's kernels under torch.profiler: "
                             f"flash forward, backward, SSD forward, "
                             f"backward: {names}")
    return fwd, errs


def time_train_kernels(name: str) -> dict:
    """Each kernel of one training path at its training shapes, as
    ``time_kernels`` times the serving paths'.  Runs before any step is
    profiled whole: after a window of a whole train step (about 16,000
    device kernels), and once after the serving paths' step breakdowns,
    torch.profiler on an "NVIDIA H100 80GB HBM3" at 700 W dropped one
    record in every later window of 20 calls.  Returns {kernel:
    times}."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HYBRID
    cfg = get_config(name)
    b, seq = TRAIN_PATHS[name]["batch"], TRAIN_PATHS[name]["seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kernels = {"flash_attention": _timed(*_flash_fns(
        gen, b, seq, h, hkv, d, cfg.window if HYBRID in cfg.blocks else 0))}
    if HYBRID in cfg.blocks:
        kernels["ssm_scan"] = _timed(*_ssm_fns(gen, b, seq, h, d,
                                               cfg.ssm_state, 64))
    return kernels


def time_train(name: str) -> dict:
    """A train step of one training path under torch.profiler, before any
    profiled run (see ``time_path``): seeded full-width, full-depth
    weights, the pipeline's first batch repeated, ``OptConfig(
    warmup_steps=1)``; one warm-up step, ``TRAIN_TIMED_STEPS`` steps under
    the profiler, one more.  The loss must fall over the four steps on
    the repeated batch.  Returns {host wall ms, device busy ms, idle
    share, tokens/s, device kernels per step, the port's kernels' ms and
    share, top kernels, losses}."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config(name)
    spec = TRAIN_PATHS[name]
    b, seq = spec["batch"], spec["seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    state = adamw.init(params)
    step = steps_mod.make_train_step(cfg, _train_opts(seq), adamw.OptConfig(
        warmup_steps=1, total_steps=100))
    batch = _lm_batch(cfg, b, seq)
    losses = []

    def one():
        nonlocal params, state
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])

    one()
    res = profiled_steps(one, TRAIN_TIMED_STEPS, top=6)
    one()
    losses = [float(x) for x in losses]
    del params, state
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} train: losses on a repeated batch "
                             f"{losses} (must be finite and fall)")
    return dict(res, tokens_per_s=b * seq / res["wall_ms"] * 1e3,
                port_kernels_share=sum(res["port_kernels_ms"].values())
                / res["device_busy_ms"], losses=losses)


def train_path(name: str) -> dict:
    """The training main path: ``launch.train.train`` at full width and
    depth, seeded weights, every kernel launch counter set to 0 just
    before and read just after; the counts must be the remat policy's
    (layers x steps x ``LAUNCHES_PER_LAYER`` for each kernel the layers
    run) and every loss finite.  Under the port's profiler (qwen2): the
    registered train step has one custom-call per launch of a step, and
    the aggregated database (``build/chip_smoke/db/<model>-train``) has
    PC samples under the train_step placeholder that reach a dot_general
    leaf of flash_attention.cu.  Returns the run's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HYBRID, ShapeConfig
    from repro_torch.core import viewer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    cfg = get_config(name)
    spec = TRAIN_PATHS[name]
    prof_dir = None
    if spec["profile"]:
        prof_dir = os.path.join(SCRATCH, "train", name)
        shutil.rmtree(prof_dir, ignore_errors=True)
    for kname in KERNELS:
        getattr(ops, kname).launches = 0
    t0 = time.monotonic()
    _, hist, paths = train(cfg, ShapeConfig("train", spec["seq"],
                                            spec["batch"], "train"),
                           n_steps=spec["steps"], log_every=1,
                           opts=_train_opts(spec["seq"]),
                           profile_dir=prof_dir, device="cuda")
    wall = time.monotonic() - t0
    launches = {kname: getattr(ops, kname).launches for kname in KERNELS}
    per_step = cfg.n_layers * LAUNCHES_PER_LAYER
    want = {"flash_attention": per_step * spec["steps"], "flash_decode": 0,
            "ssm_scan": per_step * spec["steps"]
            if HYBRID in cfg.blocks else 0}
    losses = [h["loss"] for h in hist]
    print(f"train {name}: launches {json.dumps(launches)}, expected "
          f"{json.dumps(want)} ({cfg.n_layers} layers x {spec['steps']} "
          f"steps x {LAUNCHES_PER_LAYER}: forward + remat recompute); "
          f"losses {losses}; wall {wall:.2f} s", flush=True)
    if launches != want:
        raise AssertionError(f"{name} train: launch counts {launches}, "
                             f"expected {want}")
    if len(losses) != spec["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train: losses {losses}")
    out = dict(launches=launches, losses=losses, wall_s=wall)
    if paths is None:
        return out
    with open(paths["measurement"]) as f:
        measurement = json.load(f)
    step = measurement["steps"]["train_step"]
    if step["custom_calls"] != per_step:
        raise AssertionError(f"{name} train step: {step['custom_calls']} "
                             f"custom-calls bound, {per_step} launches a "
                             f"step")
    db = _database(paths, os.path.join(SCRATCH, "db", f"{name}-train"))
    got = interior_samples(db).get("train_step", {})
    k = got.get("kernels", {}).get("flash_attention")
    if got.get("samples", 0) <= 0 or not k or k["dot_general"] <= 0 \
            or not k["dot_lines"]:
        raise AssertionError(f"{name} train: PC samples under train_step "
                             f"{got.get('samples')}, flash interior {k}")
    print(viewer.top_down(db, "gpu_inst/samples", max_depth=7,
                          max_children=4), flush=True)
    out.update(ops=step["ops"], custom_calls=step["custom_calls"],
               export_s=step["seconds"], flops=step["flops"],
               samples=got["samples"],
               flash_samples=dict(samples=k["samples"],
                                  dot_general=k["dot_general"],
                                  dot_lines=sorted(k["dot_lines"])),
               profiler=measurement["profiler"])
    return out


def check_train_against_cpu(name: str, seq: int, window: int) -> dict:
    """One train step's loss and every gradient leaf of a 2-layer model at
    full width (window layers at ``window``), kernels on the card against
    the same bf16 weights on the CPU through the plain versions: the loss
    within 2e-2 relative, each leaf's max abs error within 2e-2 of its
    largest value, the serving check's bf16 tolerance; wq and wk
    tempered by 1/8, as there (``check_against_cpu``).  Returns the
    largest error ratio over the leaves."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves_with_paths, tree_map
    small = dataclasses.replace(get_config(name), n_layers=2, window=window)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    p_gpu = T.init_params(gen, small)
    for e in p_gpu["layers"].values():
        for w in ("wq", "wk"):
            e["attn"][w].mul_(0.125)
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    opts = _train_opts(seq)
    batch = _lm_batch(small, 2, seq)
    lg, _, gg = steps_mod._value_and_grad(small, opts, p_gpu, batch)
    lc, _, gc = steps_mod._value_and_grad(
        small, opts, p_cpu, {k: v.cpu() for k, v in batch.items()})
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    if not np.isfinite(float(lg)) or rel > 2e-2:
        raise AssertionError(f"{name} 2-layer train: loss {float(lg)} on "
                             f"the card, {float(lc)} on the CPU")
    worst = {}
    for (path, a), (_, b) in zip(leaves_with_paths(gg),
                                 leaves_with_paths(gc)):
        path = "/".join(path)
        a, b = a.float().cpu(), b.float()
        r = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst[path] = r
        if not torch.isfinite(a).all() or r > 2e-2:
            raise AssertionError(f"{name} 2-layer train: gradient {path}: "
                                 f"max abs error {r:.4f} of its largest "
                                 f"value")
    return dict(loss_rel=rel, worst_leaf=max(worst, key=worst.get),
                worst=max(worst.values()))


def check_train_resume(name: str, seq: int, batch: int) -> dict:
    """Checkpoint and resume through ``train``: 3 steps of a 2-layer
    full-width model with a checkpoint after step 2 (``save(block=
    False)``, as ``train`` saves) and at the end; the last checkpoint is
    removed and a second ``train`` from a fresh seeded init resumes from
    step 2.  Its first loss must be bitwise the uninterrupted run's third
    (the forward on the card is deterministic; the backward's atomics,
    the embedding's gradient, are not, so later steps may differ in the
    last bits).  Returns both losses."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train
    small = dataclasses.replace(get_config(name), n_layers=2)
    ckpt = os.path.join(SCRATCH, "ckpt", name)
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(n_steps=3, log_every=1, ckpt_dir=ckpt, ckpt_every=2,
              opts=_train_opts(seq), device="cuda")
    shape = ShapeConfig("train", seq, batch, "train")
    _, full, _ = train(small, shape, **kw)
    shutil.rmtree(os.path.join(ckpt, "step_00000003"))
    _, resumed, _ = train(small, shape, resume=True, **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    if [h["step"] for h in resumed] != [2] or \
            resumed[0]["loss"] != full[2]["loss"]:
        raise AssertionError(f"{name} resume: {resumed} against the "
                             f"uninterrupted {full}")
    return dict(uninterrupted=full[2]["loss"], resumed=resumed[0]["loss"])


def training_phase(card: str) -> dict:
    """Train both paths, the 2-layer CPU check and the resume; prints what
    it measured with the card's name and power limit.  Returns {path:
    train_path's result}."""
    runs = {}
    for name in TRAIN_PATHS:
        runs[name] = train_path(name)
        torch.cuda.empty_cache()
        shown = {k: v for k, v in runs[name].items() if k != "profiler"}
        print(f"train {name} ({card}): {json.dumps(shown)}; profiler "
              f"{json.dumps(runs[name].get('profiler'))}", flush=True)
    cpu = check_train_against_cpu("qwen2-1.5b", 64, 0)
    print(f"qwen2-1.5b: 2-layer full-width train step (B=2, S=64) vs CPU "
          f"bf16 plain: {json.dumps(cpu)}", flush=True)
    res = check_train_resume("hymba-1.5b", 512, 2)
    print(f"hymba-1.5b: 2-layer full-width resume from an async checkpoint: "
          f"bitwise equal loss {json.dumps(res)}", flush=True)
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    card = card_line()
    print(f"card: {card}", flush=True)
    seconds, ptxas = build_kernels()
    print(f"build_s: {seconds:.1f}", flush=True)
    for line in ptxas:
        print(f"ptxas {line}", flush=True)
    sass = check_sass()
    print(f"sass: every dot_general leaf's line has SASS instructions: "
          f"{json.dumps(sass)}", flush=True)
    errs, ratios = check_kernels()
    print(f"kernel checks passed: max abs err {errs}, largest row "
          f"err / row max {ratios}", flush=True)
    train_errs, grad_errs = check_kernel_grads()
    print(f"kernel forward checks at the training shapes passed: max abs "
          f"err {json.dumps({'/'.join(k): v for k, v in train_errs.items()})}"
          f"; gradient checks (the recompute's wiring) passed: max abs err "
          f"{grad_errs}; the forward ran the port's kernels, the backward "
          f"none", flush=True)
    # every timing under torch.profiler before the first profiled run:
    # the training kernels first, the windows of whole steps last
    train_times = {}
    for name in TRAIN_PATHS:
        train_times[name] = time_train_kernels(name)
        for kname, (t, calls) in train_times[name].items():
            print(f"{name} train {kname}: device {json.dumps(t)}; "
                  f"back-to-back call {json.dumps(calls)}", flush=True)
    names = list(PATHS) + list(SERVING_PATHS)
    params = {name: init_params(name) for name in names}
    times = {name: time_path(name, params[name]) for name in names}
    for name in TRAIN_PATHS:
        print(f"{name} train step ({card}): {json.dumps(time_train(name))}",
              flush=True)
    runs = {name: serve_path(name, params.pop(name)) for name in PATHS}
    runs.update({name: serving_path(name, params.pop(name))
                 for name in SERVING_PATHS})
    run_sweep_on_card()
    train_runs = training_phase(card)

    kernels = []
    for path, run in runs.items():
        for kname, (t, _) in times[path].items():
            kernels.append(dict(
                name=kname, path=path, route="cuda",
                source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                launches=run["launches"][kname], max_abs_err=errs[kname],
                **t))
    for name, run in train_runs.items():
        for kname, (t, _) in train_times[name].items():
            kernels.append(dict(
                name=kname, path=f"{name}:train", route="cuda",
                source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                launches=run["launches"][kname],
                max_abs_err=train_errs[(name, kname)],
                **t))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
