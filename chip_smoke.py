"""Drive the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Every path runs at published widths and full depth but qwen2-1.5b's,
granite-moe-1b-a400m's, hymba-1.5b's and xlstm-125m's, which run at 4 of
28, 4 of 24, 4 of 32 and 6 of 12 layers (``CUT_DEPTH``; the multi-rank
phase's granite-moe at 8, ``MR_LAYERS``), musicgen-large's training
at 24 of 48 (its serve at 48), and the profiled serves of starcoder2-15b
at 4 of 40 and of the MAMBA path (hymba-1.5b's widths, MAMBA blocks
alone, ``MAMBA_PATH``) at 6 of 32.  Phases, each of which raises
(non-zero exit, no result line) on failure:

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
   reference value, at the attention paths' shapes (qwen2, hymba,
   granite-moe at D = 64, G = 2, and the single-card configurations of
   phase 3b: G = 8 at 64 q heads, G = 12, G = 1 at D = 64, llava's vlm
   prefill at S = 6144 and its decode after it) and at each kernel's
   edges (ragged tiles and splits, small windows, q_offset, G = 1, 8, 12,
   16, 20, 24 and 32 at both head dims, peaked scores); past 16 q heads a
   kv head the decode kernel runs tiles of 16 q rows, each bitwise equal
   to its q heads run alone, and at G <= 16 it gives bitwise the outputs
   of the kernel before tiles at qwen2's decode shape
   (``check_decode_tiles``);
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
3b. serve the reference's single-card configurations at full width and
   depth, one at a time, each freed before the next: qwen3-32b,
   starcoder2-15b, yi-6b, llava-next-mistral-7b and musicgen-large, and
   the MAMBA path (hymba-1.5b's widths with MAMBA blocks alone, 32
   layers: 96 SSD launches, no attention launch, in a serve).  For
   each: the bytes ``launch.specs.params_struct`` reckons, the card's free
   memory, the init's peak (within the weights plus one fp32 slice plus 1
   GiB) and what it leaves allocated, held exactly (``init_big``: the
   parameters' blocks only, plus the allocator's unsplit remainders); its
   steps broken down under torch.profiler as in 4 (its
   kernels, and llava's at its vlm prefill over 6144 positions, are
   timed as in 4 before this phase); ``serve`` without a profiler,
   launch counters set to 0 just before and read just after (exact
   counts), prefill and decode ms and tokens/s, every batch replayed;
   llava's vlm prefill (4 x 6144: 2880 seeded patch embeddings before
   3264 tokens) and musicgen's audio prefill on frame embeddings, each
   followed by 31 decode steps (musicgen's on frame embeddings), exact
   launch counts, finite logits, timed and broken down; the 2-layer
   full-width model against the CPU as in 6, on tokens and, for the two
   frontends, on their embeddings; then, alone on the card, a donated
   train step of musicgen-large (on tokens and on audio frames, 4 x 512)
   and of yi-6b (4 x 512; the run fails unless the reckoned peak,
   ``launch.specs.train_memory``, leaves 2 GiB of the card free), timed
   as in 4, its ``torch.cuda.max_memory_allocated`` held to the reckoning
   within 2 GiB;
3c. serve granite-4.0-h-small (the port's own configuration: Mamba-2
   mixers at state 128 beside NoPE GQA and a shared-expert MoE) at its
   published widths and depth with 18 of its 72 experts held, alone on the
   card (``granite4h_path``): one batch of 2 x 16384 prompts and 16
   tokens at exact launch counts (36 SSD scans and 4 flash prefills a
   prefill, 4 flash decodes a decode step), the decode logits through the
   mixed cache held to the plain reference's full forward (its scan at
   state 128 is timed with the other kernels, before 3b);
4. time a train step of qwen2-1.5b, hymba-1.5b, granite-moe-1b-a400m,
   xlstm-125m and the MAMBA path at full width under torch.profiler
   (host wall, device busy, idle share, tokens/s, the kernels' share) on
   a repeated batch whose loss must fall, and split one step's device time
   by the train step's named scopes (``fwd_bwd``, its forward and its
   backward with the remat recompute, ``optimizer``; qwen2's optimizer
   also with the functional, not donated, step); print each step's peak
   memory beside its reckoning; time each kernel at the training shapes
   (the single-card training paths' too); time each kernel at
   each serving path's shapes, its plain version and one
   library call computing the same function where there is one (a
   yardstick the port never calls), beside the least time the card could
   take for the same work (the kernel modules' own ``work`` counts), and
   the decode kernel at every split count the planner could choose and
   at G = 24 (two tiles of q rows; no main path), and
   the SSD scan's device time by step; break a serving step's time down
   by device kernel.  All of this runs under torch.profiler before the
   first profiled serve, and every path's kernels (those of 3b too) are
   timed before the first window of whole steps (see ``time_path``);
5. serve qwen2-1.5b and then hymba-1.5b at full width with
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
   none for it) at full width under the always-on serving
   profiler (``serve(serving=...)``, the governor at budget 0.5), launch
   counters set to 0 just before and read just after; check launches,
   every request batch's GPU time in both phases from the aggregated
   database and PC samples in both attention kernels' interiors; print
   the governor's final level and the serve wall over that without a
   profiler; replay and the 2-layer CPU check as in 6 (profiles and
   databases under ``build/chip_smoke``);
8. run the port's six-scenario serving sweep (``serving.sweep``) on the
   card and check every row's per-request attribution;
9. train qwen2-1.5b and granite-moe-1b-a400m (6 steps of 4 x 512, under
   the port's profiler), hymba-1.5b (3 steps of 2 x 1536), xlstm-125m
   (6 steps of 4 x 256, the JAX package's CLI defaults), the MAMBA path
   (3 steps of 2 x 1536, 32 layers), musicgen-large on tokens and on
   audio frames (4 steps of 4 x 512) and yi-6b (3 steps of 4 x 512,
   after the reckoning's check of 3b again) at full width through
   ``repro_torch.launch.train.train``
   (the donated step), launch counters set to 0
   just before and read just after each: the launch counts the
   remat policy implies, finite losses, one custom-call per launch in the
   registered train step, PC samples under its placeholder and in the
   flash kernel's dot_general leaves, and each named scope's share of
   them (printed beside the scope's device ms from phase 4); one 2-layer
   full-width train step (loss and every gradient leaf) of qwen2,
   granite-moe, xlstm, the MAMBA path, musicgen-large (both kinds of
   batch) and yi-6b against the same bf16 weights on the CPU; resumes
   (hymba, the MAMBA path, musicgen-large on frames, yi-6b) from an
   async checkpoint whose first loss is bitwise the uninterrupted run's;
10. serve starcoder2-15b at full width and 4 layers under the port's
   profiler and check, as in 5, PC samples that reach the decode
   kernel's dot_general leaves at G = 12; then the MAMBA path at 6
   layers, whose samples must reach the SSD scan's dot_general leaves;
   print one line of everything the MAMBA path measured, with the card.
   Nothing is timed under torch.profiler after it;
11. run the eight examples that port the JAX package's examples
   (``examples/torch_*.py``) with ``--device cuda``, all at once, each
   exiting 0; ``torch_find_redundant_sync`` finds a context with diff >
   0, ``torch_blame_analysis`` blames its two stalls first, each for
   its measured length, ranked as those lengths rank them (the JAX
   example's ranking, ``host_preprocessing`` then ``runtime_jit_compile``,
   when each sleep lasts its length) and
   ``torch_serve_batch``'s profile has PC samples in the flash prefill
   and decode kernels' calls;
12. multi-rank (``multi_rank_phase``, in child processes: this process
   joins no group): granite-moe-1b-a400m at full width and 8 layers, 3
   steps of 4 x 512 through ``train(mesh=..., strategy="tp")`` on one
   rank over NCCL (mesh (1, 1)) against the unsharded ``train``, then on
   two ranks sharing the card over gloo (mesh (1, 2), 8 q / 4 kv heads a
   rank), with one layer's attention gathered against the whole
   layer's, the sharded prefill and decode steps against the unsharded
   ones and a sharded checkpoint restored whole, bitwise; each rank's
   step wall, busy and idle share, collectives and peak memory.  Also:
   the dry run of the same step (``launch.dryrun.dry_run`` on
   the live mesh, recorded on meta tensors) held to it, at (1, 1) its
   FLOPs to ``FlopCounterMode``'s over the step on the card, its peak to
   ``max_memory_allocated`` within 10% and its roofline to at most the
   device's busy time, at (1, 2) its collectives to the collective ops
   torch.profiler finds in a step, and the port's collective op events
   to those calls plus the calls the remat's dispatch mode enters
   (``collective_op_events``); a serve with the cache split over its
   sequence (``kv_seq_axis="model"``: 4 x 512 prefill, 7 decode steps,
   every kv head of 260 slots a rank, the ranks' partial attentions
   merged by log-sum-exp) against the unsharded steps; the decode kernel
   with its lse output at those shapes, and at length 0, against its
   plain version; and one profiled train step a rank, each rank's
   directory merged by ``aggregate``.

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
    r"flash_fwd_kernel|flash_decode_kernel|ssd_\w+_kernel|uncombine_kernel"
    r"|combine_kernel")
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
# is cut from 512 to 64: torch.export unrolls the sLSTM's time loop
# (about 74 ops a token), and on the card's host the prefill step's
# export took 235.6 s at 512 (38,931 ops), 56.9-63.8 s at 112 (9471)
SERVING_PATHS = {
    "granite-moe-1b-a400m": dict(prompt=512, cpu_prompt=64, cpu_window=0),
    "xlstm-125m": dict(prompt=64, cpu_prompt=64, cpu_window=0,
                       cpu_blocks=("mlstm", "slstm"))}
# where the serving paths and the sweep write their profiles and
# databases (tens of MB a model)
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
BUDGET = 0.5     # the serving sweep's overhead budget
KERNELS = ("flash_attention", "flash_decode", "ssm_scan", "moe_combine",
           "moe_uncombine")
COUNTERS = ("flops", "mxu_flops", "hbm_bytes", "inst_executed", "active_ns",
            "elapsed_ns")
SOURCES = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:36"),
           "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:30"),
           "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan.py:34"),
           # no TPU kernel: the JAX package's combine is XLA ops
           "moe_combine": ("src/repro_torch/csrc/moe_combine.cu",
                           "src/repro/models/moe.py:121 (XLA ops)"),
           "moe_uncombine": ("src/repro_torch/csrc/moe_uncombine.cu",
                             "src/repro/models/moe.py:121 (its autograd)")}
# the MoE combine's checks (T tokens, top k, width d, expert rows R): the
# granite.train1k cell's step (8 x 1024 tokens, top 8 of 32 experts,
# capacity 2560), granite-moe's training path here (4 x 512, capacity
# 640), a decode step's (4 tokens, capacity 8) and a width no 16-byte load
# divides (the kernels' element-wise path); the share of assignments sent
# to the dump row; dw against the plain autograd's, relative to its
# largest (y and d_eo must be bitwise)
COMBINE_SHAPES = {"train8k": (8192, 8, 1024, 32 * 2560),
                  "train": (2048, 8, 1024, 32 * 640),
                  "decode": (4, 8, 1024, 32 * 8),
                  "narrow": (64, 4, 102, 8 * 40)}
COMBINE_DROPS = (0.0, 0.3, 0.6)
COMBINE_DW_TOL = 1e-5
# the drop share the combine's timings take: granite.train1k's window
# drops 25-33% of its assignments (PERF.md)
COMBINE_TIMED_DROP = 0.3


# the first four paths run every path (serving, the step breakdowns,
# training) at a cut depth and published widths, 4 layers each (xlstm one
# period of 6 of 12): their host-bound steps and exports took the most
# wall per check of the script (hymba's serving export 47 s at 8 layers,
# a full-depth train step 3.4 s for 0.94 s of device time; xlstm's export
# 46 s, 64,000 device kernels a train step; qwen2's and granite-moe's
# profiled exports 19-46 s a step, about linear in layers), and with
# qwen2, granite-moe and hymba at 8 layers and the multi-rank phase's dry
# run, seq-split serve and profiled steps the script took 962.7 s on an
# NVIDIA H100 80GB HBM3 at 700 W, on a host whose wall varies 1.3-1.7x;
# the MAMBA path adds about 85 s (its pieces took 83 s alone on such a
# card), so qwen2, granite-moe and hymba (whose SSD scan the MAMBA path
# also runs at full depth) run at 4 layers: with them at 6 the script
# took 997.7 s on a host 1.22x slower than another's
CUT_DEPTH = {"qwen2-1.5b": 4, "granite-moe-1b-a400m": 4, "hymba-1.5b": 4,
             "xlstm-125m": 6}
# the MAMBA path: hymba-1.5b's published widths (d 1600, 25 heads of 64,
# state 16, vocab 32,001) with MAMBA blocks alone, the mamba mixer
# through the SSD kernel and no FFN, at hymba's full depth of 32 layers
# (no configuration of the reference has a MAMBA block; its
# ``_init_entry`` builds one); it serves and trains at hymba's shapes,
# and under the port's profiler at 6 layers (its export costs scale with
# layers)
MAMBA_PATH = "hymba-1.5b:mamba"
# granite-4.0-h-small as one card of a four-card expert split holds it:
# 2 x 16384 prompts, 16 decode steps; the capacity admits every
# assignment in this path (a decode step's capacity differs from a full
# forward's otherwise), so decode can be held to the reference's forward
GRANITE4H = "granite-4.0-h-small"
G4H_PROMPT, G4H_BATCH, G4H_DECODE, G4H_HELD = 16384, 2, 16, 18
G4H_LOGIT_TOL = 0.035    # the prefill cells' logit_err limit
MAMBA_PROFILED_LAYERS = 6


def _config(name: str):
    """A path's configuration: published widths, at ``CUT_DEPTH``'s
    depth where it is cut; ``<name>:mamba`` is ``name``'s widths and
    depth with ``block_pattern=(MAMBA,)``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MAMBA
    base, _, kind = name.partition(":")
    cfg = get_config(base)
    if kind == "mamba":   # named apart: its profiles and databases too
        return dataclasses.replace(cfg, block_pattern=(MAMBA,),
                                   name=f"{base}-mamba")
    return dataclasses.replace(cfg,
                               n_layers=CUT_DEPTH.get(name, cfg.n_layers))


def _has_mamba(cfg) -> bool:
    """Whether a stack runs the mamba mixer (the SSD scan)."""
    from repro_torch.configs.base import HYBRID, MAMBA
    return any(k in (HYBRID, MAMBA) for k in cfg.blocks)


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
    build.build(["flash_attention", "decode_attention", "ssm_scan",
                 "moe_combine", "moe_uncombine"])
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


def _combine_capacity(cfg, tokens: int) -> int:
    """An expert's slots for ``tokens`` tokens routed on one device, as
    ``models.moe.moe_ffn`` sizes them."""
    m = cfg.moe
    return max(m.top_k, int(tokens * m.top_k / m.n_experts
                            * m.capacity_factor))


def _combine_inputs(T: int, k: int, d: int, R: int, drop: float,
                    dtype=torch.bfloat16, seed: int = 11) -> tuple:
    """The MoE combine's operands on the card, drawn on the CPU from
    ``seed``: eo (R, d) in ``dtype`` and w = gates * keep (T, k) fp32,
    leaves that require grad, slot (T * k,) int64 with round(drop * T * k)
    assignments at the dump row R and the kept ones at distinct random
    rows, dy (T, d) fp32 and keep.  Returns (eo, slot, w, dy, keep, kept
    rows)."""
    gen = torch.Generator().manual_seed(seed)
    n = T * k
    n_keep = n - round(drop * n)
    keep = torch.zeros(n, dtype=torch.bool)
    keep[torch.randperm(n, generator=gen)[:n_keep]] = True
    slot = torch.full((n,), R, dtype=torch.long)
    slot[keep] = torch.randperm(R, generator=gen)[:n_keep]
    eo = torch.randn((R, d), generator=gen).to(dtype)
    gates = torch.rand((T, k), generator=gen)
    gates = gates / gates.sum(-1, keepdim=True)
    w = gates * keep.reshape(T, k)
    dy = torch.randn((T, d), generator=gen)
    return (eo.cuda().requires_grad_(True), slot.cuda(),
            w.cuda().requires_grad_(True), dy.cuda(), keep.cuda(), n_keep)


def check_combine() -> dict:
    """The MoE combine's two kernels through the wrappers the main paths
    call (``ops.moe_combine`` and its registered backward, the adjoint
    ``ops.moe_uncombine``) against the plain version (the combine as the
    MoE layer computed it before the op, ``moe_combine_plain``, and its
    autograd) at every ``COMBINE_SHAPES`` shape and ``COMBINE_DROPS``
    share, bf16 and fp32 rows: y and d_eo bitwise, dw within
    ``COMBINE_DW_TOL`` of its largest value and 0 at the dump row, each
    wrapper's ``launches`` counter bumped once a call.  A forward runs one
    device kernel, an adjoint the fill of d_eo and one kernel; a half
    precision row or an int32 slot is refused.  Returns {"moe_combine": y
    max abs err, "moe_uncombine": d_eo max abs err, "dw_rel": the largest
    dw error over its largest value, "kernels": {forward, adjoint: device
    kernel names}}."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import ops
    out = {"moe_combine": 0.0, "moe_uncombine": 0.0, "dw_rel": 0.0}
    for label, (T, k, d, R) in COMBINE_SHAPES.items():
        for drop in COMBINE_DROPS:
            for dtype in (torch.bfloat16, torch.float32):
                eo, slot, w, dy, keep, _ = _combine_inputs(T, k, d, R, drop,
                                                           dtype)
                want = mc.moe_combine_plain(eo, slot, w)
                d_eo0, dw0 = torch.autograd.grad(want, (eo, w), dy)
                before = (ops.moe_combine.launches,
                          ops.moe_uncombine.launches)
                got = ops.moe_combine(eo, slot, w)
                d_eo1, dw1 = torch.autograd.grad(got, (eo, w), dy)
                torch.cuda.synchronize()
                case = (label, drop, str(dtype))
                bumped = (ops.moe_combine.launches - before[0],
                          ops.moe_uncombine.launches - before[1])
                if bumped != (1, 1):
                    raise AssertionError(f"moe_combine {case}: launches "
                                         f"counted {bumped}, want (1, 1)")
                e_y = float((got - want).detach().abs().max())
                e_eo = float((d_eo1.float() - d_eo0.float()).abs().max())
                if not (torch.equal(got, want) and torch.equal(d_eo1,
                                                               d_eo0)):
                    raise AssertionError(f"moe_combine {case}: y or d_eo "
                                         f"not bitwise the plain version's "
                                         f"(max abs err {e_y}, {e_eo})")
                dw_rel = float((dw1 - dw0).abs().max()
                               / dw0.abs().max().clamp_min(1e-30))
                at_dump = dw1[~keep.reshape(T, k)]
                if dw_rel > COMBINE_DW_TOL or bool(at_dump.any()):
                    raise AssertionError(f"moe_combine {case}: dw off the "
                                         f"plain autograd's by {dw_rel} of "
                                         f"its largest, or not 0 at the "
                                         f"dump row")
                out["moe_combine"] = max(out["moe_combine"], e_y)
                out["moe_uncombine"] = max(out["moe_uncombine"], e_eo)
                out["dw_rel"] = max(out["dw_rel"], dw_rel)
    eo, slot, w, dy, _, _ = _combine_inputs(*COMBINE_SHAPES["train"],
                                            COMBINE_TIMED_DROP)
    eo, w = eo.detach(), w.detach()
    out["kernels"] = {
        "forward": sorted(device_ms_by_kernel(
            lambda: ops.moe_combine(eo, slot, w), iters=5)),
        "adjoint": sorted(device_ms_by_kernel(
            lambda: ops.moe_uncombine(dy, eo, slot, w), iters=5))}
    fwd, adj = out["kernels"]["forward"], out["kernels"]["adjoint"]
    if len(fwd) != 1 or not re.search(r"\bcombine_kernel", fwd[0]) or \
            len(adj) != 2 or not any("uncombine_kernel" in n for n in adj) \
            or not any("memset" in n.lower() for n in adj):
        raise AssertionError(f"moe_combine: device kernels {out['kernels']}"
                             f"; want the forward's kernel alone, and the "
                             f"adjoint's fill and kernel")
    bad = torch.zeros((8, 16), dtype=torch.float16, device="cuda")
    slot4 = torch.zeros(4, dtype=torch.long, device="cuda")
    w4 = torch.zeros((2, 2), device="cuda")
    for args, msg in (((bad, slot4, w4), "float32 or bfloat16"),
                      ((bad.float(), slot4.int(), w4), "int64")):
        try:
            ops.moe_combine(*args)
        except ValueError as e:
            if msg not in str(e):
                raise
        else:
            raise AssertionError(f"moe_combine took "
                                 f"{[a.dtype for a in args]}")
    return out


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
            # the single-card configurations' prefills: qwen3-32b (G = 8
            # at 64 q heads), starcoder2-15b (G = 12), yi-6b, musicgen-large
            # (G = 1, D = 64), llava-next-mistral-7b's text and its vlm
            # prefill over 2880 patches and 3264 tokens (S = 6144)
            (B, 512, 512, 64, 8, 128, 0, 0, 1.0),
            (B, 512, 512, 48, 4, 128, 0, 0, 1.0),
            (B, 512, 512, 48, 4, 128, 0, 0, 4.0),
            (B, 512, 512, 32, 4, 128, 0, 0, 1.0),
            (B, 512, 512, 32, 32, 64, 0, 0, 1.0),
            (B, 512, 512, 32, 8, 128, 0, 0, 1.0),
            (B, 6144, 6144, 32, 8, 128, 0, 0, 1.0),
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
    # granite-moe's cache at D=64 G=2; the single-card configurations':
    # qwen3-32b (G = 8), starcoder2-15b (G = 12), yi-6b (G = 8),
    # musicgen-large (D = 64, G = 1) and llava-next-mistral-7b's cache
    # after its vlm prefill (G = 4, 6144 + 32 slots)
    for h, hkv, d, smax in ((12, 2, 128, 544), (12, 2, 128, 4096),
                            (25, 5, 64, 1024), (16, 8, 64, 544),
                            (64, 8, 128, 544), (48, 4, 128, 544),
                            (32, 4, 128, 544), (32, 32, 64, 544),
                            (32, 8, 128, 6176)):
        for q_scale, kv_scale in ((0.5, 0.5), (4.0, 1.0)):
            q = _randn((B, h, d), gen, q_scale)
            kc = _randn((B, smax, hkv, d), gen, kv_scale)
            vc = _randn((B, smax, hkv, d), gen, kv_scale)
            for length in (1, smax // 3, smax):
                note("flash_decode", ops.flash_decode(q, kc, vc, length),
                     fd.flash_decode_plain(q, kc, vc, length))
    # the one-launch cluster kernel's edges, each twice (bitwise equal):
    # lengths off 16/32/64 and 1, G = 1, 8, 12 and 16 (the m16 tile's
    # rows g + 8 real from G = 9 on) at both head dims, flat and peaked
    # scores
    for h, hkv, d, smax, lengths in (
            (12, 2, 128, 544, (1, 17, 33, 100, 527)),
            (25, 5, 64, 1024, (1, 47, 1000)),
            (16, 8, 64, 544, (1, 33, 528)),
            (2, 2, 128, 300, (1, 31, 299)), (2, 2, 64, 300, (5, 129)),
            (16, 2, 128, 600, (1, 63, 600)), (16, 2, 64, 600, (9, 257)),
            (48, 4, 128, 544, (1, 17, 100, 527)),
            (12, 1, 64, 300, (1, 31, 299)), (16, 1, 128, 600, (1, 63, 600)),
            (32, 2, 64, 600, (9, 257, 600)),
            (32, 2, 128, 1000, (1, 333, 999)),
            # past one tile of q rows (the kernel takes any G): G = 20 (a
            # partial second tile), 24 and 32 at both head dims
            (40, 2, 64, 544, (1, 100, 527)),
            (48, 2, 64, 600, (9, 257, 600)), (96, 4, 128, 544, (1, 100, 527)),
            (64, 2, 64, 1000, (1, 333, 999)), (32, 1, 128, 600, (1, 63, 600))):
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
                                            (25, 5, 64, 1024, 897, (8, 128)),
                                            (48, 4, 128, 544, 449, (8, 64)),
                                            (32, 2, 64, 1024, 897, (8, 128)),
                                            (32, 2, 128, 600, 385, (3, 192))):
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
            (1, 500, 2, 120, 50, 225, True, None),
            # state 128 (granite-4.0-h): two heads a block at chunk 64, the
            # plan's halved chunk (256 -> 128, one head) under a strong
            # decay, hd 128 (256 -> 64), and the cell's shape
            (2, 1024, 8, 64, 128, 64, True, None),
            (1, 300, 3, 64, 128, 256, True, -20.0),
            (1, 500, 2, 128, 128, 256, True, None),
            (2, 16384, 128, 64, 128, 64, False, None)]:
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
    print(f"flash_decode q tiles, bitwise: "
          f"{json.dumps(check_decode_tiles(gen))}", flush=True)
    # one device kernel per decode call, at the paths' shapes, at G = 16
    # and past one tile of q rows (G = 24 and 32)
    for h, hkv, d, smax in ((12, 2, 128, 544), (25, 5, 64, 1024),
                            (16, 8, 64, 544), (64, 8, 128, 544),
                            (48, 4, 128, 544), (32, 32, 64, 544),
                            (32, 8, 128, 6176), (32, 2, 64, 600),
                            (32, 2, 128, 600), (48, 2, 64, 600),
                            (96, 4, 128, 544), (64, 2, 64, 1000),
                            (32, 1, 128, 600)):
        q = _randn((B, h, d), gen, 0.5)
        kc = _randn((B, smax, hkv, d), gen, 0.5)
        distinct, per_call = device_kernels(
            lambda: ops.flash_decode(q, kc, kc, smax - 7))
        if distinct != 1 or per_call > 1:
            raise AssertionError(f"flash_decode ran {distinct} distinct "
                                 f"device kernels, {per_call} per call; "
                                 f"want one")
    comb = check_combine()
    errs.update(moe_combine=comb["moe_combine"],
                moe_uncombine=comb["moe_uncombine"])
    print(f"moe_combine and moe_uncombine: y and d_eo bitwise the plain "
          f"version's at {json.dumps(COMBINE_SHAPES)} x drops "
          f"{list(COMBINE_DROPS)} x bf16 and fp32 rows; dw's largest error "
          f"over its largest value {comb['dw_rel']!r}; device kernels "
          f"{json.dumps(comb['kernels'])}", flush=True)
    return errs, ratios


# the decode kernel's output at qwen2's decode shape (B = 4, 12 / 2 heads,
# D = 128, length 528 of 544, the planner's 8 splits of 66 keys) on
# ``_decode_inputs(0)``, as the kernel gave it before it had tiles of q
# rows (when it held G <= 16), on an "NVIDIA H100 80GB HBM3": sha256 of
# the bf16 bytes
DECODE_BEFORE_TILES = (
    (4, 12, 2, 128, 544, 528),
    "410a5fcd71b88824cd1fdd409fd5277fb2c07be3404276da06fb8e01225a302a")


def _decode_inputs(seed: int, b: int, h: int, hkv: int, d: int,
                   smax: int) -> tuple:
    """q (b, h, d) and caches (b, smax, hkv, d), bf16 on the card, from
    numpy normals (the same bytes on every card and torch version)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16).cuda()
        for shape in ((b, h, d), (b, smax, hkv, d), (b, smax, hkv, d)))


def check_decode_tiles(gen) -> dict:
    """The decode kernel's tiles of q rows, bitwise.  Past 16 q heads a
    kv head (G = 24, 32 at both head dims, and G = 20's partial tile),
    each tile's rows equal the kernel run on that tile's q heads alone
    (G <= 16, one tile) at the same splits; at G <= 16 the kernel gives
    the outputs it gave before tiles (``DECODE_BEFORE_TILES``: qwen2's
    decode shape at the planner's splits, sha256 of the bytes), and the
    planner's splits are the ones it chose before (``plan_splits`` with
    one tile).  Returns {case: tiles}."""
    import hashlib
    from repro_torch.kernels import decode_attention as fd
    out = {}
    for h, hkv, d, smax, length, splits in (
            (48, 2, 64, 600, 577, (8, 73)), (96, 4, 128, 544, 528, (4, 132)),
            (64, 2, 64, 1000, 999, (8, 125)), (64, 2, 128, 600, 450, (2, 225)),
            (40, 2, 64, 544, 300, (5, 60))):
        q = _randn((B, h, d), gen, 4.0)
        kc = _randn((B, smax, hkv, d), gen)
        vc = _randn((B, smax, hkv, d), gen)
        full = _decode_at(q, kc, vc, length, *splits)
        g = h // hkv
        tiles = fd.q_tiles(h, hkv)
        for t in range(tiles):
            rows = torch.arange(hkv, device="cuda")[:, None] * g \
                + torch.arange(t * fd.Q_TILE, min(g, (t + 1) * fd.Q_TILE),
                               device="cuda")
            alone = _decode_at(q[:, rows.flatten()].contiguous(), kc, vc,
                               length, *splits)
            torch.cuda.synchronize()
            if not torch.equal(full[:, rows.flatten()], alone):
                raise AssertionError(f"flash_decode tile {t} of "
                                     f"{(h, hkv, d)} differs from its q "
                                     f"heads run alone")
        out[f"H{h}/Hkv{hkv}/D{d}"] = tiles
    (b, h, hkv, d, smax, length), want = DECODE_BEFORE_TILES
    q, kc, vc = _decode_inputs(0, b, h, hkv, d, smax)
    plan = fd.plan_splits(b, hkv, length, fd._sm_count(q.device),
                          fd.q_tiles(h, hkv))
    if plan != (8, 66):
        raise AssertionError(f"flash_decode: the planner now cuts qwen2's "
                             f"decode into {plan}, before tiles (8, 66)")
    got = _decode_at(q, kc, vc, length, *plan)
    torch.cuda.synchronize()
    digest = hashlib.sha256(got.view(torch.int16).cpu().numpy().tobytes()
                            ).hexdigest()
    if digest != want:
        raise AssertionError(f"flash_decode at G <= 16 no longer gives the "
                             f"outputs of the kernel before tiles: sha256 "
                             f"{digest}, want {want}")
    out["before_tiles"] = digest
    return out


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
    odd = [{k: n for k, n in w.items() if n % iters} for w in seen]
    raise RuntimeError(f"torch.profiler dropped device records in every "
                       f"window of {iters} calls: the counts that are not "
                       f"a multiple, by window, {odd}")


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
        None, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_decode_fwd_bf16")
    return out


def time_kernels(cfg, prompt: int) -> tuple:
    """Each kernel of the path (through the main path's wrapper), its plain
    version, a library yardstick and the bound, at the path's shapes:
    prefill attention over the prompt, a decode step against the cache a
    mid-generation step sees, and the SSD scan of a prefill.  Returns
    ({kernel: times}, {split count: decode kernel device ms} over every
    count up to ``MAX_SPLITS``, with the planner's own count, {device
    kernel: ms} of the SSD scan's steps, empty without a mamba layer).
    A stack without attention (MAMBA blocks alone) times the scan
    alone; one with MoE layers also times the combine of a decode
    step."""
    from repro_torch.configs.base import HYBRID, SWA
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    windowed = any(k in (SWA, HYBRID) for k in cfg.blocks)
    window = cfg.window if windowed else 0
    res, steps = {}, {}
    if _has_mamba(cfg):
        # serve's ssm_chunk
        fns, flops, nbytes = _ssm_fns(gen, B, prompt, h, d, cfg.ssm_state,
                                      min(64, prompt))
        res["ssm_scan"] = _timed(fns, flops, nbytes)
        steps = {(PORT_KERNEL.search(k) or re.search(".*", k)).group(0): v
                 for k, v in device_ms_by_kernel(fns["ms"]).items()}
    if not _has_attention(cfg):
        return res, {}, steps
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
    plan = fd.plan_splits(B, hkv, length, fd._sm_count(qd.device),
                          fd.q_tiles(h, hkv))
    if cfg.moe_layers():
        # the combine of a decode step (B tokens), most of a serve's
        # launches; no assignment dropped
        res["moe_combine"] = _timed(*_combine_fns(
            B, cfg.moe.top_k, cfg.d_model,
            cfg.moe.n_experts * _combine_capacity(cfg, B), 0.0))
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


def _combine_fns(T: int, k: int, d: int, R: int, drop: float,
                 adjoint: bool = False) -> tuple:
    """({ms: the wrapper, plain_ms: the plain version}, FLOPs, bytes) of
    the MoE combine (``adjoint``: its adjoint, whose plain version is the
    plain combine's autograd backward alone, on a kept graph) at these
    shapes with bf16 rows, ``drop`` of the assignments at the dump row,
    on fresh inputs; no single PyTorch call computes either."""
    from repro_torch.kernels import moe_combine as mc
    from repro_torch.kernels import ops
    eo, slot, w, dy, _, kept = _combine_inputs(T, k, d, R, drop)
    e, g = eo.detach(), w.detach()
    if not adjoint:
        fns = dict(ms=lambda: ops.moe_combine(e, slot, g),
                   plain_ms=lambda: mc.moe_combine_plain(e, slot, g))
        return (fns, *mc.work(T, k, d, R, kept=kept))
    y = mc.moe_combine_plain(eo, slot, w)
    fns = dict(ms=lambda: ops.moe_uncombine(dy, e, slot, g),
               plain_ms=lambda: torch.autograd.grad(y, (eo, w), dy,
                                                    retain_graph=True))
    return (fns, *mc.uncombine_work(T, k, d, R, kept=kept))


def time_combine_cell() -> dict:
    """The MoE combine's two kernels (``_timed``) at the granite.train1k
    cell's shape (``COMBINE_SHAPES["train8k"]``) and the drop shares of
    its window (25-54%): {drop: {kernel: device times}}."""
    out = {}
    for drop in (0.25, COMBINE_TIMED_DROP, 0.54):
        out[drop] = {
            name: _timed(*_combine_fns(*COMBINE_SHAPES["train8k"], drop,
                                       adjoint=name == "moe_uncombine"))[0]
            for name in ("moe_combine", "moe_uncombine")}
    return out


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
        lambda: fd.flash_decode_cuda(qd, kc, kc, length))} \
        if _has_attention(cfg) else {}
    if _has_mamba(cfg):
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


def serve_launches(cfg) -> dict:
    """Each kernel's launches in one ``serve`` of ``N_REQUESTS`` in batches
    of ``B``: every attention layer's flash prefill once a prefill and its
    decode once a decode step, every mamba layer's (HYBRID or MAMBA) SSD
    scan once a prefill (decode is the O(1) recurrence), for the warm-up
    and each batch, and every MoE layer's combine once a prefill and once
    a decode step (no adjoint: nothing is differentiated)."""
    from repro_torch.configs.base import ATTN, HYBRID, MAMBA, SWA
    n_batches = -(-N_REQUESTS // B)
    n_attn = sum(k in (ATTN, SWA, HYBRID) for k in cfg.blocks)
    n_mamba = sum(k in (HYBRID, MAMBA) for k in cfg.blocks)
    n_moe = len(cfg.moe_layers())
    return {"flash_attention": n_attn * (n_batches + 1),
            "flash_decode": n_attn * ((GEN_LEN - 1) * n_batches + 1),
            "ssm_scan": n_mamba * (n_batches + 1),
            "moe_combine": n_moe * (GEN_LEN * n_batches + 2),
            "moe_uncombine": 0}


def run_serve(cfg, params, prompt: int) -> dict:
    """The main path: serve under the port's profiler, every kernel launch
    counter set to 0 just before and read just after."""
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
    want = serve_launches(cfg)
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
    want = {"prefill": set(), "decode_step": set()}
    if _has_attention(cfg):
        want["prefill"].add("flash_attention")
        want["decode_step"].add("decode_attention")
    if _has_mamba(cfg):
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
    from repro_torch.kernels import build, kernel_structures
    libs = build.build(["flash_attention", "decode_attention", "ssm_scan"])
    tables = {name: sass_lines(str(path), os.path.join(
        str(build.BUILD_DIR), "sass", name)) for name, path in libs.items()}
    checked = {}
    paths = [(name, spec["prompt"]) for name, spec in
             {**PATHS, **SERVING_PATHS, **BIG_PATHS}.items()]
    paths += [(name, spec["frontend_seq"]) for name, spec in BIG_PATHS.items()
              if spec.get("frontend_seq", spec["prompt"]) != spec["prompt"]]
    for name, prompt in paths:
        for ks in kernel_structures(_config(name), B, prompt,
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


def step_breakdown(cfg, params, prompt: int, n_decode: int = 8,
                   batch=None, embed=None) -> dict:
    """Where a serving step's time goes, under torch.profiler
    (``profiled_steps``): one prefill, ``n_decode`` decode steps.  The
    prefill takes ``batch`` (a frontend's, ``prompt`` positions long;
    zero tokens by default) and each decode step ``embed`` (an audio
    frame) or the prefill's argmax token."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    opts = _serve_opts(prompt)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    if batch is None:
        batch = {"tokens": torch.zeros((B, prompt), dtype=torch.long,
                                       device="cuda")}
    out = {}
    for phase in ("prefill", "decode"):
        logits, cache = prefill(params, batch)
        cache = serve_mod._grow_cache(cache, prompt + GEN_LEN, prompt)
        kw = dict(token=logits.argmax(-1)) if embed is None \
            else dict(embed=embed)
        steps_run = iter(range(prompt, prompt + n_decode))
        out[phase] = profiled_steps(
            (lambda: prefill(params, batch)) if phase == "prefill" else
            (lambda: decode(params, cache, next(steps_run), **kw)),
            1 if phase == "prefill" else n_decode)
        del logits, cache
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


def check_against_cpu(cfg, prompt: int, window: int, blocks=None,
                      batch: int = 2, frontend: bool = False) -> float:
    """A 2-layer model at full width (window layers at ``window``; with
    ``blocks``, that block pattern): kernels on the card against the same
    bf16 weights on the CPU through the plain versions, prefill plus 4
    teacher-forced decode steps, ``batch`` sequences of ``prompt``
    positions.  With ``frontend`` the inputs are the configuration's
    frontend batch (``launch.specs.batch_struct``: a vlm prefix of patch
    embeddings before tokens, or audio frame embeddings in place of
    tokens, and a frame embedding per audio decode step).  Both sides round
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
    p_gpu = _temper(T.init_params(gen, small))
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    opts = T.ModelOptions(q_chunk=64, kv_chunk=64, ssm_chunk=64)
    if frontend:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import specs
        gen.manual_seed(3)
        shape = ShapeConfig(cfg.frontend, prompt, batch, "prefill")
        ins = {k: _seeded(v, cfg.vocab, gen)
               for k, v in specs.batch_struct(cfg, shape).items()}
        frames = [_seeded(specs.decode_struct(cfg, shape)["embed"],
                          cfg.vocab, gen) for _ in range(4)] \
            if cfg.frontend == "audio" else None
    else:
        ins = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (batch, prompt), np.int64)).cuda()}
        frames = None
    worst = 0.0
    with torch.no_grad():
        lg, cg = T.prefill(p_gpu, small, ins.get("tokens"),
                           ins.get("embeds"), opts=opts)
        lc, cc = T.prefill(p_cpu, small, *(
            None if ins.get(k) is None else ins[k].cpu()
            for k in ("tokens", "embeds")), opts=opts)
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
            if frames is None:
                kg = dict(token=lg.argmax(-1))
                kc = dict(token=kg["token"].cpu())
            else:
                kg, kc = dict(embed=frames[t]), dict(embed=frames[t].cpu())
            lg, cg = T.decode_step(p_gpu, small, cg, pos=prompt + t,
                                   opts=opts, **kg)
            lc, cc = T.decode_step(p_cpu, small, cc, pos=prompt + t,
                                   opts=opts, **kc)
    return worst


def _seeded(struct, vocab: int, gen) -> torch.Tensor:
    """A seeded tensor on the card for a ``launch.specs`` stand-in:
    integers below ``vocab`` for tokens, N(0, 1) embeddings (the scale of
    the token embedding's rows) for the frontends' stubs."""
    if not struct.dtype.is_floating_point:
        return torch.randint(0, vocab, tuple(struct.shape), generator=gen,
                             device="cuda", dtype=struct.dtype)
    return torch.randn(tuple(struct.shape), generator=gen,
                       device="cuda").to(struct.dtype)


def _temper(params) -> dict:
    """Scale the attention's wq and wk by 1/8 and the mLSTM's wq, wk and
    wif by 1/16, in place (see ``check_against_cpu``)."""
    for e in params["layers"].values():
        for w in ("wq", "wk") if "attn" in e else ():
            e["attn"][w].mul_(0.125)
        for w in ("wq", "wk", "wif") if "mlstm" in e else ():
            e["mlstm"][w].mul_(1 / 16)
    return params


def init_params(name: str, cfg=None) -> dict:
    """Seeded random weights of one model at full width and its path's
    depth (``_config``; ``cfg`` in its place)."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return T.init_params(gen, cfg or _config(name))


def _has_attention(cfg) -> bool:
    from repro_torch.configs.base import ATTN, HYBRID, SWA
    return any(k in (ATTN, SWA, HYBRID) for k in cfg.blocks)


def time_path(name: str, prompt: int = 0, label: str = "") -> dict:
    """Time one path's kernels (``time_kernels``, at ``prompt``, the
    path's own by default) and print them; needs no weights.  Every
    path's kernels are timed first, before any window of whole steps and
    any of the port's profiled serves: after a window of a whole step's
    thousands of launches torch.profiler on an "NVIDIA H100 80GB HBM3" at
    700 W dropped 1-2 records in every later window of 20 calls (after
    qwen3-32b's 8 decode steps, about 36,000 launches, in every window),
    and once the port's profiler has drawn PC samples in a process it
    drops them too (1 of 20 launches a window after a 2-layer serve, 4
    after a full-depth one; none after an export, a registration or a
    profiled serve that draws no samples).  Returns the kernel times,
    empty without attention and mamba layers."""
    cfg = _config(name)
    prompt = prompt or {**PATHS, **SERVING_PATHS, **BIG_PATHS}[name]["prompt"]
    label = label or name
    if not (_has_attention(cfg) or _has_mamba(cfg)):
        return {}
    times, splits, steps = time_kernels(cfg, prompt)
    for kname, (t, calls) in times.items():
        by_step = (f"; device ms by step {json.dumps(steps)}"
                   if kname == "ssm_scan" else "")
        print(f"{label} {kname}: device {json.dumps(t)}; back-to-back call "
              f"{json.dumps(calls)}{by_step}", flush=True)
    if splits:
        print(f"{label} flash_decode by split count: {json.dumps(splits)}",
              flush=True)
    if "ssm_scan" in times:
        print("ssm_scan library_ms: null, no single PyTorch call computes "
              "a selective (SSD) scan", flush=True)
    return times


def breakdown_path(name: str, params) -> None:
    """Print where one model's serving steps' time goes (``step_breakdown``
    under torch.profiler), before any of the port's profiled serves (see
    ``time_path``)."""
    cfg = _config(name)
    prompt = {**PATHS, **SERVING_PATHS, **BIG_PATHS}[name]["prompt"]
    print(f"{name} step breakdown: "
          f"{json.dumps(step_breakdown(cfg, params, prompt))}", flush=True)


def serve_path(name: str, params) -> dict:
    """Serve one model under the port's profiler, check its output, its
    profile and database, the profiler's overhead, the 2-layer CPU check
    and a counters serve.  Frees ``params`` on the way.  Returns the
    serve result."""
    cfg = _config(name)
    prompt = PATHS[name]["prompt"]
    plain_s = [serve_plain(cfg, params, prompt)["wall_s"]]
    srv = run_serve(cfg, params, prompt)
    plain_s.append(serve_plain(cfg, params, prompt)["wall_s"])
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
    want = serve_launches(cfg)
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
    cfg = _config(name)
    spec = SERVING_PATHS[name]
    prompt = spec["prompt"]
    plain_s = [serve_plain(cfg, params, prompt)["wall_s"]]
    srv = run_serving(cfg, params, prompt)
    plain_s.append(serve_plain(cfg, params, prompt)["wall_s"])
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


# ---------------------------------------------------------------------------
# the reference's single-card configurations at full width and depth
# ---------------------------------------------------------------------------
# each: the serving prompt (qwen2's), the frontend batch's length (llava:
# 2880 patch embeddings, the anyres maximum, before 3264 text tokens;
# musicgen: frame embeddings in place of tokens), and the 2-layer CPU
# check's batch and prompt: B = 1 and 32 positions where the CPU side
# is largest (qwen3-32b's 2 layers are 0.98 B parameters beside 1.56 B of
# embed and unembed, starcoder2-15b's 1.21 B beside 0.60 B); llava's
# frontend check holds 16 patches before 16 tokens
BIG_PATHS = {
    "qwen3-32b": dict(prompt=512, cpu_batch=1, cpu_prompt=32),
    "starcoder2-15b": dict(prompt=512, cpu_batch=1, cpu_prompt=32),
    "yi-6b": dict(prompt=512, cpu_batch=2, cpu_prompt=64),
    "llava-next-mistral-7b": dict(prompt=512, frontend_seq=6144,
                                  cpu_batch=2, cpu_prompt=32),
    "musicgen-large": dict(prompt=512, frontend_seq=512, cpu_batch=2,
                           cpu_prompt=64),
    # the MAMBA path at hymba's serving prompt (3 chunks of 64 on the CPU)
    MAMBA_PATH: dict(prompt=1536, cpu_batch=2, cpu_prompt=192)}
# the profiled serve after the training phase: starcoder2-15b's decode
# kernel at G = 12 under the port's profiler, at full width and 4 of its
# 40 layers (at 40, its two steps' exports took 57 s of the card's host)
PROFILED_BIG = "starcoder2-15b"
PROFILED_BIG_LAYERS = 4


def _live_blocks() -> set:
    """Addresses of the caching allocator's allocated blocks."""
    return {blk["address"] for seg in torch.cuda.memory._snapshot()["segments"]
            for blk in seg["blocks"] if blk["state"] == "active_allocated"}


def _init_blocks(before: set, params) -> dict:
    """The allocated blocks that are new since ``before``, from the
    caching allocator's snapshot: those that hold a leaf of ``params``
    (their bytes, the bytes the leaves requested, and each block whose
    size exceeds its request: the allocator hands a request a whole
    cached block when splitting it would leave 1 MiB or less) and the
    stray ones that hold none (bytes, request, the innermost frames of
    the allocation while the allocator records its history)."""
    from repro_torch.tree import leaves
    ptrs = {t.untyped_storage().data_ptr() for t in leaves(params)}
    out = dict(param_bytes=0, requested=0, unsplit=[], stray=[])
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated" or blk["address"] in before:
                continue
            size, req = blk["size"], blk.get("requested_size", blk["size"])
            if blk["address"] in ptrs:
                out["param_bytes"] += size
                out["requested"] += req
                if size != req:
                    out["unsplit"].append(dict(bytes=size, requested=req))
                continue
            frames = [f"{os.path.basename(f.get('filename', ''))}:"
                      f"{f.get('line')}:{f.get('name', '')[:80]}"
                      for f in blk.get("frames", [])][:12]
            out["stray"].append(dict(bytes=size, requested=req,
                                     frames=frames))
    return out


def init_big(name: str) -> tuple:
    """Seeded full-width, full-depth weights of one of ``BIG_PATHS`` on the
    card, after printing the bytes ``launch.specs.params_struct`` reckons
    and the card's free memory.  The init's peak (over what was allocated
    before it) must stay within the weights plus the largest fp32 slice
    that ``dense_init`` draws (a period's slice of a stacked leaf, or the
    whole embed or unembed) plus 1 GiB: the check of its slice-at-a-time
    draw.  What it leaves allocated is held exactly: no allocated block
    but the parameters' (``_init_blocks``, from the allocator's snapshot),
    their requests summing to ``params_struct``'s bytes, and the
    allocated bytes those bytes plus the allocator's unsplit remainders
    (a block handed whole to a request it exceeds by 1 MiB or less:
    qwen3-32b's embed of 1,555,824,640 bytes takes a segment of 742 x 2
    MiB and leaves 262,144 bytes unsplit; such remainders depend on what
    the pool held before).  Returns (params, {weights, largest slice,
    peak, free before, the blocks})."""
    from repro_torch.launch import specs
    from repro_torch.tree import leaves_with_paths
    cfg = _config(name)
    struct = specs.params_struct(cfg)
    weights = specs.nbytes(struct)
    slice_fp32 = max(4 * t.numel() // (t.shape[0] if path[0] == "layers"
                                       else 1)
                     for path, t in leaves_with_paths(struct))
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{name}: params_struct reckons {weights} bytes of weights (largest "
          f"fp32 slice {slice_fp32} bytes); card free {free} of {total} "
          f"bytes", flush=True)
    before = torch.cuda.memory_allocated()
    live = _live_blocks()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=100_000,
                                             stacks="all")
    t0 = time.monotonic()
    params = init_params(name)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - before
    got = torch.cuda.memory_allocated() - before
    blocks = _init_blocks(live, params)
    torch.cuda.memory._record_memory_history(enabled=None)
    info = dict(weights=weights, allocated=got, init_peak=peak,
                largest_fp32_slice=slice_fp32, free_before=free,
                init_s=seconds, blocks=blocks)
    print(f"{name}: init on the card: {json.dumps(info)}", flush=True)
    if blocks["stray"] or blocks["requested"] != weights \
            or got != blocks["param_bytes"]:
        raise AssertionError(f"{name}: allocated {got} bytes after init, "
                             f"params_struct {weights}: {json.dumps(blocks)}")
    if peak > weights + slice_fp32 + 2 ** 30:
        raise AssertionError(f"{name}: the init's peak {peak} exceeds the "
                             f"weights {weights} by more than one fp32 "
                             f"slice {slice_fp32} plus 1 GiB")
    return params, info


def run_frontend(cfg, params, seq: int) -> dict:
    """A frontend's prefill and 31 decode steps through ``launch.steps``,
    on the batch ``launch.specs`` lays out (vlm: min(frontend_tokens,
    seq // 2) seeded patch embeddings before the text tokens, decode on
    tokens; audio: seeded frame embeddings in place of tokens, and one
    frame embedding per decode step), batch ``B``, every kernel launch
    counter set to 0 just before and read just after: one flash launch a
    layer for the prefill, one decode launch a layer a step, exact; every
    logit finite.  Returns {launches, prefill_ms, decode_ms, batch
    shapes}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import specs, steps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    batch = {k: _seeded(v, cfg.vocab, gen) for k, v in specs.batch_struct(
        cfg, ShapeConfig(cfg.frontend, seq, B, "prefill")).items()}
    dec = specs.decode_struct(cfg, ShapeConfig(cfg.frontend, seq + GEN_LEN,
                                               B, "decode"))
    frames = [_seeded(dec["embed"], cfg.vocab, gen)
              for _ in range(GEN_LEN - 1)] if "embed" in dec else None
    opts = _serve_opts(seq)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    torch.cuda.synchronize()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    finite = [torch.isfinite(logits).all()]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = serve_mod._grow_cache(cache, seq + GEN_LEN, seq)
    tok = logits.argmax(-1)
    for t in range(GEN_LEN - 1):
        kw = dict(token=tok) if frames is None else dict(embed=frames[t])
        logits, cache = decode(params, cache, seq + t, **kw)
        finite.append(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * (GEN_LEN - 1), "ssm_scan": 0,
            "moe_combine": len(cfg.moe_layers()) * GEN_LEN,
            "moe_uncombine": 0}
    if launches != want:
        raise AssertionError(f"{cfg.name} {cfg.frontend}: launch counts "
                             f"{launches}, expected {want}")
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.stack(finite).all()):
        raise AssertionError(f"{cfg.name} {cfg.frontend}: logits "
                             f"{tuple(logits.shape)}, not all finite")
    return dict(launches=launches, prefill_ms=(t1 - t0) * 1e3,
                decode_ms=(t2 - t1) * 1e3 / (GEN_LEN - 1),
                batch={k: list(v.shape) for k, v in batch.items()},
                decode_input="embed" if frames else "token")


def _g4h_model(cfg) -> dict:
    """The reference's model description of ``cfg`` (granite_hybrid)."""
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "block_pattern": list(cfg.block_pattern),
            "mamba_heads": cfg.mamba_heads,
            "mamba_head_dim": cfg.mamba_head_dim,
            "mamba_groups": 1, "ssm_state": cfg.ssm_state,
            "conv_width": 4, "d_ff": cfg.d_ff, "shared_ff": cfg.shared_ff,
            "vocab": cfg.vocab,
            "moe": {"n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                    "capacity_factor": cfg.moe.capacity_factor,
                    "held": cfg.experts_held},
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": True,
            "dtype": cfg.dtype}


def granite4h_path(card: str) -> dict:
    """granite-4.0-h-small at its published widths and depth with 18 of
    72 experts held, alone on the card: ``serve`` of one batch of 2 x
    16384 prompts and 16 generated tokens at exact launch counts (36 SSD
    scans and 4 flash prefills a prefill, 4 flash decodes a decode step:
    two prefills and 17 decode steps with the warm-up; a combine a layer
    a step); the same prefill
    and 16 decode steps through the mixed cache (k / v of 4 layers, ssm
    and the conv carry over xBC of 36), their logits against the plain
    reference's full forward at those positions (``G4H_LOGIT_TOL``, the
    prefill cells' logit limit, on each position's relative error), the
    served tokens the same as the loop's (its scan is timed by
    ``time_g4h_scan``).  Frees the weights.  Returns {launches,
    logit_err, peak_bytes, prefill_ms, decode_ms, seconds}."""
    from hpcbench.reference import granite_hybrid as ref
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    base = _config(GRANITE4H)
    cfg = dataclasses.replace(
        base, experts_held=G4H_HELD,
        moe=dataclasses.replace(base.moe, capacity_factor=base.moe.n_experts
                                / base.moe.top_k))
    m = _g4h_model(cfg)
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = ref.make_params(m, 29, "cuda")
    S, n = G4H_PROMPT, G4H_DECODE
    for name in KERNELS:
        getattr(ops, name).launches = 0
    served, _ = serve_mod.serve(cfg, n_requests=G4H_BATCH, batch=G4H_BATCH,
                                prompt_len=S, gen_len=n + 1, seed=29,
                                params=params, device="cuda")
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    n_mamba = cfg.blocks.count("mamba")
    want = dict.fromkeys(KERNELS, 0)
    want.update(ssm_scan=2 * n_mamba,
                flash_attention=2 * (cfg.n_layers - n_mamba),
                flash_decode=(n + 1) * (cfg.n_layers - n_mamba),
                moe_combine=(2 + n + 1) * cfg.n_layers)
    if launches != want:
        raise AssertionError(f"{GRANITE4H}: launch counts {launches}, "
                             f"expected {want}")
    # serve's prompts, then the loop it runs, with the logits kept
    toks = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab, (G4H_BATCH, S), np.int32)).to("cuda", torch.long)
    opts = _serve_opts(S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = steps.make_prefill_step(cfg, opts)(params,
                                                       {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    cache = serve_mod._grow_cache(cache, S + n, S)
    decode = steps.make_decode_step(cfg, opts)
    outs, seq, tok = [logits], toks, logits.argmax(-1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for t in range(n):
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = decode(params, cache, S + t, token=tok)
        outs.append(logits)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t2) * 1e3 / n
    got = torch.stack(outs, 1)
    if not torch.equal(got.argmax(-1), served):
        raise AssertionError(f"{GRANITE4H}: serve's tokens are not the "
                             f"loop's")
    peak = torch.cuda.max_memory_allocated()
    del cache, outs, logits
    torch.cuda.empty_cache()
    ref.precise()
    want_logits = ref.forward(params, m, seq, ref.Numerics(), last=n + 1)
    err = ((got.double() - want_logits.double()).norm(dim=-1)
           / want_logits.double().norm(dim=-1))
    if not bool(torch.isfinite(err).all()) \
            or float(err.max()) > G4H_LOGIT_TOL:
        raise AssertionError(f"{GRANITE4H}: decode logits against the "
                             f"reference's forward, relative error by "
                             f"position {err.max(0).values.tolist()}")
    del params, want_logits
    torch.cuda.empty_cache()
    out = dict(launches=launches, logit_err=err.max(0).values.tolist(),
               peak_bytes=peak, prefill_ms=prefill_ms, decode_ms=decode_ms,
               seconds=time.monotonic() - t0)
    print(f"{GRANITE4H} path ({card}): {json.dumps(out)}", flush=True)
    return out


def serve_plain(cfg, params, prompt: int) -> dict:
    """The main path without a profiler: ``serve`` with every kernel
    launch counter set to 0 just before and read just after, exact
    counts (``serve_launches``).  Returns {tokens, launches, wall_s: the
    serve's wall seconds, warm-up included}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    for name in KERNELS:
        getattr(ops, name).launches = 0
    t0 = time.monotonic()
    toks, paths = serve(cfg, n_requests=N_REQUESTS, batch=B,
                        prompt_len=prompt, gen_len=GEN_LEN, profile_dir=None,
                        device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    want = serve_launches(cfg)
    if launches != want:
        raise AssertionError(f"{cfg.name}: launch counts {launches}, "
                             f"expected {want}")
    if paths is not None or tuple(toks.shape) != (N_REQUESTS, GEN_LEN):
        raise AssertionError(f"{cfg.name}: serve gave {paths}, tokens "
                             f"{tuple(toks.shape)}")
    return dict(tokens=toks, launches=launches, wall_s=wall)


def _phase_ms(cfg, params, prompt: int) -> dict:
    """Host wall ms of one prefill of a batch of ``B`` prompts and of one
    decode step, each ending in a synchronize (the steps ``serve`` runs,
    outside it), and tokens/s of a batch of ``GEN_LEN`` tokens."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import steps
    opts = _serve_opts(prompt)
    prefill = steps.make_prefill_step(cfg, opts)
    decode = steps.make_decode_step(cfg, opts)
    toks = torch.zeros((B, prompt), dtype=torch.long, device="cuda")
    prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache = serve_mod._grow_cache(cache, prompt + GEN_LEN, prompt)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for t in range(GEN_LEN - 1):
        logits, cache = decode(params, cache, prompt + t, token=tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    prefill_ms = (t1 - t0) * 1e3
    decode_ms = (t3 - t2) * 1e3 / (GEN_LEN - 1)
    return dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                tok_per_s=B * GEN_LEN / (prefill_ms + (GEN_LEN - 1)
                                         * decode_ms) * 1e3)


def time_big_kernels() -> dict:
    """The kernels of every path of ``BIG_PATHS`` timed (``time_path``),
    and of the frontends at their own lengths where they differ (llava's
    vlm prefill over 6144 positions and the decode after it; the plain
    attention over 6144 positions takes about 58 GB, so this runs with
    no weights on the card).  Returns {path: kernel times}."""
    out = {}
    for name, spec in BIG_PATHS.items():
        out[name] = time_path(name)
        seq = spec.get("frontend_seq")
        if seq:
            label = f"{name}:{_config(name).frontend}"
            out[label] = out[name] if seq == spec["prompt"] else \
                time_path(name, seq, label)
        torch.cuda.empty_cache()
    return out


def time_g4h_scan(card: str) -> dict:
    """The SSD scan at granite-4.0-h-small's serve shape (state 128,
    serve's chunk) timed with the other kernels, before any window of
    whole steps: timed after the single-card configurations, windows of
    its plain version lost a call's records of some kernels in every
    window (an H100 at 700 W).  Returns the kernel's times."""
    cfg = _config(GRANITE4H)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    t, calls = _timed(*_ssm_fns(gen, G4H_BATCH, G4H_PROMPT, cfg.mamba_heads,
                                cfg.mamba_head_dim, cfg.ssm_state,
                                _serve_opts(G4H_PROMPT).ssm_chunk))
    torch.cuda.empty_cache()
    print(f"{GRANITE4H} ssm_scan ({card}): device {json.dumps(t)}; "
          f"back-to-back call {json.dumps(calls)}", flush=True)
    return t


def time_decode_past_a_tile() -> dict:
    """The decode kernel past one tile of q rows, where no main path takes
    it: G = 24 (96 / 4 heads, D = 128, length 528 of 544, two tiles, so
    the kernel reads the caches twice against the bound's once), timed as
    ``time_kernels`` times a path's decode.  Returns its times."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, h, hkv, d, smax, length = B, 96, 4, 128, 544, 528
    q = _randn((b, h, d), gen, 0.5)
    kc = _randn((b, smax, hkv, d), gen, 0.5)
    vc = _randn((b, smax, hkv, d), gen, 0.5)
    kl = kc[:, :length].transpose(1, 2)
    vl = vc[:, :length].transpose(1, 2)
    fns = dict(ms=lambda: ops.flash_decode(q, kc, vc, length),
               plain_ms=lambda: fd.flash_decode_plain(q, kc, vc, length),
               library_ms=lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kl, vl, enable_gqa=True))
    t, _ = _timed(fns, *fd.work(b, h, hkv, d, length))
    return dict(t, shape=[b, h, hkv, d, smax, length],
                tiles=fd.q_tiles(h, hkv))


def big_path(name: str, card: str) -> dict:
    """One of ``BIG_PATHS`` at full width and depth on the card, alone:
    the init and its peak memory (``init_big``), its steps broken down
    under torch.profiler (``breakdown_path``; its kernels are timed
    before, by ``time_big_kernels``), ``serve`` without a profiler at
    exact launch counts, the prefill and decode host ms and tokens/s,
    every batch replayed; llava's vlm and musicgen's audio frontend
    through ``run_frontend`` (exact launches, finite logits), broken down
    as well; the 2-layer full-width model against the CPU on tokens, and
    for a frontend on its embeddings.  Frees the weights.  Returns
    {serve, phase, frontend, cpu, init}."""
    cfg = _config(name)
    spec = BIG_PATHS[name]
    prompt = spec["prompt"]
    t0 = time.monotonic()
    params, init = init_big(name)
    breakdown_path(name, params)
    srv = serve_plain(cfg, params, prompt)
    phase = _phase_ms(cfg, params, prompt)
    print(f"serve {name} ({card}): {N_REQUESTS} requests x {GEN_LEN} "
          f"tokens, batch {B}, prompt {prompt}, no profiler: wall "
          f"{srv['wall_s']:.2f} s (incl. warm-up); prefill "
          f"{phase['prefill_ms']:.3f} ms/batch, decode "
          f"{phase['decode_ms']:.3f} ms/step, {phase['tok_per_s']:.1f} "
          f"tok/s; launches {json.dumps(srv['launches'])}", flush=True)
    check_replay(cfg, params, srv["tokens"], prompt)
    print(f"replay {name}: every batch reproduces serve's tokens",
          flush=True)
    out = dict(serve=srv, phase=phase, init=init)
    seq = spec.get("frontend_seq")
    if seq:
        fe = run_frontend(cfg, params, seq)
        print(f"{name} {cfg.frontend} frontend ({card}): {json.dumps(fe)}",
              flush=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(8)
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import specs
        shape = ShapeConfig(cfg.frontend, seq, B, "prefill")
        batch = {k: _seeded(v, cfg.vocab, gen)
                 for k, v in specs.batch_struct(cfg, shape).items()}
        dec = specs.decode_struct(cfg, shape)
        embed = _seeded(dec["embed"], cfg.vocab, gen) if "embed" in dec \
            else None
        steps_ = step_breakdown(cfg, params, seq, batch=batch, embed=embed)
        print(f"{name} {cfg.frontend} step breakdown: {json.dumps(steps_)}",
              flush=True)
        del batch, embed
        out["frontend"] = fe
    del params
    torch.cuda.empty_cache()
    cpu = {"tokens": check_against_cpu(cfg, spec["cpu_prompt"], 0,
                                       batch=spec["cpu_batch"])}
    if seq:
        cpu[cfg.frontend] = check_against_cpu(
            cfg, spec["cpu_prompt"], 0, batch=spec["cpu_batch"],
            frontend=True)
    out["cpu"] = cpu
    print(f"{name}: 2-layer full-width (batch {spec['cpu_batch']}, prompt "
          f"{spec['cpu_prompt']}) vs CPU bf16 plain: max abs logit err / max "
          f"abs logit {json.dumps(cpu)}", flush=True)
    torch.cuda.empty_cache()
    print(f"{name}: path done in {time.monotonic() - t0:.1f} s", flush=True)
    return out


def profiled_big_serve(card: str, name: str = PROFILED_BIG,
                       layers: int = PROFILED_BIG_LAYERS) -> dict:
    """One of ``BIG_PATHS`` (``PROFILED_BIG`` by default) served under the
    port's profiler at full width and ``layers`` layers (``run_serve``:
    exact launches): export and registration seconds and ops, and PC
    samples under both steps that reach each kernel's dot_general leaves
    (``check_profile``; starcoder2's decode kernel's at G = 12, the MAMBA
    path's SSD scan).  Runs after every torch.profiler timing (see
    ``time_path``).  Returns the serve result."""
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(_config(name), n_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    srv = run_serve(cfg, params, BIG_PATHS[name]["prompt"])
    del params
    torch.cuda.empty_cache()
    print(f"serve {name} under the port's profiler ({card}), "
          f"{cfg.n_layers} layers: wall {srv['wall_s']:.2f} s (incl. "
          f"warm-up, export and registration), prefill "
          f"{srv['prefill_ms']:.3f} ms/batch, decode {srv['decode_ms']:.3f} "
          f"ms/step; launches {json.dumps(srv['launches'])}", flush=True)
    prof = check_profile(cfg, srv["paths"])
    print(f"profile {name} ({cfg.n_layers} layers, {card}): "
          f"{json.dumps(prof)}", flush=True)
    return dict(srv, profile=prof)


def mamba_summary(big: dict, step_times: dict, train_runs: dict,
                  profiled: dict) -> dict:
    """What the MAMBA path measured and checked, from the phases that ran
    it: the weights reckoned and allocated, the full-depth serve's exact
    launches, prefill and decode ms and tokens/s, the 2-layer CPU checks,
    the train step's wall, busy and idle share, the full-depth training's
    launches and losses, the resume, the profiled serve's launches and PC
    samples in the SSD scan's interior."""
    srv, step, run = big[MAMBA_PATH], step_times[MAMBA_PATH], \
        train_runs[MAMBA_PATH]
    ssd = profiled["profile"]["prefill"]["kernels"]["ssm_scan"]
    return dict(
        layers=_config(MAMBA_PATH).n_layers,
        weights_reckoned=srv["init"]["weights"],
        allocated=srv["init"]["allocated"],
        serve_launches=srv["serve"]["launches"], **srv["phase"],
        cpu_logits=srv["cpu"]["tokens"],
        train_step=dict(wall_ms=step["wall_ms"],
                        device_busy_ms=step["device_busy_ms"],
                        idle_share=step["idle_share"],
                        tokens_per_s=step["tokens_per_s"]),
        train_launches=run["launches"], train_losses=run["losses"],
        cpu_grads=run["cpu"], resume=run["resume"],
        profiled=dict(layers=MAMBA_PROFILED_LAYERS,
                      launches=profiled["launches"], ssd_samples=ssd))


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
# 1024, so the window bites; xlstm's 4 x 256 are the JAX package's CLI
# defaults), whether the run is under the port's profiler (hymba's step
# traces to about 8000 ops a layer: the plain recompute backward of its
# 36 attention block pairs and 24 scan chunks; xlstm's would unroll the
# sLSTM's time loop, 256 steps forward and again in the recompute, and
# its serving export at 512 took 235.6 s), and the 2-layer CPU check's
# block pattern and (dtype, held) runs where they differ: xlstm runs no
# kernel, so its step is held in f32, where the comparison measures the
# card's arithmetic; in bf16 (reported) rounding alone moved its worst
# leaf, the mLSTM's wk, 2.13% of its largest value between the card and
# the CPU (the exponential gates amplify it; qwen2's worst was 1.54%)
TRAIN_PATHS = {"qwen2-1.5b": dict(batch=4, seq=512, steps=6, profile=True),
               "hymba-1.5b": dict(batch=2, seq=1536, steps=3,
                                  profile=False),
               "granite-moe-1b-a400m": dict(batch=4, seq=512, steps=6,
                                            profile=True),
               "xlstm-125m": dict(batch=4, seq=256, steps=6, profile=False,
                                  cpu_blocks=("mlstm", "slstm"),
                                  cpu_checks=(("float32", True),
                                              ("bfloat16", False))),
               # at full depth, hymba's training shape, not profiled
               MAMBA_PATH: dict(batch=2, seq=1536, steps=3, profile=False)}
# the reference's single-card configurations that train on one card with
# the donated step, at full width and depth: musicgen-large
# on token batches (its EnCodec codebook entries; the frontend off) and on
# audio-frame batches (frame embeddings in place of tokens), 4 x 512, and
# yi-6b at 4 x 512, the largest batch of 4, 2 and 1 whose reckoned peak
# (``launch.specs.train_memory``: 81.02 GB) leaves ``TRAIN_HEADROOM`` of
# the 84.1 GB an H100 80GB HBM3 reports free; ``reckon_train`` holds each
# run to that before it starts.  Each is timed with nothing else on the
# card, after the single-card serves
# musicgen-large trains at 24 of its 48 layers (``layers``; at 48 each of
# its two train step timings took about 30 s of the script)
BIG_TRAIN_PATHS = {
    "musicgen-large:tokens": dict(batch=4, seq=512, steps=4, profile=False,
                                  layers=24),
    "musicgen-large:audio": dict(batch=4, seq=512, steps=4, profile=False,
                                 layers=24),
    "yi-6b": dict(batch=4, seq=512, steps=3, profile=False)}
TRAIN_HEADROOM = 2 ** 31   # free memory a reckoned train step must leave
PEAK_TOL = 2 ** 31         # a train step's peak against its reckoning
# the train steps whose device time is split by named scope
SCOPED_PATHS = ("qwen2-1.5b", "granite-moe-1b-a400m") + tuple(BIG_TRAIN_PATHS)
# the train step whose optimizer is also timed functional (not donated)
DONATION_TIMED = "qwen2-1.5b"
# forward launches of each kernel per layer and train step under the
# default remat (``dots_no_batch``): the forward, and its recompute in the
# backward (the policy saves matmul outputs only); the backward itself is
# plain torch and launches no kernel of the port
LAUNCHES_PER_LAYER = 2
TRAIN_TIMED_STEPS = 2


def _train_custom_calls(cfg) -> int:
    """Custom-calls of a recorded train step: ``LAUNCHES_PER_LAYER`` a
    layer for the layers' kernels (flash or the SSD scan), and each MoE
    layer's combine in the forward and the recompute and its adjoint in
    the backward (``ops.moe_combine``, ``ops.moe_uncombine``)."""
    return cfg.n_layers * LAUNCHES_PER_LAYER + 3 * len(cfg.moe_layers())


def _train_spec(key: str) -> dict:
    return {**TRAIN_PATHS, **BIG_TRAIN_PATHS}[key]


def _train_config(key: str):
    """A training path's configuration (``_config``, at its spec's
    ``layers`` where it has one); ``<name>:tokens`` is the model with its
    frontend off (token batches), ``<name>:audio`` the model as
    configured, ``<name>:mamba`` the MAMBA path."""
    name, _, kind = key.partition(":")
    cfg = _config(key if kind == "mamba" else name)
    layers = _train_spec(key).get("layers")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, frontend="none") if kind == "tokens" \
        else cfg


def _reckoning(key: str, batch: int):
    """``launch.specs.train_memory`` of a training path at ``batch``, or
    None where it does not model the path's blocks."""
    from repro_torch.launch import specs
    try:
        return specs.train_memory(_train_config(key), batch,
                                  _train_spec(key)["seq"],
                                  _train_opts(_train_spec(key)["seq"]))
    except NotImplementedError:
        return None


def reckon_train(key: str) -> dict:
    """Print a big training path's memory reckoning at its batch beside
    the card's free memory, and raise unless the reckoned peak leaves
    ``TRAIN_HEADROOM`` free: the path trains at its batch or the run
    fails.  Returns the reckoning and the free bytes."""
    spec = BIG_TRAIN_PATHS[key]
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    reckoned = _reckoning(key, spec["batch"])
    print(f"train {key}: reckoned bytes (launch.specs.train_memory, "
          f"{spec['batch']} x {spec['seq']}) {json.dumps(reckoned)}; card "
          f"free {free} of {total}", flush=True)
    if reckoned["peak"] + TRAIN_HEADROOM > free:
        raise AssertionError(f"train {key}: reckoned peak "
                             f"{reckoned['peak']} bytes leaves less than "
                             f"{TRAIN_HEADROOM} of {free} free")
    return dict(reckoning=reckoned, free=free)


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
    row, STATE_TOL for h_final), at the qwen2, hymba and granite-moe
    training shapes (B = 4, 2 and 4) and at windowed, ragged edges.  The
    gradients (the plain recompute backward, which takes the saved inputs
    and not the kernel's output) are held against the plain version's
    autograd with the same cotangents: elementwise at TOL (STATE_TOL for
    the fp32 dlogdecay and dh0) and each tensor's max abs error within
    ROW_TOL of its largest value (a row-wise check would divide by rows
    that are zero in exact arithmetic, such as dq of a query that sees
    one key).
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

    # (path, B, S, H, Hkv, D, window): qwen2's, hymba's and granite-moe's
    # training shapes, a window under a kv tile on ragged tiles, and G = 1
    # at D = 64
    for path, b, s, h, hkv, d, window in [
            ("qwen2-1.5b", 4, 512, 12, 2, 128, 0),
            ("hymba-1.5b", 2, 1536, 25, 5, 64, 1024),
            ("granite-moe-1b-a400m", 4, 512, 16, 8, 64, 0),
            # the single-card training paths: musicgen-large (G = 1, D =
            # 64; both kinds of batch give the kernel these shapes) and
            # yi-6b at each batch it may take
            ("musicgen-large:tokens", 4, 512, 32, 32, 64, 0),
            ("musicgen-large:audio", 4, 512, 32, 32, 64, 0),
            ("yi-6b", 4, 512, 32, 4, 128, 0),
            ("yi-6b", 2, 512, 32, 4, 128, 0),
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
    # (path, B, S, nh, hd, st, chunk, h0): hymba's training shape (no h0;
    # the MAMBA path's too) and with h0, a ragged S, unpadded rows (hd
    # 120, st 50)
    for path, b, s, nh, hd, st, chunk, with_h0 in [
            ("hymba-1.5b", 2, 1536, 25, 64, 16, 64, False),
            (MAMBA_PATH, 2, 1536, 25, 64, 16, 64, False),
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
    from repro_torch.configs.base import HYBRID
    cfg = _train_config(name)
    b, seq = _train_spec(name)["batch"], _train_spec(name)["seq"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kernels = {}
    if _has_attention(cfg):
        kernels["flash_attention"] = _timed(*_flash_fns(
            gen, b, seq, h, hkv, d,
            cfg.window if HYBRID in cfg.blocks else 0))
    if _has_mamba(cfg):
        kernels["ssm_scan"] = _timed(*_ssm_fns(gen, b, seq, h, d,
                                               cfg.ssm_state, 64))
    if cfg.moe_layers():
        shape = (b * seq, cfg.moe.top_k, cfg.d_model,
                 cfg.moe.n_experts * _combine_capacity(cfg, b * seq))
        for kname in ("moe_combine", "moe_uncombine"):
            kernels[kname] = _timed(*_combine_fns(
                *shape, COMBINE_TIMED_DROP, adjoint=kname == "moe_uncombine"))
    return kernels


def time_train(name: str) -> dict:
    """A train step of one training path under torch.profiler, before any
    profiled run (see ``time_path``): seeded full-width weights at the
    path's depth (``_train_config``), tempered as the CPU checks temper
    them (``_temper``), the pipeline's first batch repeated,
    ``OptConfig(warmup_steps=1)``, the donated step (``donate=True``, as
    ``train`` runs it); one warm-up step, ``TRAIN_TIMED_STEPS`` steps
    under the profiler, one more (and for ``SCOPED_PATHS`` one under
    ``scope_device_ms``; for ``DONATION_TIMED`` one more of the functional
    step under it, the optimizer before donation).  The loss must fall
    over the steps on the repeated batch.  Untempered, the seeded init's
    one-hot attention (and xlstm's mLSTM gates) make the loss of one
    batch jump between nearby weights: on an "NVIDIA H100 80GB HBM3" at
    700 W granite-moe's moved by up to 0.03 in 6 steps of lr 1e-6, with
    the same loss on repeats of one step, and xlstm's went to NaN at the
    fourth step of lr 3e-4; tempered, granite-moe's fell from 11.75 to
    6.43 in 6 steps of lr 3e-4.  ``torch.cuda.max_memory_allocated`` over
    the profiled steps, less what was allocated before the weights, is
    the step's peak (``peak_bytes``), printed beside the reckoning
    (``launch.specs.train_memory``) and, for ``BIG_TRAIN_PATHS``, held to
    it within ``PEAK_TOL``.  Returns {host wall ms, device busy ms, idle
    share, tokens/s, device kernels per step, the port's kernels' ms and
    share, top kernels, losses, peak and reckoned bytes}."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = _train_config(name)
    spec = _train_spec(name)
    b, seq = spec["batch"], spec["seq"]
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = _temper(T.init_params(gen, cfg))
    state = adamw.init(params)
    opt_cfg = adamw.OptConfig(warmup_steps=1, total_steps=100)
    step = steps_mod.make_train_step(cfg, _train_opts(seq), opt_cfg,
                                     donate=True)
    batch = _lm_batch(cfg, b, seq)
    losses = []

    def one(fn=step):
        nonlocal params, state
        params, state, m = fn(params, state, batch)
        losses.append(m["loss"])

    one()
    torch.cuda.reset_peak_memory_stats()
    res = profiled_steps(one, TRAIN_TIMED_STEPS, top=6)
    peak = torch.cuda.max_memory_allocated() - before
    one()
    if name in SCOPED_PATHS:
        res["scope_ms"] = scope_device_ms(one)
    if name == DONATION_TIMED:
        functional = steps_mod.make_train_step(cfg, _train_opts(seq),
                                               opt_cfg)
        res["scope_ms_functional"] = scope_device_ms(
            lambda: one(functional))
    losses = [float(x) for x in losses]
    del params, state, batch
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name} train: losses on a repeated batch "
                             f"{losses} (must be finite and fall)")
    reckoned = _reckoning(name, b)
    res.update(tokens_per_s=b * seq / res["wall_ms"] * 1e3,
               port_kernels_share=sum(res["port_kernels_ms"].values())
               / res["device_busy_ms"], losses=losses, batch=b,
               peak_bytes=peak,
               reckoned_peak_bytes=reckoned and reckoned["peak"])
    if name in BIG_TRAIN_PATHS and abs(peak - reckoned["peak"]) > PEAK_TOL:
        raise AssertionError(f"{name} train: peak {peak} bytes, reckoned "
                             f"{json.dumps(reckoned)}: more than "
                             f"{PEAK_TOL} apart")
    return res


def scope_device_ms(step) -> dict:
    """Device ms of one ``step()`` by the train step's named scope
    (``repro_torch.core.scope``), under torch.profiler with host and
    device activity.  A scope is a ``record_function`` range on the host;
    each device kernel, copy or fill goes to the scope whose range holds
    the host call that launched it (the trace's correlation ids), from
    whatever thread: on the card the autograd engine runs the backward,
    the remat recompute inside it, in a thread of its own, within
    ``fwd_bwd``.  So ``fwd_bwd`` is also split into ``fwd_bwd/forward``
    (launched by the thread that opened the range) and
    ``fwd_bwd/backward`` (by any other).  Work launched outside every
    range is ``none``.  Returns {scope: ms, ..., "none": ms, "device_ms":
    their sum, "records": device records}; fails unless ``fwd_bwd`` and
    ``optimizer`` hold device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.scope import TRAIN_SCOPES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "scope_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in TRAIN_SCOPES]
    launches = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    parts = TRAIN_SCOPES + ("none",)
    out = dict.fromkeys(parts + ("fwd_bwd/forward", "fwd_bwd/backward"),
                        0.0)
    records = 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        records += 1
        ms = e["dur"] / 1e3
        ts, tid = launches.get(e.get("args", {}).get("correlation"),
                               (None, None))
        hit = next((r for r in ranges
                    if ts is not None and r[0] <= ts <= r[1]), None)
        if hit is None:
            out["none"] += ms
            continue
        out[hit[2]] += ms
        if hit[2] == "fwd_bwd":
            side = "forward" if tid == hit[3] else "backward"
            out["fwd_bwd/" + side] += ms
    out.update(device_ms=sum(out[k] for k in parts), records=records)
    if out["fwd_bwd"] <= 0 or out["optimizer"] <= 0:
        raise AssertionError(f"device ms by scope {out}: fwd_bwd and "
                             f"optimizer must both hold device time")
    return out


def train_path(name: str) -> dict:
    """The training main path: ``launch.train.train`` at full width and
    the path's depth (``_config``), seeded weights, every kernel launch
    counter set to 0 just before and read just after; the counts must be
    the remat policy's (layers x steps x ``LAUNCHES_PER_LAYER`` for each
    kernel the layers run, each MoE layer's combine as often and its
    adjoint once a step) and every loss finite.  Under the port's
    profiler (qwen2, granite-moe): the registered train step has one custom-call per
    launch of a step, and the aggregated database
    (``build/chip_smoke/db/<model>-train``) has PC samples under the
    train_step placeholder that reach a dot_general leaf of
    flash_attention.cu, and in the ``fwd_bwd`` and ``optimizer`` scopes
    (``scope.shares``: each scope's share of the samples under the
    placeholder).  Returns the run's numbers."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import scope, viewer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    cfg = _train_config(name)
    spec = _train_spec(name)
    prof_dir = None
    if spec["profile"]:
        prof_dir = os.path.join(SCRATCH, "train", name)
        shutil.rmtree(prof_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for kname in KERNELS:
        getattr(ops, kname).launches = 0
    t0 = time.monotonic()
    _, hist, paths = train(cfg, ShapeConfig("train", spec["seq"],
                                            spec["batch"], "train"),
                           n_steps=spec["steps"], log_every=1,
                           opts=_train_opts(spec["seq"]),
                           profile_dir=prof_dir, device="cuda")
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launches = {kname: getattr(ops, kname).launches for kname in KERNELS}
    per_step = cfg.n_layers * LAUNCHES_PER_LAYER
    n_moe = len(cfg.moe_layers())
    want = {"flash_attention": per_step * spec["steps"]
            if _has_attention(cfg) else 0, "flash_decode": 0,
            "ssm_scan": per_step * spec["steps"]
            if _has_mamba(cfg) else 0,
            "moe_combine": n_moe * LAUNCHES_PER_LAYER * spec["steps"],
            "moe_uncombine": n_moe * spec["steps"]}
    losses = [h["loss"] for h in hist]
    print(f"train {name}: launches {json.dumps(launches)}, expected "
          f"{json.dumps(want)} ({cfg.n_layers} layers x {spec['steps']} "
          f"steps x {LAUNCHES_PER_LAYER}: forward + remat recompute); "
          f"losses {losses}; wall {wall:.2f} s; peak {peak} bytes (init "
          f"included)", flush=True)
    if launches != want:
        raise AssertionError(f"{name} train: launch counts {launches}, "
                             f"expected {want}")
    if len(losses) != spec["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train: losses {losses}")
    out = dict(launches=launches, losses=losses, wall_s=wall,
               batch=spec["batch"], peak_bytes=peak)
    if paths is None:
        return out
    with open(paths["measurement"]) as f:
        measurement = json.load(f)
    step = measurement["steps"]["train_step"]
    if step["custom_calls"] != _train_custom_calls(cfg):
        raise AssertionError(f"{name} train step: {step['custom_calls']} "
                             f"custom-calls bound, "
                             f"{_train_custom_calls(cfg)} expected")
    db = _database(paths, os.path.join(SCRATCH, "db", f"{name}-train"))
    got = interior_samples(db).get("train_step", {})
    k = got.get("kernels", {}).get("flash_attention")
    if got.get("samples", 0) <= 0 or not k or k["dot_general"] <= 0 \
            or not k["dot_lines"]:
        raise AssertionError(f"{name} train: PC samples under train_step "
                             f"{got.get('samples')}, flash interior {k}")
    shares = scope.shares(db)
    if shares["fwd_bwd"] <= 0 or shares["optimizer"] <= 0:
        raise AssertionError(f"{name} train: PC-sample shares by scope "
                             f"{shares}")
    print(viewer.top_down(db, "gpu_inst/samples", max_depth=8,
                          max_children=4), flush=True)
    out.update(ops=step["ops"], custom_calls=step["custom_calls"],
               export_s=step["seconds"], flops=step["flops"],
               samples=got["samples"], scope_samples=shares,
               flash_samples=dict(samples=k["samples"],
                                  dot_general=k["dot_general"],
                                  dot_lines=sorted(k["dot_lines"])),
               profiler=measurement["profiler"])
    return out


def _pinned_routing(record: list, replay=None):
    """A context in which every MoE FFN of the port appends the experts it
    routes each token to (the top-k indices, on the CPU) to ``record``,
    call by call; with ``replay`` (another run's record, in the same call
    order: forward, then the remat recompute) it routes to those experts
    instead of its own top-k, and ``record`` gets, per call, the number of
    tokens whose own choice would have differed.  The gates are the
    router's own probabilities of the experts routed to, so only the
    discrete choice is pinned: bf16 rounding that differs between the card
    and the CPU by accumulation order flips near-ties at the top-k
    boundary (on the CPU, a plain-schedule attention against the
    chunked one flipped 2 of 128 tokens in a 2-layer granite-moe step,
    and moved expert gradients 7% of their largest value)."""
    from unittest import mock
    from repro_torch.models import moe as moe_mod
    real_moe, real_topk = moe_mod._local_moe, torch.topk
    calls = iter(replay) if replay is not None else None

    def topk(x, k, dim=-1, **kw):
        own = real_topk(x, k, dim, **kw)
        if calls is None:
            record.append(own.indices.cpu())
            return own
        idx = next(calls).to(x.device)
        record.append(int((own.indices.sort(-1).values
                           != idx.sort(-1).values).any(-1).sum()))
        return x.gather(dim, idx), idx

    def moe(*args, **kwargs):
        with mock.patch.object(torch, "topk", topk):
            return real_moe(*args, **kwargs)
    return mock.patch.object(moe_mod, "_local_moe", moe)


def check_train_against_cpu(name: str, seq: int, window: int,
                            blocks=None, dtype=None,
                            hold: bool = True) -> dict:
    """One train step's loss and every gradient leaf of a 2-layer model at
    full width (window layers at ``window``; with ``blocks``, that block
    pattern; in ``dtype``, else the model's bf16), kernels on the card
    against the same weights on the CPU through the plain versions: the
    loss within 2e-2 relative, each leaf's max abs error within 2e-2 of
    its largest value, the serving check's bf16 tolerance (``hold``:
    raise past it; else only report); wq and wk (and the mLSTM's wif)
    tempered as in ``check_against_cpu``.  A MoE FFN on the CPU routes
    each token to the experts the card chose (``_pinned_routing``); the
    number of tokens whose CPU choice differed is returned.  Returns the
    worst leaf and its error ratio."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves_with_paths, tree_map
    small = dataclasses.replace(_train_config(name), n_layers=2,
                                window=window)
    if blocks:
        small = dataclasses.replace(small, block_pattern=tuple(blocks))
    if dtype:
        small = dataclasses.replace(small, dtype=dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    p_gpu = _temper(T.init_params(gen, small))
    p_cpu = tree_map(lambda x: x.cpu(), p_gpu)
    opts = _train_opts(seq)
    batch = _lm_batch(small, 2, seq)
    routed, flipped = [], []
    with _pinned_routing(routed):
        lg, _, gg = steps_mod._value_and_grad(small, opts, p_gpu, batch)
    with _pinned_routing(flipped, routed):
        lc, _, gc = steps_mod._value_and_grad(
            small, opts, p_cpu, {k: v.cpu() for k, v in batch.items()})
    if len(flipped) != len(routed):
        raise AssertionError(f"{name} 2-layer train: {len(routed)} MoE "
                             f"calls on the card, {len(flipped)} on the "
                             f"CPU")
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    if not np.isfinite(float(lg)) or (hold and rel > 2e-2):
        raise AssertionError(f"{name} 2-layer train: loss {float(lg)} on "
                             f"the card, {float(lc)} on the CPU")
    worst = {}
    for (path, a), (_, b) in zip(leaves_with_paths(gg),
                                 leaves_with_paths(gc)):
        path = "/".join(path)
        a, b = a.float().cpu(), b.float()
        r = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst[path] = r
        if not torch.isfinite(a).all() or (hold and r > 2e-2):
            raise AssertionError(f"{name} 2-layer train: gradient {path}: "
                                 f"max abs error {r:.4f} of its largest "
                                 f"value")
    out = dict(dtype=small.dtype, held=hold, loss_rel=rel,
               worst_leaf=max(worst, key=worst.get),
               worst=max(worst.values()))
    if routed:
        out.update(moe_calls=len(routed), tokens_routed_apart=flipped)
    return out


def check_train_resume(name: str, seq: int, batch: int) -> dict:
    """Checkpoint and resume through ``train``: 3 steps of a 2-layer
    full-width model with a checkpoint after step 2 (``save(block=
    False)``, as ``train`` saves) and at the end; the last checkpoint is
    removed and a second ``train`` from a fresh seeded init resumes from
    step 2.  Its first loss must be bitwise the uninterrupted run's third
    (the forward on the card is deterministic; the backward's atomics,
    the embedding's gradient, are not, so later steps may differ in the
    last bits).  Returns both losses."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import train
    small = dataclasses.replace(_train_config(name), n_layers=2)
    ckpt = os.path.join(SCRATCH, "ckpt", name.replace(":", "-"))
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


def train_cli(steps: int = 2) -> dict:
    """``python -m repro_torch.launch.train`` with no ``--arch``: the
    JAX package's default, xlstm-125m at full width and 4 x 256, on the
    card (the CLI's default device), cut to ``steps`` steps.  Returns its
    final loss and wall seconds."""
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps",
         str(steps)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    lines = res.stdout.strip().splitlines()
    m = re.search(r"final loss (\S+)", lines[-1] if lines else "")
    if res.returncode or not m or not np.isfinite(float(m.group(1))):
        raise AssertionError(f"train CLI: rc {res.returncode}, stdout "
                             f"{res.stdout[-2000:]}, stderr "
                             f"{res.stderr[-2000:]}")
    return dict(final_loss=float(m.group(1)), lines=lines,
                wall_s=time.monotonic() - t0)


# every training path
TRAINED = tuple(TRAIN_PATHS) + tuple(BIG_TRAIN_PATHS)
# the 2-layer full-width resumes: hymba-1.5b's, and the
# single-card configurations' (musicgen-large on its frame embeddings,
# yi-6b: 0.93 B parameters at 2 layers, a 9.3 GB checkpoint), (seq, batch)
RESUMES = {"hymba-1.5b": (512, 2), MAMBA_PATH: (512, 2),
           "musicgen-large:audio": (256, 2), "yi-6b": (256, 2)}


def training_phase(card: str, step_times: dict) -> dict:
    """Train every path, the 2-layer CPU checks and the resumes; prints
    what it measured with the card's name and power limit, and for each
    path in ``SCOPED_PATHS`` one line of its train step by named scope:
    device ms (``time_train``'s ``step_times``) and, where the path is
    profiled, the share of PC samples under the step's placeholder.
    Returns {path: train_path's result}."""
    runs = {}
    for name in TRAINED:
        if name in BIG_TRAIN_PATHS:
            reckon_train(name)
        runs[name] = train_path(name)
        torch.cuda.empty_cache()
        shown = {k: v for k, v in runs[name].items() if k != "profiler"}
        print(f"train {name} ({card}): {json.dumps(shown)}; profiler "
              f"{json.dumps(runs[name].get('profiler'))}", flush=True)
    for name in SCOPED_PATHS:
        print(f"scopes {name} train step ({card}): device ms "
              f"{json.dumps(step_times[name]['scope_ms'])} (busy "
              f"{step_times[name]['device_busy_ms']:.3f} ms a step under "
              f"torch.profiler); PC-sample shares under train_step "
              f"{json.dumps(runs[name].get('scope_samples'))}", flush=True)
    for name in TRAINED:
        if name in ("hymba-1.5b",):     # its 2-layer model runs the resume
            continue
        spec = _train_spec(name)
        for dtype, hold in spec.get("cpu_checks", ((None, True),)):
            cpu = check_train_against_cpu(name, 64, 0,
                                          spec.get("cpu_blocks"), dtype,
                                          hold)
            runs[name].setdefault("cpu", []).append(cpu)
            print(f"{name}: 2-layer full-width train step (B=2, S=64) vs "
                  f"CPU plain ({card}): {json.dumps(cpu)}", flush=True)
    cli = train_cli()
    print(f"python -m repro_torch.launch.train (no arguments but --steps "
          f"2: xlstm-125m, 4 x 256, on the card): {json.dumps(cli)}",
          flush=True)
    for name, (seq, batch) in RESUMES.items():
        res = check_train_resume(name, seq, batch)
        runs[name]["resume"] = res
        print(f"{name}: 2-layer full-width resume ({batch} x {seq}) from an "
              f"async checkpoint ({card}): bitwise equal loss "
              f"{json.dumps(res)}", flush=True)
    return runs


def big_training_timings(card: str) -> dict:
    """The single-card training paths' train steps (``time_train``: host
    wall, device busy, scopes, the step's peak memory against its
    reckoning) with nothing else on the card, before any profiled serve
    (their kernels are timed before, in ``main``'s kernel timings), each
    after ``reckon_train``.  Prints each; returns {path: step times}."""
    step_times = {}
    for name in BIG_TRAIN_PATHS:
        reckon_train(name)
        step_times[name] = time_train(name)
        print(f"{name} train step ({card}): "
              f"{json.dumps(step_times[name])}", flush=True)
    return step_times


# the examples that port the JAX package's examples which drive JAX, run
# on the card, each a process of its own, all at once
EXAMPLES = ("torch_quickstart.py", "torch_serve_batch.py",
            "torch_find_redundant_sync.py", "torch_blame_analysis.py",
            "torch_counter_report.py", "torch_trace_timeline.py",
            "torch_continuous_profiling.py", "torch_analyze_db.py")
# the stalls ``torch_blame_analysis`` injects, as the JAX example does:
# six 10 ms preprocessing regions and one 50 ms JIT stall, in the order
# the blame ranks them when each sleep lasts its length; how far past its
# measured length the JIT stall's blame may run; and within how many ms
# the two measured lengths tie (the preprocessing regions' blame also
# holds the loop's host work between their sleeps: 0.3-1.3 ms past 60 ms,
# sleeps' overrun included, in three runs on an H100 80GB HBM3 at 700 W)
BLAME_STALLS_MS = {"host_preprocessing": 60.0, "runtime_jit_compile": 50.0}
BLAME_SLACK = 1.25
BLAME_TIE_MS = 2.0


def check_blame(text: str) -> tuple:
    """``torch_blame_analysis``'s output must blame its two stalls first,
    each for at least the length it measured (``stalls measured``, less
    1% for the printed rounding of its share), the JIT stall for at most
    ``BLAME_SLACK`` times its measured length (the preprocessing regions
    also hold the loop's host work between their sleeps, so only their
    floor is held), ranked as their measured lengths rank them (either
    order within ``BLAME_TIE_MS``).  A sleep can run past its length on a
    busy host: in one run on the card the JIT stall's lasted 69.7 ms and
    ranked first, rightly.  When each lasts its length (``BLAME_STALLS_MS``)
    that is the JAX example's ranking, ``host_preprocessing`` first.
    Returns [(context, blamed ms)] in the example's order and the measured
    lengths."""
    stalled = json.loads(re.search(r"stalls measured \(ms\): (.*)",
                                   text).group(1))
    idle_ms = float(re.search(r"all-streams-idle time: ([\d.]+) ms",
                              text).group(1))
    blame = [(name, float(pct) / 100 * idle_ms) for pct, name in re.findall(
        r"^\s+([\d.]+)%\s+(\S+)", text.split("GPU Idleness Blame")[-1],
        re.M)]
    names = [name for name, _ in blame[:2]]
    ms = dict(blame[:2])
    jit, pre = "runtime_jit_compile", "host_preprocessing"
    ranked = sorted(BLAME_STALLS_MS, key=stalled.get, reverse=True)
    tie = abs(stalled[jit] - stalled[pre]) < BLAME_TIE_MS
    if any(stalled[k] < v for k, v in BLAME_STALLS_MS.items()) \
            or sorted(names) != sorted(BLAME_STALLS_MS) \
            or (names != ranked and not tie) \
            or any(ms[k] < 0.99 * stalled[k] for k in BLAME_STALLS_MS) \
            or ms[jit] > BLAME_SLACK * stalled[jit]:
        raise AssertionError(f"torch_blame_analysis: blamed ms {blame} of "
                             f"{idle_ms} idle; stalls measured {stalled}, "
                             f"asked {BLAME_STALLS_MS}")
    return blame, stalled


def run_examples(timeout: float = 400.0) -> dict:
    """Run every one of ``EXAMPLES`` with ``--device cuda`` (their
    temporary files under ``build/chip_smoke/examples``), each must exit
    0 and say it ran on cuda; then read what three of them found:
    ``torch_find_redundant_sync`` a context with diff > 0,
    ``torch_blame_analysis`` its stalls blamed for their measured lengths
    (``check_blame``), ``torch_serve_batch`` PC samples in the
    flash prefill kernel's calls under prefill and the decode kernel's
    under decode.  Returns {example: wall seconds, the findings}."""
    import ast
    torch.cuda.empty_cache()     # the card's memory for their processes
    tmp = os.path.join(SCRATCH, "examples")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TMPDIR=tmp)
    t0 = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cuda"], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in EXAMPLES}
    outs, wall = {}, {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(
                timeout=max(1.0, timeout - (time.monotonic() - t0)))
            wall[name] = time.monotonic() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        out, err = outs[name]
        if proc.returncode or "device: cuda" not in out:
            raise AssertionError(f"{name}: exit {proc.returncode}\n"
                                 f"{out[-2000:]}\n{err[-2000:]}")
    diffs = [int(d) for d in re.findall(
        r"diff=\s*(\d+)", outs["torch_find_redundant_sync.py"][0])]
    blame, stalled = check_blame(outs["torch_blame_analysis.py"][0])
    calls = ast.literal_eval(re.search(
        r"kernel calls with PC samples, by step: (.*)",
        outs["torch_serve_batch.py"][0]).group(1))
    found = dict(sync_diffs=diffs, blame_ms=blame, stalls_ms=stalled,
                 serve_calls=calls)
    if not diffs or max(diffs) <= 0:
        raise AssertionError(f"torch_find_redundant_sync: no context with "
                             f"diff > 0: {diffs}")
    if not any(c.startswith("flash_attention")
               for c in calls.get("prefill", ())) or not any(
            c.startswith("flash_decode") for c in calls.get("decode_step",
                                                          ())):
        raise AssertionError(f"torch_serve_batch: kernel calls with PC "
                             f"samples {calls}")
    return dict(wall_s=wall, found=found)


# ---------------------------------------------------------------------------
# 12. multi-rank: the sharded train step and serving steps over
# torch.distributed, in child processes (this process joins no group)
# ---------------------------------------------------------------------------
MULTI_RANK = "granite-moe-1b-a400m"
MR_LAYERS = 8    # the multi-rank phase's depth (CUT_DEPTH's is 6)
MR_BATCH, MR_SEQ, MR_STEPS = 4, 512, 3
MR_PROMPT, MR_DECODE = 512, 8
# the sharded losses and grad norms against the unsharded run's, relative
# to the largest (one rank read bitwise, two ranks 3.2e-5 on the losses,
# on an H100 80GB HBM3 at 700 W), and each step's loss change from the
# first (loss[i] - loss[0], about 0.07 a step) against the unsharded
# change, relative to it: a step that skips or misapplies its update
# moves the loss by another amount
MR_LOSS_TOL = 1e-3
MR_DELTA_TOL = 5e-2
MR_TIMEOUT = 300.0
# the dry run's peak (``launch.dryrun.graph_memory``: a liveness walk over
# the recorded step) against torch.cuda.max_memory_allocated over the
# step on the card, relative to the measured peak
MR_PEAK_TOL = 0.10
# the dry run's FLOPs (the recorded step's products and the kernels'
# interiors) against FlopCounterMode over the step on the card: the same
# products, summed in another order
MR_FLOPS_TOL = 1e-9
# a collective as torch.profiler names it by its backend (the c10d op
# around it is a second event of the same call)
MR_COLLECTIVE = re.compile(r"^(nccl|gloo):")


def collective_op_events(events) -> dict:
    """The port's collective op events (``repro_torch::all_reduce``, ...)
    in a torch.profiler trace, by HLO kind: ``events`` all of them,
    ``calls`` those that run the collective (no event of the same op
    inside them), ``mode_entries`` the others and ``calls_under_mode``
    the calls inside one.  torch.profiler records an op at every entry to
    the dispatcher, and a TorchDispatchMode re-enters it for every op it
    intercepts: the remat's selective checkpoint runs each period (its
    forward and its recompute in the backward) under one, so a collective
    called there has two events, the mode's entry and the call, for one
    collective.  So ``events`` = ``calls`` + ``calls_under_mode``, and
    ``calls`` is what ran."""
    from repro_torch.distributed.shardmap_compat import COLLECTIVE_OPS

    def inside(e, name) -> bool:
        return any(c.name == name or inside(c, name) for c in e.cpu_children)

    def under(e, name) -> bool:
        p = e.cpu_parent
        while p is not None:
            if p.name == name:
                return True
            p = p.cpu_parent
        return False
    out: dict = {}
    for e in events:
        kind = COLLECTIVE_OPS.get(e.name)
        if kind is None:
            continue
        n = out.setdefault(kind, dict(events=0, calls=0, mode_entries=0,
                                      calls_under_mode=0))
        n["events"] += 1
        if inside(e, e.name):
            n["mode_entries"] += 1
        else:
            n["calls"] += 1
            n["calls_under_mode"] += under(e, e.name)
    return out


def check_collective_events(ops: dict, calls: dict, what: str) -> None:
    """Hold ``collective_op_events``' counts to the collectives that ran
    (``calls``, by kind: the backend's or the dry run's): each kind's
    calls are them, every mode entry holds one call, and the events are
    the calls plus the calls under a mode, no other."""
    got = {k: v["calls"] for k, v in ops.items()}
    if got != calls:
        raise AssertionError(f"{what}: the collective ops' calls {got}, "
                             f"against {calls}")
    for kind, n in ops.items():
        if n["mode_entries"] != n["calls_under_mode"] or \
                n["events"] != n["calls"] + n["calls_under_mode"]:
            raise AssertionError(f"{what}: {kind} op events {n}")


def _mr_config():
    """granite-moe at published widths and ``MR_LAYERS`` layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MULTI_RANK), n_layers=MR_LAYERS)


def _mr_counts_zero() -> None:
    from repro_torch.kernels import ops
    for name in KERNELS:
        getattr(ops, name).launches = 0


def _mr_counts() -> dict:
    from repro_torch.kernels import ops
    return {name: getattr(ops, name).launches for name in KERNELS}


def _mr_step_timing(step, params, opt_state, batch,
                    profiled: bool = True) -> dict:
    """One sharded train step's wall (host clock to a synchronize, mean of
    2 after a warm step) and, in one later step under torch.profiler (CPU
    and CUDA), the device's busy ms (the union of this process's kernels'
    intervals) and idle share (1 - busy / the unprofiled wall, unclamped:
    below 0 where the profiled step's busy time exceeds the unprofiled
    wall, which then does not resolve it), the collectives' count and
    host ms, and NCCL's device ms.  Runs before any other profiled window
    of the process; ``profiled=False`` takes the wall alone."""
    from torch.profiler import ProfilerActivity, profile
    step(params, opt_state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        step(params, opt_state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    if not profiled:
        return dict(step_wall_ms=wall_ms)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    coll = [e for e in prof.events() if e.device_type.name == "CPU"
            and MR_COLLECTIVE.search(e.name)]
    op_events = collective_op_events(prof.events())
    by_kind: dict = {}
    for e in coll:   # "gloo:all_reduce" -> "all-reduce"
        kind = e.name.split(":", 1)[1].replace("_", "-")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    nccl_dev = sum(e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.device_type.name == "CUDA" and "nccl" in e.name)
    return dict(step_wall_ms=wall_ms, window_ms=window_ms,
                device_busy_ms=busy / 1e3,
                idle_share=1 - busy / 1e3 / wall_ms,
                collectives=len(coll),
                collective_host_ms=sum(e.time_range.end - e.time_range.start
                                       for e in coll) / 1e3,
                nccl_device_ms=nccl_dev / 1e3,
                kinds=sorted({e.name for e in coll}),
                collectives_by_kind=by_kind, op_events=op_events)


def _mr_kernel_times(h: int, hkv: int) -> dict:
    """The two attention kernels at a rank's shapes (``h`` q and ``hkv``
    kv heads), as ``time_kernels`` times a path's, and each held against
    its plain version on the same inputs: {kernel: (times, max abs
    err)}."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    cfg = _mr_config()
    d = cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    fns, flops, nbytes = _flash_fns(gen, MR_BATCH, MR_SEQ, h, hkv, d, 0)
    q = _randn((MR_BATCH, MR_SEQ, h, d), gen)
    k = _randn((MR_BATCH, MR_SEQ, hkv, d), gen)
    v = _randn((MR_BATCH, MR_SEQ, hkv, d), gen)
    err_f, _ = _err(ops.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v))
    out = {"flash_attention": (_timed(fns, flops, nbytes)[0], err_f)}
    length = MR_PROMPT + MR_DECODE // 2
    smax = MR_PROMPT + MR_DECODE
    qd = _randn((MR_BATCH, h, d), gen, 0.5)
    kc = _randn((MR_BATCH, smax, hkv, d), gen, 0.5)
    vc = _randn((MR_BATCH, smax, hkv, d), gen, 0.5)
    kl, vl = (c[:, :length].transpose(1, 2) for c in (kc, vc))
    err_d, _ = _err(ops.flash_decode(qd, kc, vc, length),
                    fd.flash_decode_plain(qd, kc, vc, length))
    fns = dict(ms=lambda: ops.flash_decode(qd, kc, vc, length),
               plain_ms=lambda: fd.flash_decode_plain(qd, kc, vc, length),
               library_ms=lambda: F.scaled_dot_product_attention(
                   qd[:, :, None], kl, vl, enable_gqa=True))
    out["flash_decode"] = (_timed(fns, *fd.work(MR_BATCH, h, hkv, d,
                                                length))[0], err_d)
    return out


def _mr_seq_kernel(rank: int, world: int) -> dict:
    """The decode kernel with its log-sum-exp output at a rank's shapes in
    the seq-split serve (the q heads gathered, every kv head, this rank's
    slots of the cache): timed as ``time_kernels`` times a path's (the
    bound and SDPA over the valid slots), and held against its plain
    version, output and lse, at a full slice, a part of one and a slice
    with no valid slot (length 0: output 0, lse -inf).  Returns
    {"flash_decode": (times, max abs err of the output and the lse)}."""
    from repro_torch.kernels import decode_attention as fd
    from repro_torch.kernels import ops
    cfg = _mr_config()
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = (MR_PROMPT + MR_DECODE) // world
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13 + rank)
    q = _randn((MR_BATCH, h, d), gen, 0.5)
    kc = _randn((MR_BATCH, n, hkv, d), gen, 0.5)
    vc = _randn((MR_BATCH, n, hkv, d), gen, 0.5)
    err = 0.0
    for length in (n, n // 2 + 1, 0):
        out, lse = ops.flash_decode(q, kc, vc, length, with_lse=True)
        want, want_lse = fd.flash_decode_plain(q, kc, vc, length,
                                               with_lse=True)
        if not torch.equal(out, ops.flash_decode(q, kc, vc, length)):
            raise AssertionError(f"flash_decode: the output with lse "
                                 f"differs from the output without, at "
                                 f"length {length}")
        if length == 0:
            if out.any() or not torch.isneginf(lse).all():
                raise AssertionError("flash_decode at length 0: output "
                                     "not 0 or lse not -inf")
            continue
        err = max(err, _err(out, want)[0],
                  float((lse - want_lse).abs().max()))
        if float((lse - want_lse).abs().max()) > TOL["atol"]:
            raise AssertionError(f"flash_decode lse off its plain version "
                                 f"at length {length}")
    kl, vl = (c.transpose(1, 2) for c in (kc, vc))
    fns = dict(ms=lambda: ops.flash_decode(q, kc, vc, n, with_lse=True),
               plain_ms=lambda: fd.flash_decode_plain(q, kc, vc, n,
                                                      with_lse=True),
               library_ms=lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kl, vl, enable_gqa=True))
    return {"flash_decode": (_timed(fns, *fd.work(MR_BATCH, h, hkv, d,
                                                  n))[0], err)}


def _mr_setup(mesh):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as S
    cfg = _mr_config()
    plan = S.make_plan(mesh, strategy="tp")
    shape = ShapeConfig("train", MR_SEQ, MR_BATCH, "train")
    return cfg, plan, shape, _train_opts(MR_SEQ)


def _mr_train(cfg, shape, opts, params, mesh=None) -> dict:
    """3 donated steps of ``train`` (sharded with a mesh): losses, grad
    norms, launch counts (set to 0 just before, read just after) and the
    peak memory."""
    from repro_torch.launch.train import train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _mr_counts_zero()
    t0 = time.perf_counter()
    _, hist, _ = train(cfg, shape, n_steps=MR_STEPS, opts=opts,
                       device="cuda", params=params, log_every=1,
                       mesh=mesh, strategy="tp")
    torch.cuda.synchronize()
    return dict(losses=[h["loss"] for h in hist],
                gnorms=[h["gnorm"] for h in hist], launches=_mr_counts(),
                peak_bytes=torch.cuda.max_memory_allocated(),
                wall_s=time.perf_counter() - t0)


def _mr_timed_step(cfg, plan, opts, params, profiled: bool = True,
                   count_flops: bool = False) -> dict:
    """``_mr_step_timing`` of the donated step, its peak memory (from
    before its AdamW state is made: every other tensor of the process is
    the caller's to free) and, with ``count_flops``, the FLOPs that
    ``FlopCounterMode`` counts over one more step (its products and the
    kernels' ``work``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import adamw
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params)
    step = steps_mod.make_train_step(cfg, opts, adamw.OptConfig(),
                                     donate=True, plan=plan)
    batch = _lm_batch(cfg, MR_BATCH, MR_SEQ)
    out = _mr_step_timing(step, params, opt, batch, profiled)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if count_flops:
        with FlopCounterMode(display=False) as counter:
            step(params, opt, batch)
        torch.cuda.synchronize()
        out["flops"] = float(counter.get_total_flops())
    return out


def _mr_dry_run(cfg, plan, shape, opts, desc: str) -> dict:
    """The dry run (``launch.dryrun.dry_run``) of this rank's train step on
    the live mesh: the step recorded on meta tensors (nothing runs on the
    card, no collective moves), its roofline and its memory."""
    from repro_torch.launch import dryrun
    t0 = time.monotonic()
    rec = dryrun.dry_run(cfg, shape, plan, label=f"{MULTI_RANK}_{desc}",
                         mesh_desc=desc, opts=opts)
    return dict(flops=rec["cost"]["flops"],
                peak_bytes=rec["memory"]["peak_per_device"],
                argument_bytes=rec["memory"]["argument_bytes"],
                step_time_ms=rec["roofline"]["step_time_s"] * 1e3,
                dominant=rec["roofline"]["dominant"],
                collectives=rec["collectives"], kernels=rec["kernels"],
                graph_nodes=rec["graph_nodes"],
                seconds=time.monotonic() - t0)


def _mr_one(mesh, rank: int, d: str) -> dict:
    """One rank over NCCL, mesh (1, 1): the unsharded ``train`` and the
    sharded one from the same seeded weights (tempered, ``_temper``: the
    untempered bf16 model is chaotic, its unsharded prefill on the card
    and on the CPU 0.95 of the largest logit apart at 8 layers) and
    batches."""
    from repro_torch.distributed import sharding as S
    from repro_torch.tree import tree_map
    cfg, plan, shape, opts = _mr_setup(mesh)
    kernels = _mr_kernel_times(cfg.n_heads, cfg.n_kv_heads)
    del kernels["flash_decode"]     # no decode on this path
    p0 = _temper(init_params(MULTI_RANK, _mr_config()))
    # the unsharded runs, then the sharded ones without the whole weights:
    # each holds one copy of the weights beside the one it trains
    unsharded = _mr_train(cfg, shape, opts, tree_map(torch.clone, p0))
    timing_unsharded = _mr_timed_step(cfg, None, opts,
                                      tree_map(torch.clone, p0),
                                      profiled=False)
    sp = S.shard_tree(p0, S.param_shardings(p0, cfg, plan))
    del p0
    sharded = _mr_train(cfg, shape, opts, tree_map(torch.clone, sp), mesh)
    # the measured step holds its own inputs alone: its peak is the dry
    # run's to match
    params = tree_map(torch.clone, sp)
    del sp
    timing = _mr_timed_step(cfg, plan, opts, params, count_flops=True)
    dry = _mr_dry_run(cfg, plan, shape, opts, "1x1")
    return dict(unsharded=unsharded, sharded=sharded, timing=timing,
                timing_unsharded=timing_unsharded, kernels=kernels, dry=dry)


def _mr_two(mesh, rank: int, d: str) -> dict:
    """Two ranks sharing the card over gloo, mesh (1, 2): the sharded
    train, one layer's attention on a rank's heads against the whole
    layer's, the sharded prefill and decode steps against the unsharded
    ones (rank 0), a sharded checkpoint restored whole on rank 0."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import shardmap_compat as smc
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves_with_paths, tree_map
    cfg, plan, shape, opts = _mr_setup(mesh)
    m = mesh.shape["model"]
    h, hkv = cfg.n_heads // m, cfg.n_kv_heads // m
    # the kernels' windows first: later windows of the process lose
    # records (ROADMAP §3)
    kernels = _mr_kernel_times(h, hkv)
    seq_kernels = _mr_seq_kernel(rank, mesh.size)
    p0 = _temper(init_params(MULTI_RANK, _mr_config()))
    sp = S.shard_tree(p0, S.param_shardings(p0, cfg, plan))
    attn = sp["layers"]["e0"]["attn"]
    assert smc.local(attn["wq"]).shape[2] == h and \
        smc.local(attn["wk"]).shape[2] == hkv, "a rank's heads"
    # one layer's attention: this rank's heads, gathered, against the
    # whole layer's through the unsharded kernel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = _randn((MR_BATCH, MR_SEQ, cfg.d_model), gen)
    pos = torch.arange(MR_SEQ, device="cuda")
    full = {k: v[0] for k, v in p0["layers"]["e0"]["attn"].items()}
    mine = {k: smc.local(v)[0] for k, v in attn.items()}
    with torch.no_grad():
        q, k, v = attn_mod.project_qkv(full, x, cfg, pos)
        want = ops.flash_attention(q, k, v)
        q, k, v = attn_mod.project_qkv(mine, x, cfg, pos)
        with smc.bind(mesh):
            got = smc.all_gather(ops.flash_attention(q, k, v), "model",
                                 axis=2)
    attn_err, attn_row = _err(got, want)
    # the sharded train
    trained = _mr_train(cfg, shape, opts, tree_map(torch.clone, sp), mesh)
    # sharded prefill and decode
    toks = torch.randint(0, cfg.vocab, (MR_BATCH, MR_PROMPT + MR_DECODE),
                         generator=gen, device="cuda")

    def serve_steps(params, pl, kv_seq_axis=None):
        pre = steps_mod.make_prefill_step(cfg, opts, plan=pl,
                                          kv_seq_axis=kv_seq_axis)
        dec = steps_mod.make_decode_step(cfg, opts, plan=pl)
        _mr_counts_zero()
        logits, cache = pre(params, {"tokens": toks[:, :MR_PROMPT]})
        if kv_seq_axis:
            # a cache split over its sequence is laid out by its length:
            # grown whole, as serve grows it, and split again
            from repro_torch.launch.serve import _grow_cache
            whole = _grow_cache(tree_map(lambda t: smc.gather_full(
                t, mesh), cache), MR_PROMPT + MR_DECODE, MR_PROMPT)
            cache = S.shard_tree(whole, S.cache_shardings(
                whole, cfg, pl, kv_seq_axis=kv_seq_axis))
            del whole
        else:
            big = T.init_cache(cfg, MR_BATCH, MR_PROMPT + MR_DECODE,
                               device="cuda")
            if pl is not None:
                big = S.shard_tree(big, S.cache_shardings(big, cfg, pl))
            for e, c in cache.items():
                for key, val in c.items():
                    smc.local(big[e][key])[:, :, :MR_PROMPT] = \
                        smc.local(val)
            cache = big
        outs = [smc.gather_full(logits, mesh)]
        for i in range(MR_DECODE - 1):
            logits, cache = dec(params, cache, MR_PROMPT + i,
                                token=toks[:, MR_PROMPT + i])
            outs.append(smc.gather_full(logits, mesh))
        torch.cuda.synchronize()
        return torch.stack(outs), _mr_counts()
    # bf16 rounding that differs between the row-parallel partial sums
    # and the whole products flips near-ties of the router's top 8 of 32
    # (a flipped expert moves a token's logits by O(1)): the unsharded
    # run's expert choices are replayed in the sharded one
    # (``_pinned_routing``), which counts the tokens whose own choice
    # differed
    import torch.distributed as dist
    routing = os.path.join(d, "routing.pt")
    if rank == 0:
        record = []
        with _pinned_routing(record):
            want_l, _ = serve_steps(p0, None)
        torch.save(record, routing)
    dist.barrier()
    flips = []
    with _pinned_routing(flips, replay=torch.load(routing)):
        served, serve_launches = serve_steps(sp, plan)
    # the cache split over its sequence (``kv_seq_axis="model"``): each
    # rank holds its slots of every kv head, and decode merges the ranks'
    # partial attentions by their log-sum-exp
    seq_flips = []
    with _pinned_routing(seq_flips, replay=torch.load(routing)):
        served_seq, seq_launches = serve_steps(sp, plan, "model")
    serve_err = serve_steps_err = seq_err = None
    if rank == 0:
        diff = (served.float() - want_l.float()).abs()
        scale = want_l.float().abs().max()
        serve_err = float(diff.max() / scale)
        serve_steps_err = (diff.amax(dim=(1, 2)) / scale).tolist()
        seq_err = float((served_seq.float() - want_l.float()).abs().max()
                        / scale)
    # a sharded checkpoint, restored whole on rank 0
    whole = tree_map(lambda t: smc.gather_full(t, mesh), sp)
    mgr = CheckpointManager(os.path.join(d, "ckpt"))
    mgr.save(1, {"params": sp})
    restored = None
    if rank == 0:
        like = {"params": tree_map(torch.empty_like, whole)}
        _, back = CheckpointManager(os.path.join(d, "ckpt")).restore(like)
        restored = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_paths(back["params"]), leaves_with_paths(whole)))
    del whole
    timing = _mr_timed_step(cfg, plan, opts, tree_map(torch.clone, sp))
    dry = _mr_dry_run(cfg, plan, shape, opts, "1x2")
    # one profiled train step a rank (after every torch.profiler window of
    # this process): each writes its own directory, rank 0 merges both
    from repro_torch.launch.train import train
    prof_dir = os.path.join(d, "prof")
    _, _, paths = train(cfg, shape, n_steps=1, opts=opts, device="cuda",
                        params=tree_map(torch.clone, sp), mesh=mesh,
                        strategy="tp", profile_dir=prof_dir)
    with open(paths["measurement"]) as f:
        registered = json.load(f)["steps"]["train_step"]
    dist.barrier()
    merged = None
    if rank == 0:
        import glob
        from repro_torch.core.aggregate import aggregate
        db = aggregate(sorted(glob.glob(os.path.join(
            prof_dir, "rank*", "profile_*.rpro"))), os.path.join(d, "db"))
        merged = sorted({int(i["rank"]) for i in db.profile_ids.values()})
    return dict(sharded=trained, heads=[h, hkv], attn_err=attn_err,
                attn_row=attn_row, serve_launches=serve_launches,
                serve_err=serve_err, serve_steps_err=serve_steps_err,
                routing_flips=sum(flips), seq_err=seq_err,
                seq_launches=seq_launches, seq_flips=sum(seq_flips),
                seq_kernels=seq_kernels,
                restored_bitwise=restored, dry=dry,
                profiled=dict(dir=os.path.basename(os.path.dirname(
                    paths["measurement"])), collectives=registered[
                    "collectives"], custom_calls=registered["custom_calls"],
                    seconds=registered["seconds"], merged_ranks=merged),
                timing=timing, kernels=kernels,
                host_staged=sorted(smc.GLOO_HOST_STAGED))


def _rank_child(kind: str, rank: int, world: int, d: str) -> int:
    """One rank of the multi-rank phase (``chip_smoke.py --rank-child``):
    joins its group (NCCL for one rank, gloo for two sharing the card),
    runs its part and writes its results as JSON into ``d``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    backend = "nccl" if kind == "one" else "gloo"
    mesh_mod.init_process(backend, rank=rank, world_size=world,
                          init_method=f"file://{d}/store-{kind}",
                          device="cuda")
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"), "cuda")
    res = (_mr_one if kind == "one" else _mr_two)(mesh, rank, d)
    res["backend"] = backend
    with open(os.path.join(d, f"{kind}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_ranks(kind: str, world: int, d: str) -> list:
    """Run ``world`` rank processes of ``kind``; each must exit 0 within
    ``MR_TIMEOUT``.  Returns their results."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [open(os.path.join(d, f"{kind}_rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", kind,
         str(r), str(world), d], stdout=logs[r], stderr=subprocess.STDOUT,
        env=env) for r in range(world)]
    deadline = time.monotonic() + MR_TIMEOUT
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        logs[r].seek(0)
        text = logs[r].read()
        logs[r].close()
        if proc.returncode:
            raise AssertionError(f"multi_rank {kind} rank {r}: exit "
                                 f"{proc.returncode}\n{text[-3000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(d, f"{kind}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def multi_rank_phase(card: str) -> dict:
    """granite-moe-1b-a400m at full width and ``MR_LAYERS``, 4 x 512,
    through ``train(mesh=..., strategy="tp")`` and the sharded steps, in
    child processes: one rank over NCCL on a (1, 1) mesh against the
    unsharded ``train`` (losses and grad norms within ``MR_LOSS_TOL``,
    each step's loss change within ``MR_DELTA_TOL`` of the unsharded
    change, the unsharded flash launches), then two ranks sharing the card over gloo on (1, 2)
    (each rank's flash on its 8 q / 4 kv heads, 2 launches a layer a step; one
    layer's attention gathered against the whole layer's; sharded prefill
    of 4 x 512 and 7 decode steps against the unsharded steps, one decode
    launch a layer a step on each rank; a sharded checkpoint restored
    whole, bitwise).  Each rank's step wall, device busy and idle share,
    collectives and peak memory are printed.  Returns both runs."""
    torch.cuda.empty_cache()     # the card's memory for the ranks
    d = os.path.join(SCRATCH, "multi_rank")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cfg = _mr_config()
    t0 = time.monotonic()
    one = _spawn_ranks("one", 1, d)[0]
    t_one = time.monotonic() - t0
    two = _spawn_ranks("two", 2, d)
    seconds = time.monotonic() - t0
    per_step = LAUNCHES_PER_LAYER * cfg.n_layers
    u, s = one["unsharded"], one["sharded"]
    base = np.asarray(u["losses"])
    moved = base[1:] - base[0]

    def off(run) -> dict:
        """A run's losses, grad norms and loss changes against the
        unsharded run's."""
        loss, gn = np.asarray(run["losses"]), np.asarray(run["gnorms"])
        ug = np.asarray(u["gnorms"])
        return dict(
            loss=float(np.abs(loss - base).max() / np.abs(base).max()),
            gnorm=float(np.abs(gn - ug).max() / np.abs(ug).max()),
            delta=float((np.abs(loss[1:] - loss[0] - moved)
                         / np.abs(moved)).max()))

    def check(run, what) -> dict:
        o = off(run)
        if o["loss"] > MR_LOSS_TOL or o["gnorm"] > MR_LOSS_TOL or \
                o["delta"] > MR_DELTA_TOL:
            raise AssertionError(
                f"multi_rank {what}: losses {run['losses']} grad norms "
                f"{run['gnorms']} against the unsharded {u['losses']} "
                f"{u['gnorms']}: {o}")
        return o
    if not np.isfinite(base).all() or not np.isfinite(u["gnorms"]).all():
        raise AssertionError(f"multi_rank: unsharded losses {base}, grad "
                             f"norms {u['gnorms']}")
    if np.abs(moved).min() < 1e-3:
        raise AssertionError(f"multi_rank: the unsharded losses {base} "
                             f"hardly move")
    one["off"] = check(s, "one rank")
    # a train step: flash and each MoE layer's combine in the forward and
    # the remat's recompute, the combine's adjoint in the backward
    n_moe = len(cfg.moe_layers())
    trained = dict(flash_attention=per_step * MR_STEPS, flash_decode=0,
                   ssm_scan=0,
                   moe_combine=n_moe * LAUNCHES_PER_LAYER * MR_STEPS,
                   moe_uncombine=n_moe * MR_STEPS)
    for run, what in ((u, "unsharded"), (s, "one rank")):
        if run["launches"] != trained:
            raise AssertionError(f"multi_rank {what}: launches "
                                 f"{run['launches']}, want {trained}")
    # a served prefill and MR_DECODE - 1 decode steps
    served = dict(flash_attention=cfg.n_layers,
                  flash_decode=cfg.n_layers * (MR_DECODE - 1), ssm_scan=0,
                  moe_combine=n_moe * MR_DECODE, moe_uncombine=0)
    for r, res in enumerate(two):
        t = res["sharded"]
        res["off"] = check(t, f"two ranks, rank {r}")
        if t["launches"] != trained:
            raise AssertionError(f"multi_rank rank {r}: launches "
                                 f"{t['launches']}, want {trained}")
        want = served
        if res["serve_launches"] != want:
            raise AssertionError(f"multi_rank rank {r}: serving launches "
                                 f"{res['serve_launches']}, want {want}")
        if res["attn_row"] > ROW_TOL:
            raise AssertionError(f"multi_rank rank {r}: a layer's attention "
                                 f"on the rank's heads, gathered, row error "
                                 f"{res['attn_row']}")
    if two[0]["serve_err"] is None or two[0]["serve_err"] > TOL["rtol"]:
        raise AssertionError(f"multi_rank: sharded serving logits off the "
                             f"unsharded by {two[0]['serve_err']} of their "
                             f"largest (by step "
                             f"{two[0]['serve_steps_err']}; routings "
                             f"flipped {two[0]['routing_flips']})")
    if two[0]["restored_bitwise"] is not True:
        raise AssertionError("multi_rank: the sharded checkpoint did not "
                             "restore bitwise on one rank")
    dry = _mr_check_dry(one, two)
    for r, res in enumerate(two):
        want = served
        if res["seq_launches"] != want:
            raise AssertionError(f"multi_rank rank {r}: seq-split serving "
                                 f"launches {res['seq_launches']}, want "
                                 f"{want}")
        prof = res["profiled"]
        if prof["dir"] != f"rank{r}" or prof["collectives"] < 1 or \
                prof["custom_calls"] != _train_custom_calls(cfg):
            raise AssertionError(f"multi_rank rank {r}: profiled train "
                                 f"step {prof}")
    if two[0]["seq_err"] is None or two[0]["seq_err"] > TOL["rtol"]:
        raise AssertionError(f"multi_rank: seq-split serving logits off the "
                             f"unsharded by {two[0]['seq_err']} of their "
                             f"largest")
    if two[0]["profiled"]["merged_ranks"] != [0, 1]:
        raise AssertionError(f"multi_rank: the two ranks' profiles merged "
                             f"into ranks {two[0]['profiled']}")
    print(f"multi_rank ({card}): one rank over {one['backend']}: losses "
          f"{s['losses']} (unsharded {u['losses']}), grad norms "
          f"{s['gnorms']} (unsharded {u['gnorms']}), off the unsharded "
          f"{json.dumps(one['off'])}, flash launches "
          f"{s['launches']['flash_attention']} "
          f"({per_step} a step, the unsharded count), peak "
          f"{s['peak_bytes']} bytes (unsharded {u['peak_bytes']}); step "
          f"{json.dumps(one['timing'])}; unsharded step "
          f"{json.dumps(one['timing_unsharded'])}", flush=True)
    for r, res in enumerate(two):
        print(f"multi_rank ({card}): two ranks over {res['backend']} "
              f"(host-staged on CUDA: {res['host_staged']}), rank {r}: "
              f"{res['heads'][0]} q / {res['heads'][1]} kv heads, losses "
              f"{res['sharded']['losses']}, grad norms "
              f"{res['sharded']['gnorms']}, off the unsharded "
              f"{json.dumps(res['off'])}, launches train "
              f"{res['sharded']['launches']} serve "
              f"{res['serve_launches']}, attention gathered max abs err "
              f"{res['attn_err']} row {res['attn_row']}, peak "
              f"{res['sharded']['peak_bytes']} bytes; step "
              f"{json.dumps(res['timing'])}", flush=True)
    for r, res in enumerate(two):
        print(f"multi_rank ({card}): rank {r} seq-split serve "
              f"(kv_seq_axis=model: {MR_PROMPT + MR_DECODE} slots, "
              f"{(MR_PROMPT + MR_DECODE) // 2} a rank, every kv head) "
              f"launches {res['seq_launches']}, logits within "
              f"{res['seq_err']} of the unsharded steps' largest (rank 0 "
              f"compares), routings that would have flipped "
              f"{res['seq_flips']}; decode kernel with lse "
              f"{json.dumps(res['seq_kernels']['flash_decode'])}; profiled "
              f"train step {json.dumps(res['profiled'])}", flush=True)
    print(f"multi_rank ({card}): dry run against the card "
          f"{json.dumps(dry)}", flush=True)
    print(f"multi_rank ({card}): sharded serving logits within "
          f"{two[0]['serve_err']:.3g} of the unsharded steps' largest (the "
          f"unsharded expert choices replayed; "
          f"{two[0]['routing_flips']} token routings of rank 0 would have "
          f"flipped); the "
          f"sharded checkpoint restored bitwise on one rank; phase "
          f"{seconds:.1f} s (one rank {t_one:.1f} s)", flush=True)
    return dict(one=one, two=two, seconds=seconds)


def _mr_check_dry(one: dict, two: list) -> dict:
    """The dry run of the phase's granite step (``launch.dryrun.dry_run``
    on the live mesh) against the step on the card: at (1, 1) its FLOPs
    equal FlopCounterMode's over the step (``MR_FLOPS_TOL``), its peak
    is within ``MR_PEAK_TOL`` of torch.cuda.max_memory_allocated and its
    roofline time is at most the device's busy time; at (1, 2) each
    rank's collectives, by kind, are the backend's collectives
    (``gloo:all_reduce``, ...) torch.profiler finds in one step, and the
    port's collective op events are those calls plus the calls made under
    the remat's dispatch mode (``check_collective_events``).  Returns
    what was compared."""
    d, t = one["dry"], one["timing"]
    out = {"1x1": dict(
        flops=d["flops"], flops_counted=t["flops"],
        peak_bytes=d["peak_bytes"], peak_measured=t["peak_bytes"],
        peak_off=(d["peak_bytes"] - t["peak_bytes"]) / t["peak_bytes"],
        bound_ms=d["step_time_ms"], busy_ms=t["device_busy_ms"],
        dominant=d["dominant"], nodes=d["graph_nodes"],
        seconds=d["seconds"])}
    if abs(d["flops"] - t["flops"]) > MR_FLOPS_TOL * t["flops"]:
        raise AssertionError(f"multi_rank dry run: {d['flops']} FLOPs, the "
                             f"step on the card {t['flops']}")
    if abs(out["1x1"]["peak_off"]) > MR_PEAK_TOL:
        raise AssertionError(f"multi_rank dry run: peak {d['peak_bytes']} "
                             f"bytes, measured {t['peak_bytes']}")
    if d["step_time_ms"] > t["device_busy_ms"]:
        raise AssertionError(f"multi_rank dry run: roofline "
                             f"{d['step_time_ms']} ms above the measured "
                             f"busy {t['device_busy_ms']} ms")
    for r, res in enumerate(two):
        got, want = res["dry"]["collectives"], res["timing"][
            "collectives_by_kind"]
        ops = res["timing"]["op_events"]
        out[f"1x2 rank {r}"] = dict(collectives=got, profiled=want,
                                    op_events=ops,
                                    seconds=res["dry"]["seconds"])
        if got != want or not got:
            raise AssertionError(f"multi_rank dry run rank {r}: "
                                 f"collectives {got}, torch.profiler finds "
                                 f"{want}")
        check_collective_events(ops, got, f"multi_rank rank {r}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank-child"]:
        kind, rank, world, d = sys.argv[2:6]
        return _rank_child(kind, int(rank), int(world), d)
    start = time.monotonic()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    card = card_line()
    print(f"card: {card}", flush=True)

    def phase(what: str) -> None:
        print(f"phase: {what} done at {time.monotonic() - start:.1f} s",
              flush=True)
    seconds, ptxas = build_kernels()
    print(f"build_s: {seconds:.1f}", flush=True)
    for line in ptxas:
        print(f"ptxas {line}", flush=True)
    sass = check_sass()
    print(f"sass: every dot_general leaf's line has SASS instructions: "
          f"{json.dumps(sass)}", flush=True)
    phase("build and sass")
    errs, ratios = check_kernels()
    print(f"kernel checks passed: max abs err {errs}, largest row "
          f"err / row max {ratios}", flush=True)
    torch.cuda.empty_cache()
    train_errs, grad_errs = check_kernel_grads()
    # check_combine holds the combine at granite-moe's training shape
    # (COMBINE_SHAPES["train"]) among the others
    train_errs.update({(name, k): errs[k] for name in TRAINED
                       if _train_config(name).moe_layers()
                       for k in ("moe_combine", "moe_uncombine")})
    print(f"kernel forward checks at the training shapes passed: max abs "
          f"err {json.dumps({'/'.join(k): v for k, v in train_errs.items()})}"
          f"; gradient checks (the recompute's wiring) passed: max abs err "
          f"{grad_errs}; the forward ran the port's kernels, the backward "
          f"none", flush=True)
    phase("kernel checks")
    # every timing under torch.profiler before the first profiled run:
    # every path's kernels first, the windows of whole steps after
    names = list(PATHS) + list(SERVING_PATHS)
    times = {name: time_path(name) for name in names}
    times.update(time_big_kernels())
    print(f"flash_decode at G = 24 (no main path): "
          f"{json.dumps(time_decode_past_a_tile())}", flush=True)
    train_times = {}
    for name in TRAINED:
        train_times[name] = time_train_kernels(name)
        for kname, (t, calls) in train_times[name].items():
            print(f"{name} train {kname}: device {json.dumps(t)}; "
                  f"back-to-back call {json.dumps(calls)}", flush=True)
    print(f"moe_combine and moe_uncombine at granite.train1k's shape "
          f"({card}), by drop share: {json.dumps(time_combine_cell())}",
          flush=True)
    g4h_scan = time_g4h_scan(card)
    phase("kernel timings")
    # the reference's single-card configurations, one at a time, before
    # the four models below are allocated (qwen3-32b's weights alone are
    # 65.5 GB) and before any profiled serve
    big = {name: big_path(name, card) for name in BIG_PATHS}
    phase("single-card configurations")
    g4h = granite4h_path(card)
    phase(f"{GRANITE4H} path")
    # their training, alone on the card, before the four models below are
    # allocated (yi-6b's reckoned peak is most of the card)
    big_steps = big_training_timings(card)
    phase("single-card train step timings")
    params = {name: init_params(name) for name in names}
    for name in names:
        breakdown_path(name, params[name])
    phase("step breakdowns")
    step_times = {}
    for name in TRAIN_PATHS:
        step_times[name] = time_train(name)
        print(f"{name} train step ({card}): "
              f"{json.dumps(step_times[name])}", flush=True)
    step_times.update(big_steps)
    donated = step_times[DONATION_TIMED]
    print(f"{DONATION_TIMED} optimizer scope ({card}): functional "
          f"{donated['scope_ms_functional']['optimizer']:.3f} ms, donated "
          f"{donated['scope_ms']['optimizer']:.3f} ms a step", flush=True)
    for name in TRAINED:
        t = step_times[name]
        print(f"train {name} peak memory ({card}): "
              f"torch.cuda.max_memory_allocated over a step {t['peak_bytes']}"
              f" bytes, reckoned {t['reckoned_peak_bytes']} (batch "
              f"{t['batch']})", flush=True)
    phase("train step timings")
    runs = {name: serve_path(name, params.pop(name)) for name in PATHS}
    phase("profiled serves")
    runs.update({name: serving_path(name, params.pop(name))
                 for name in SERVING_PATHS})
    phase("serving-profiler serves")
    run_sweep_on_card()
    phase("sweep")
    train_runs = training_phase(card, step_times)
    phase("training")
    profiled_big_serve(card)
    phase("profiled single-card serve")
    mamba = profiled_big_serve(card, MAMBA_PATH, MAMBA_PROFILED_LAYERS)
    summary = mamba_summary(big, step_times, train_runs, mamba)
    print(f"MAMBA path ({card}): {json.dumps(summary)}", flush=True)
    phase("profiled MAMBA serve")
    ex = run_examples()
    print(f"examples on the card: {json.dumps(ex)}", flush=True)
    phase("examples")
    mr = multi_rank_phase(card)
    phase("multi_rank")
    print(f"total: {time.monotonic() - start:.1f} s ({card})", flush=True)

    kernels = []
    for path, run in runs.items():
        for kname, (t, _) in times[path].items():
            kernels.append(dict(
                name=kname, path=path, route="cuda",
                source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                launches=run["launches"][kname], max_abs_err=errs[kname],
                **t))
    for name, res in big.items():
        paths = [(name, res["serve"]["launches"])]
        if "frontend" in res:
            paths.append((f"{name}:{get_config(name).frontend}",
                          res["frontend"]["launches"]))
        for path, launches in paths:
            for kname, (t, _) in times[path].items():
                kernels.append(dict(
                    name=kname, path=path, route="cuda",
                    source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                    launches=launches[kname], max_abs_err=errs[kname], **t))
    kernels.append(dict(
        name="ssm_scan", path=GRANITE4H, route="cuda",
        source=SOURCES["ssm_scan"][0], replaces=SOURCES["ssm_scan"][1],
        launches=g4h["launches"]["ssm_scan"], max_abs_err=errs["ssm_scan"],
        **g4h_scan))
    for name, run in train_runs.items():
        for kname, (t, _) in train_times[name].items():
            kernels.append(dict(
                name=kname, path=f"{name}:train", route="cuda",
                source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                launches=run["launches"][kname],
                max_abs_err=train_errs[(name, kname)],
                **t))
    mr_paths = [(f"{MULTI_RANK}:train:mesh(1,1) over nccl", mr["one"],
                 mr["one"]["sharded"]["launches"])]
    mr_paths += [(f"{MULTI_RANK}:train+serve:mesh(1,2) over gloo, rank {r}",
                  res, {k: res["sharded"]["launches"][k]
                        + res["serve_launches"][k] for k in KERNELS})
                 for r, res in enumerate(mr["two"])]
    for path, res, launches in mr_paths:
        for kname, (t, err) in res["kernels"].items():
            kernels.append(dict(
                name=kname, path=path, route="cuda",
                source=SOURCES[kname][0], replaces=SOURCES[kname][1],
                launches=launches[kname], max_abs_err=err, **t))
    for r, res in enumerate(mr["two"]):
        for kname, (t, err) in res["seq_kernels"].items():
            kernels.append(dict(
                name=kname, path=f"{MULTI_RANK}:serve:seq-split "
                f"(kv_seq_axis=model, lse) mesh(1,2) over gloo, rank {r}",
                route="cuda", source=SOURCES[kname][0],
                replaces=SOURCES[kname][1],
                launches=res["seq_launches"][kname], max_abs_err=err, **t))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
