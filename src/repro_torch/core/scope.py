"""Named scopes of a step, the port's counterpart of ``jax.named_scope``.

The JAX package puts the phases of its train step under named scopes
(``fwd_bwd``, ``fwd_bwd_micro``, ``grad_compression``, ``optimizer``), and
every op traced inside one carries the name in its ``op_name``, so a PC
sample or a device kernel of the step is attributed to its phase.
``named_scope`` does the same for both views the port has of a step:

- while the step is traced (``core.export``), the names of the scopes
  open when a graph node is created become the outermost elements of that
  node's scope chain (its ``op_name``);
- while the step runs under torch.profiler, the scope is a
  ``torch.profiler.record_function`` range of the same name.

``span`` opens such a range and nothing else: it never enters the export's
chains, so the exported structure and the port profiler's databases are
the same with spans in place.  Spans mark where the work of a step
happens (``SPANS``; a dispatch of the port's profiler is
``SPAN_PREFIX + "<kind>:<name>"``, named as its placeholder), so a device
idle gap in a torch.profiler trace is labelled by the innermost span the
host was in.  Both open a range only while ``recording()``: torch.profiler
is recording and no ``no_ranges`` is open.  Untraced, a scope or span
costs one flag read and launches nothing.

The stack of open names is one for the process, not one per thread: on
CUDA tensors the autograd engine runs a backward in a thread of its own,
and those ops belong to the scope that called ``torch.autograd.grad``, as
the reference's transpose belongs to the scope around
``jax.value_and_grad``.  One step runs (or is traced) at a time.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

# the train step's scopes, the JAX package's names
TRAIN_SCOPES = ("fwd_bwd", "fwd_bwd_micro", "grad_compression", "optimizer")

# every span's name starts with this; the port's custom ops
# (``repro_torch::...``) and aten's never do
SPAN_PREFIX = "rt."
# launch/steps.py: a prefill step, a decode step
PREFILL = SPAN_PREFIX + "prefill"
DECODE = SPAN_PREFIX + "decode"
# models/transformer.py: the embedding lookup; a block's attention (after
# its input norm) with its residual add; its dense FFN or MoE FFN with
# their norm and residual add; the final norm (and, serving, the
# unembedding); in training the chunked unembedding and cross-entropy;
# a Mamba-2 mixer (after its input norm) with its residual add; a shared
# expert beside a MoE (inside ``MOE``)
EMBED = SPAN_PREFIX + "embed"
ATTN = SPAN_PREFIX + "attn"
FFN = SPAN_PREFIX + "ffn"
MOE = SPAN_PREFIX + "moe"
HEAD = SPAN_PREFIX + "head"
LOSS = SPAN_PREFIX + "loss"
MAMBA = SPAN_PREFIX + "mamba"
SHARED = SPAN_PREFIX + "shared"
SPANS = (PREFILL, DECODE, EMBED, ATTN, FFN, MOE, HEAD, LOSS, MAMBA, SHARED)

_OPEN: List[str] = []
_RANGES = [True]


def recording() -> bool:
    """True while torch.profiler records and no ``no_ranges`` is open:
    the one check behind every range and counter of the port."""
    return _RANGES[-1] and torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def named_scope(name: str):
    """Everything inside runs, and is traced, under scope ``name``."""
    _OPEN.append(name)
    try:
        if recording():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        _OPEN.pop()


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range named ``name`` while ``recording()``;
    never part of the export's chains."""
    if recording():
        with torch.profiler.record_function(name):
            yield
    else:
        yield


def active() -> Tuple[str, ...]:
    """The names of the open scopes, outermost first."""
    return tuple(_OPEN)


@contextlib.contextmanager
def no_ranges():
    """While open, scopes and spans open no ``record_function`` range and
    the MoE counts nothing: a tracer would record the range's enter and
    exit, and the counters' adds, as nodes of the graph."""
    _RANGES.append(False)
    try:
        yield
    finally:
        _RANGES.pop()


def shares(db) -> Dict[str, float]:
    """Where a user reads the scopes: ``{scope: its share of the PC
    samples under the train step's dispatch placeholders}`` in a database
    of the port's ``core.aggregate``.  In the top-down view a
    ``kernel:train_step`` placeholder holds the step's own function frame
    (the first element of every ``op_name``), and that frame holds the
    scopes as its first level; a scope the step never opened has share
    0."""
    col = db.stats["sum"][:, db.metric_id("gpu_inst/samples")]
    parents = db.parents
    held = {g for g, fr in enumerate(db.frames)
            if fr.kind == "placeholder" and fr.name == "kernel:train_step"}
    total = float(sum(col[g] for g in held))
    out = dict.fromkeys(TRAIN_SCOPES, 0.0)
    for g, fr in enumerate(db.frames):
        up = int(parents[g])
        if fr.name in out and up >= 0 and db.frames[up].name == "train_step" \
                and int(parents[up]) in held:
            out[fr.name] += float(col[g])
    return {k: v / total if total else 0.0 for k, v in out.items()}
