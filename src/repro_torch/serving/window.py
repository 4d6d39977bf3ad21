"""Per-request / per-phase measurement windows (ISSUE 7 tentpole).

The paper's always-on claim (§4, §8.1) only pays off in production if
the measurement can answer *which request burned the GPU*.  A
``RequestWindow`` stamps ``request:<id>`` and ``phase:<prefill|decode>``
frames into every dispatch issued while it is open — riding
``Profiler.window``, which splices the frames between the unwound host
stack and the dispatch placeholder.  The window identities are ordinary
host frames, so they survive the canonical-database contract unchanged:
aggregation, ``merge_databases``, retention, and the fleet fold all see
per-request contexts as plain tree paths (byte-deterministic; pinned in
tests/test_serving.py), and ``traceview.stats.request_attribution``
reads them back out of any database or trace window.

Frame scheme (docs/serving.md)::

    ... host stack ... -> request:<id> -> phase:<phase> -> <placeholder>

with ``module="<serving>"`` marking window frames unambiguously.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.cct import Frame, HOST

WINDOW_MODULE = "<serving>"
REQUEST_PREFIX = "request:"
PHASE_PREFIX = "phase:"

PREFILL = "prefill"
DECODE = "decode"


def request_frames(request_id: str, phase: Optional[str] = None
                   ) -> Tuple[Frame, ...]:
    """The window frames for one request (+ optional phase), in the
    order they nest in the CCT."""
    frames = [Frame(HOST, f"{REQUEST_PREFIX}{request_id}",
                    WINDOW_MODULE, 0)]
    if phase is not None:
        frames.append(Frame(HOST, f"{PHASE_PREFIX}{phase}",
                            WINDOW_MODULE, 0))
    return tuple(frames)


def window_label(frame) -> Tuple[Optional[str], Optional[str]]:
    """Decode one frame back into ``(request_id, phase)`` — exactly one
    side is non-None for a window frame, both None otherwise."""
    if getattr(frame, "module", None) != WINDOW_MODULE:
        return None, None
    name = frame.name
    if name.startswith(REQUEST_PREFIX):
        return name[len(REQUEST_PREFIX):], None
    if name.startswith(PHASE_PREFIX):
        return None, name[len(PHASE_PREFIX):]
    return None, None


class RequestWindow:
    """Context manager: every dispatch (and cpu_region) issued inside is
    attributed to ``request_id``/``phase``, and the wall-clock span of
    the window is captured for latency percentiles::

        with RequestWindow(prof, "r42", phase="decode") as w:
            with prof.dispatch("kernel", "decode_step", ...):
                ...
        latency_ns = w.duration_ns

    **Continuous batching** (overlapping windows): the ``with`` form
    splices the window frames for its whole dynamic extent, which
    assumes the thread works for exactly one request at a time.  A
    continuous-batching server interleaves decode steps of many live
    requests on one scheduler thread, so whole-extent splicing would
    attribute every interleaved dispatch to whichever window opened
    last (and double-count once both close).  For that shape, keep the
    window open across the request's lifetime with ``open()``/
    ``close()`` (span timing only — no frame splicing) and stamp each
    dispatch explicitly::

        w1, w2 = (RequestWindow(prof, r, phase="decode").open()
                  for r in ("r1", "r2"))
        with w1.step():                      # this dispatch is r1's
            with prof.dispatch(...): ...
        with w2.step():                      # interleaved: r2's
            with prof.dispatch(...): ...
        w1.close(); w2.close()

    ``step()`` uses ``Profiler.window_exclusive``: it *replaces* the
    thread's window stack for the body, so each dispatch carries exactly
    one request identity no matter how many windows are live —
    ``request_attribution`` sums to the partition total with no double
    counting (pinned in tests/test_serving.py).
    """

    def __init__(self, profiler, request_id, phase: Optional[str] = None):
        self.profiler = profiler
        self.request_id = str(request_id)
        self.phase = phase
        self.t0_ns: Optional[int] = None
        self.t1_ns: Optional[int] = None
        self._cm = None

    @property
    def duration_ns(self) -> int:
        if self.t0_ns is None or self.t1_ns is None:
            return 0
        return self.t1_ns - self.t0_ns

    def __enter__(self) -> "RequestWindow":
        self._cm = self.profiler.window(
            *request_frames(self.request_id, self.phase))
        self._cm.__enter__()
        self.t0_ns = self.profiler.clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1_ns = self.profiler.clock()
        self._cm.__exit__(*exc)
        self._cm = None

    # -- continuous-batching API (overlapping windows) --------------------
    def open(self) -> "RequestWindow":
        """Start the request's wall-clock span without splicing frames —
        safe to hold open concurrently with other requests' windows."""
        self.t0_ns = self.profiler.clock()
        return self

    def close(self) -> "RequestWindow":
        """End the wall-clock span (latency = ``duration_ns``)."""
        self.t1_ns = self.profiler.clock()
        return self

    def step(self, phase: Optional[str] = None):
        """Per-dispatch stamping: a context manager that attributes
        exactly the dispatches in its body to this request (replacing,
        not nesting under, any other live window's frames).  ``phase``
        overrides the window's phase for this step (e.g. a request whose
        prefill and decode interleave with other requests)."""
        return self.profiler.window_exclusive(
            *request_frames(self.request_id,
                            phase if phase is not None else self.phase))
