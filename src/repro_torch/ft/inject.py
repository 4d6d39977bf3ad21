"""Deterministic fault injection: labeled crash points for the fleet
aggregation path (ISSUE 6).

Crash-tolerance claims are only as good as the schedule of crashes a
test can actually produce.  This module threads **labeled fault points**
through the daemon's stage/fold/commit path, the client's stage/send
path, and the merge commit itself (``repro.core.merge``), so a test can
kill either process at *every* point and assert the system invariant:
after any crash/restart/redelivery schedule, the final database is
byte-identical to a one-shot ``aggregate()`` over the union of
acknowledged shards (tests/test_fleet_crash.py sweeps the full matrix).

Usage::

    from repro_torch.ft import inject

    inject.fault_point("daemon.fold.pre_merge")   # in production code

    with inject.injected("daemon.fold.pre_merge"):   # in a test
        with pytest.raises(inject.InjectedCrash):
            daemon.poll_once()

Two trigger modes:

- ``raise`` (default): raises ``InjectedCrash`` — a ``BaseException``
  subclass, so ordinary ``except Exception`` recovery code cannot
  swallow it.  The code under test must not clean up on the way out for
  this to model a real kill; the fleet modules are written that way
  (all crash-sensitive state lives on disk, committed by rename).
- ``exit``: ``os._exit(EXIT_CODE)`` — a genuine no-cleanup process
  death for subprocess tests and the CI chaos job.

Activation is either programmatic (``arm`` / ``injected``) or via the
environment (``arm_from_env``): ``REPRO_FAULT_POINTS`` is a
comma-separated list of ``label`` or ``label:N`` (trigger on the Nth
hit), or ``all`` (every registered point armed — the process dies at
the first one it reaches); ``REPRO_FAULT_MODE`` is ``raise`` or
``exit``.  The CI chaos job runs the fleet soak test with
``REPRO_FAULT_POINTS=all``.

Disabled cost: one falsy dict check per ``fault_point`` call.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

ENV_POINTS = "REPRO_FAULT_POINTS"
ENV_MODE = "REPRO_FAULT_MODE"
EXIT_CODE = 86          # distinctive: "killed by an injected fault"

ALL = "all"


class InjectedCrash(BaseException):
    """An injected process death (``raise`` mode).

    Deliberately *not* an ``Exception``: recovery code that catches
    broad ``Exception`` (quarantine paths, retry loops) must not be able
    to absorb an injected crash — a real SIGKILL would not be caught
    either.
    """

    def __init__(self, label: str):
        super().__init__(f"injected crash at fault point {label!r}")
        self.label = label


# label -> remaining hits before triggering (1 = trigger on next hit)
_armed: Dict[str, int] = {}
_mode: str = "raise"
# every label any module ever declared (see register_points); "all" arms
# these.  Sorted views are what the crash-matrix tests sweep.
_registry: List[str] = []


def register_points(*labels: str) -> Tuple[str, ...]:
    """Declare fault-point labels (idempotent).  Modules call this at
    import time so tests and ``all`` can enumerate every point without
    executing the code paths first; returns the labels for re-export."""
    for lb in labels:
        if lb not in _registry:
            _registry.append(lb)
    return labels


def registered_points() -> List[str]:
    return sorted(_registry)


def fault_point(label: str) -> None:
    """A labeled crash point.  No-op unless armed for ``label``."""
    if not _armed:
        return
    left = _armed.get(label)
    if left is None:
        return
    if left > 1:
        _armed[label] = left - 1
        return
    del _armed[label]
    if _mode == "exit":
        sys.stderr.write(f"[inject] os._exit({EXIT_CODE}) at {label}\n")
        sys.stderr.flush()
        os._exit(EXIT_CODE)
    raise InjectedCrash(label)


def parse_spec(spec: str) -> Dict[str, int]:
    """``"a,b:3"`` -> ``{"a": 1, "b": 3}``; ``"all"`` -> every registered
    point at count 1."""
    plan: Dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if part == ALL:
            for lb in _registry:
                plan.setdefault(lb, 1)
            continue
        label, _, count = part.partition(":")
        n = int(count) if count else 1
        if n < 1:
            raise ValueError(f"fault spec {spec!r}: count must be >= 1")
        plan[label] = n
    return plan


def arm(spec: str, *, mode: str = "raise") -> None:
    """Arm fault points from a spec string (see ``parse_spec``)."""
    global _mode
    if mode not in ("raise", "exit"):
        raise ValueError(f"fault mode {mode!r}: expected raise|exit")
    _mode = mode
    _armed.clear()
    _armed.update(parse_spec(spec))


def clear() -> None:
    _armed.clear()


def armed() -> Dict[str, int]:
    return dict(_armed)


def arm_from_env(environ=os.environ) -> bool:
    """Arm from ``$REPRO_FAULT_POINTS`` / ``$REPRO_FAULT_MODE``; returns
    whether anything was armed.  Subprocess crash tests and the CI chaos
    job activate injection this way."""
    spec = environ.get(ENV_POINTS)
    if not spec:
        return False
    arm(spec, mode=environ.get(ENV_MODE, "raise"))
    return bool(_armed)


@contextlib.contextmanager
def injected(spec: str, *, mode: str = "raise"):
    """Arm for the duration of a ``with`` block, then disarm — the
    crash-matrix tests' idiom."""
    arm(spec, mode=mode)
    try:
        yield
    finally:
        clear()
