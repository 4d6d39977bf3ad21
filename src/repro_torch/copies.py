"""The JAX package's numpy-only modules that the port keeps as copies.

The port imports nothing of ``repro``, so the modules of the measurement
and analysis stack that need no change (the canonical database path,
the viewer, trace views, counters, derived metrics) are copied into
``repro_torch`` with their imports pointed at it, and nothing else
changed: the canonical database stays one contract that both packages
write.  Regenerate every copy after an edit of its original with

    PYTHONPATH=src python -m repro_torch.copies

``tests/test_torch_measure.py`` holds each copy to ``port_text`` of its
original.  The modules the port had to change (``core/cct.py``,
``core/sampling.py``, ``core/profiler.py``, ``core/kstruct.py``) are not
listed here.
"""
from __future__ import annotations

import os
import re
import sys

SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# paths relative to src/repro and to src/repro_torch (the same)
COPIES = (
    # the measurement front end that serve drives (since the first slice)
    "core/metrics.py", "core/channels.py", "core/trace.py",
    "core/profmt.py", "core/structure.py", "core/monitor.py",
    # the analysis back end: aggregate and viewer with their import closure
    "core/aggregate.py", "core/pipeline/__init__.py",
    "core/pipeline/acquire.py", "core/pipeline/cli.py",
    "core/pipeline/contracts.py", "core/pipeline/database.py",
    "core/pipeline/driver.py", "core/pipeline/expand.py",
    "core/pipeline/stats.py", "core/pipeline/traceconv.py",
    "core/pipeline/unify.py", "core/sparse.py", "core/merge.py",
    "core/retention.py", "core/viewer.py", "core/blame.py",
    "core/derived.py",
    "traceview/__init__.py", "traceview/tracedb.py",
    "traceview/pyramid.py", "traceview/raster.py", "traceview/filter.py",
    "traceview/render.py", "traceview/stats.py",
    "ft/__init__.py", "ft/inject.py", "ft/watchdog.py",
    # hardware counters (their H100 rates come through core.sampling)
    "counters/__init__.py", "counters/taxonomy.py", "counters/scheduler.py",
    "counters/collector.py",
    # the always-on serving profiler: per-request window labels (read by
    # traceview.stats), the overhead governor, stats, telemetry and the
    # facade serve drives
    "serving/__init__.py", "serving/window.py", "serving/governor.py",
    "serving/stats.py", "serving/telemetry.py", "serving/live.py",
    # the configurations the port serves (published widths, unchanged)
    "configs/qwen2_1_5b.py", "configs/granite_moe_1b_a400m.py",
    "configs/xlstm_125m.py",
    # the fleet daemon that takes the serving profiler's telemetry
    "fleet/__init__.py", "fleet/__main__.py", "fleet/cli.py",
    "fleet/client.py", "fleet/daemon.py", "fleet/envelope.py",
    "fleet/journal.py",
    # the training data pipeline (numpy only: the seeded synthetic token
    # stream and its prefetch thread)
    "data/pipeline.py",
)

_IMPORT_RE = re.compile(r"^(\s*(?:from|import)\s+)repro(?=[.\s])", re.M)


def port_text(text: str) -> str:
    """An original's text with every ``import repro...`` / ``from
    repro... import`` pointed at ``repro_torch``."""
    return _IMPORT_RE.sub(r"\1repro_torch", text)


def main(argv=None) -> int:
    for rel in COPIES:
        with open(os.path.join(SRC, "repro", rel)) as f:
            text = port_text(f.read())
        dst = os.path.join(SRC, "repro_torch", rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "w") as f:
            f.write(text)
    print(f"wrote {len(COPIES)} copies under {os.path.join(SRC, 'repro_torch')}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
