"""The traced run's arithmetic on synthetic traces: busy time, idle
gaps, records by kernel, the shares the readers give, and a segment
whose records fall short of the launch counter."""
import math

import pytest
import torch

from hpcbench import readers, trace
from hpcbench.reference import work


def _k(name, ts, dur, corr=None):
    e = {"cat": "kernel", "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    {"cat": "user_annotation", "name": "fwd_bwd", "ts": 0, "dur": 100},
    {"cat": "user_annotation", "name": "optimizer", "ts": 100, "dur": 60},
    {"cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 4},
    {"cat": "cpu_op", "name": "host_wait", "ts": 40, "dur": 40},
    {"cat": "cuda_runtime", "name": "launch", "ts": 10, "dur": 1,
     "args": {"correlation": 1}},
    {"cat": "cuda_runtime", "name": "launch", "ts": 20, "dur": 1,
     "args": {"correlation": 2}},
    {"cat": "cuda_runtime", "name": "launch", "ts": 110, "dur": 1,
     "args": {"correlation": 3}},
    _k("flash_fwd_kernel<128>", 12, 10, 1),
    _k("gemm", 18, 12, 2),                   # overlaps the first
    _k("adam", 90, 20, 3),
]


def test_busy_is_the_union():
    s = trace.summarize(EVENTS)
    assert s["busy_s"] == pytest.approx((30 - 12 + 20) / 1e6)
    assert s["kernels"]["gemm"] == [pytest.approx(12e-6), 1]
    assert trace.records_matching(s, "flash_fwd_kernel") == (
        pytest.approx(10e-6), 1)


def test_idle_gaps_by_host_activity():
    s = trace.summarize(EVENTS)
    # one gap, 30 -> 90 us, its middle (60) inside host_wait
    assert s["idle_gaps"] == [["host_wait", pytest.approx(60e-6)]]
    assert s["device_ops"][0][0] == "adam"


def _rec(kind="prefill", busy=0.6, window=1.0, units=2):
    seg = trace.summarize([_k("flash_fwd_kernel", 0, 1000)])
    seg.update(busy_s=busy, window_s=window, units=units)
    return {"kind": kind, "trace": seg,
            "window": {"units": 2 * units, "seconds": 2 * window},
            "work": {"unit_flops": 1e14,
                     "kernels": {"flash_fwd_kernel": (1e9, 1e6)}}}


def test_device_time_by_named_scope():
    """Each device record goes to the scope whose range holds the call
    that launched it, not the one it ran in (adam runs at 90-110 us,
    launched at 110 us inside ``optimizer``)."""
    s = trace.summarize(EVENTS, ("fwd_bwd", "optimizer"))
    assert s["scopes"] == {"fwd_bwd": pytest.approx(22e-6),
                           "optimizer": pytest.approx(20e-6), "none": 0.0}
    assert trace.summarize(EVENTS)["scopes"] == {}
    rec = {"kind": "train", "trace": dict(s, units=2)}
    assert readers.scope_ms(rec, "train", "fwd_bwd") == pytest.approx(11e-3)
    assert readers.scope_ms(rec, "train", "grad_compression") is None
    assert readers.scope_ms(rec, "prefill", "fwd_bwd") is None


def test_idle_share_is_the_windows():
    """A tracer that slows the host stretches the segment, not the
    device's busy time a unit: the share is the window's."""
    rec = _rec(busy=0.6, window=1.0)
    rec["trace"]["window_s"] = 3.0
    assert readers.idle_share(rec, "prefill") == pytest.approx(40.0)


def test_shares():
    rec = _rec()
    assert readers.mfu(rec, "prefill") == pytest.approx(
        100 * 4e14 / (2 * work.PEAK_FLOPS))
    assert readers.idle_share(rec, "prefill") == pytest.approx(40.0)
    bound = max(1e9 / work.PEAK_FLOPS, 1e6 / work.HBM_BW)
    assert readers.roofline(rec, "prefill", "flash_fwd_kernel") == \
        pytest.approx(100 * bound / 1e-3)
    # nothing to read: no value, never 0
    assert readers.mfu(rec, "train") is None
    assert readers.roofline(rec, "prefill", "ssd_kernel") is None
    rec["trace"] = None
    assert readers.idle_share(rec, "prefill") is None


def test_a_share_is_not_clamped():
    """Work counted too high reads above 100: it shows, it is not
    hidden."""
    rec = _rec(window=1e-3)
    assert readers.mfu(rec, "prefill") > 100


def test_short_trace_is_retaken(tmp_path):
    """A segment whose records fall short of the launch counter is
    rejected and the next one is traced; records that agree are kept;
    none kept after the attempts leaves no result."""
    launches = {"n": 0}

    def unit(i):
        torch.ones(4).add_(i)
        if i == 0:
            launches["n"] += 1        # a launch no record shows
    seg = trace.Segments(1, 3, [("flash_fwd_kernel", lambda: launches["n"])],
                         str(tmp_path), lambda: None)
    assert seg.take(unit, 0) == 2
    assert len(seg.rejected) == 1
    assert seg.rejected[0]["launches"] == {"flash_fwd_kernel": 1}
    assert seg.rejected[0]["records"] == {"flash_fwd_kernel": 0}
    assert seg.result is not None
    assert seg.result["units"] == 1 and seg.result["window_s"] > 0
    assert not list(tmp_path.iterdir())   # the chrome trace was removed

    def lossy(i):
        launches["n"] += 1
    seg = trace.Segments(2, 2, [("flash_fwd_kernel", lambda: launches["n"])],
                         str(tmp_path), lambda: None)
    assert seg.take(lossy, 5) == 9
    assert seg.result is None and len(seg.rejected) == 2


def test_p95():
    from hpcbench import harness
    xs = list(range(1, 101))
    assert harness.p95(xs) == pytest.approx(95.05)
    assert not math.isnan(harness.p95([3.0]))
