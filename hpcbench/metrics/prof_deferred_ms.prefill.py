"""The port's profiler: monitor-thread ms a dispatch spent on the
deferred PC-sample draw and attribution (``overhead_counters()``'s
``deferred_ns`` over ``dispatches``), over the measured window alone:
read after a flush at its end, before any traced segment."""


def read(rec):
    c = rec.get("counters") or {}
    if rec.get("kind") != "prefill" or not c.get("dispatches"):
        return None
    return c["deferred_ns"] / c["dispatches"] / 1e6
