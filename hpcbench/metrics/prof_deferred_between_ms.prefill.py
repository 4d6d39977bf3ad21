"""The port's profiler: monitor-thread ms a dispatch spent on the
deferred PC-sample draw and attribution while the dispatching thread had
no dispatch open (``overhead_counters()``'s ``deferred_between_ns`` over
``dispatches``), over the measured window alone: the sampler's work that
competes with the closed loop's host code between batches.  None where
the profiler does not count it."""


def read(rec):
    c = rec.get("counters") or {}
    if rec.get("kind") != "prefill" or not c.get("dispatches") \
            or "deferred_between_ns" not in c:
        return None
    return c["deferred_between_ns"] / c["dispatches"] / 1e6
