"""The always-on serving profiler is not ported yet: ``serve(serving=...)``
raises.  ``window`` is here, a copy, because the trace views
(``traceview.stats``) label per-request windows with it."""
