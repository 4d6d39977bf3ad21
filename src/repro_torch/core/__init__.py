"""The measurement front end that ``launch.serve`` drives: copies of
``repro.core``'s numpy-only profiler modules, changed only where the port
must differ (imports, the pruned tool path ``repro_torch/core``, and the
H100 device constants in ``sampling``)."""
