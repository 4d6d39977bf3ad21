"""Always-on serving profiler (ISSUE 7): per-request attribution,
overhead-budgeted adaptive sampling, live telemetry export.

- windows (``RequestWindow``): request/phase identity frames in the CCT
- governor (``OverheadGovernor``): fidelity throttled to a budget
- stats (``ServingStats``): rolling latency/throughput/overhead window
- telemetry (``TelemetryExporter``): snapshots as epoch-tagged fleet
  shards, exactly-once through the existing envelope/journal machinery
- live (``ServingProfiler``): the facade serving loops hold
- sweep: model-zoo scenario sweep (dense/MoE/SSM x prefill/decode-heavy)

See docs/serving.md.
"""
from repro_torch.serving.governor import (  # noqa: F401
    Decision, GovernorConfig, GovernorLevel, LEVELS, OverheadGovernor,
)
from repro_torch.serving.live import ServingProfiler  # noqa: F401
from repro_torch.serving.stats import ServingStats  # noqa: F401
from repro_torch.serving.telemetry import (  # noqa: F401
    SERVING_KIND, SERVING_METRICS, TelemetryExporter, read_telemetry,
    telemetry_registry,
)
from repro_torch.serving.window import (  # noqa: F401
    DECODE, PREFILL, RequestWindow, request_frames, window_label,
)
