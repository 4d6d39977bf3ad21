"""Time-centric trace analysis (paper §4.4, §7): merged ``trace.db``,
hpctraceviewer-style depth×time rendering, and interval statistics across
ranks and streams.

Typical post-mortem flow::

    db = aggregate(profiles, out, trace_paths=traces)   # writes trace.db
    tdb = TraceDB(os.path.join(out, "trace.db"))
    print(render_view(tdb.line_views(), db, width=120, height=16, depth=2))
"""
from repro_torch.traceview.filter import TraceFilter, apply_filter, subtree_mask
from repro_torch.traceview.pyramid import (TracePyramid, build_pyramid,
                                     ensure_pyramid, pyramid_path_for)
from repro_torch.traceview.raster import (IDLE, Raster, ancestors_at_depth,
                                    rasterize, sample_line, tree_depths)
from repro_torch.traceview.render import (depth_selector, render, render_view,
                                    statistic_panel)
from repro_torch.traceview.stats import (blame_over_time, interval_profile,
                                   merge_intervals, occupancy, summary,
                                   top_kernel_counters, top_kernels,
                                   windowed_blame)
from repro_torch.traceview.tracedb import TraceDB, build_db

__all__ = [
    "TraceDB", "build_db",
    "TracePyramid", "build_pyramid", "ensure_pyramid", "pyramid_path_for",
    "Raster", "rasterize", "sample_line", "ancestors_at_depth",
    "tree_depths", "IDLE",
    "render", "render_view", "depth_selector", "statistic_panel",
    "summary", "interval_profile", "occupancy", "top_kernels",
    "top_kernel_counters",
    "blame_over_time", "windowed_blame", "merge_intervals",
    "TraceFilter", "apply_filter", "subtree_mask",
]
