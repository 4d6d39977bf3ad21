"""The port's always-on serving path against the JAX package's:
``serve(serving=...)`` writes the same per-request/per-phase windows and
attribution rows (structure, not bytes: timings differ), the governor's
control law holds on the port's copy (driven through a scripted stub
profiler, no wall-clock spins), and the port's six-scenario sweep runs
end to end on the CPU."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.aggregate import aggregate as jax_aggregate
from repro.launch.serve import serve as jax_serve
from repro.models import transformer as JT
from repro.serving.live import ServingProfiler as JaxServingProfiler
from repro.traceview import stats as jstats
from repro.traceview.tracedb import TraceDB as JaxTraceDB
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregate import aggregate
from repro_torch.launch import serve as serve_mod
from repro_torch.serving import sweep
from repro_torch.serving.governor import (GovernorConfig, LEVELS,
                                          OverheadGovernor)
from repro_torch.serving.live import ServingProfiler
from repro_torch.serving.window import DECODE, PREFILL, WINDOW_MODULE
from repro_torch.traceview import stats
from repro_torch.traceview.tracedb import TraceDB

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

MODELS = ("qwen2-1.5b", "hymba-1.5b", "granite-moe-1b-a400m", "xlstm-125m")
FLOOR = len(LEVELS) - 1
N_REQUESTS, BATCH, PROMPT, GEN = 3, 2, 16, 3


def run_and_read(sp_cls, agg, tracedb, stats_mod, serve_fn, cfg, out_dir,
                 **kw):
    """Serve under a started serving profiler, aggregate its profiles and
    read back what an operator reads: window frames, (request, phase)
    labels, attribution rows, GPU trace events per (request, phase), the
    latency phases and the live request/token counts."""
    sp = sp_cls(str(out_dir), governor=GovernorConfig(budget=0.5,
                                                      interval=4))
    sp.start()
    toks, paths = serve_fn(cfg, n_requests=N_REQUESTS, batch=BATCH,
                           prompt_len=PROMPT, gen_len=GEN, serving=sp, **kw)
    assert paths is None
    sp.profiler.flush()
    paths = sp.write()
    status = sp.status()
    sp.stop()
    profs = [v for k, v in sorted(paths.items()) if "trace" not in k]
    traces = [v for k, v in sorted(paths.items()) if "trace" in k]
    db = agg(profs, str(out_dir / "db"), n_ranks=1, n_threads=1,
             trace_paths=traces)
    lines = tracedb(db.trace_db_path()).line_views()
    req, ph = stats_mod.window_labels(db)
    events = {}
    for td in lines:
        if td.identity.get("type") != "gpu":
            continue
        for c in np.asarray(td.ctx, np.int64):
            key = (req[c], ph[c])
            events[key] = events.get(key, 0) + 1
    return dict(
        tokens=np.asarray(toks),
        windows=sorted(f.name for f in db.frames
                       if f.module == WINDOW_MODULE),
        labels=sorted({(r, p or "") for r, p in zip(req, ph) if r}),
        attribution={r: sorted(by) for r, total, by in
                     stats_mod.request_attribution(lines, db)
                     if total > 0 and all(v > 0 for v in by.values())},
        gpu_events=events,
        phases=sorted(stats_mod.request_latency_percentiles(lines, db)),
        counts=(status["requests"], status["tokens"]))


@pytest.mark.parametrize("name", MODELS)
def test_serve_windows_match_reference(name, tmp_path):
    """Same prompts and (JAX-initialised) weights: the same window frames,
    (request, phase) labels, attribution rows with GPU time in both
    phases, GPU events per window, latency phases and live counts as the
    reference's ``serve(serving=...)``, and identical f32 tokens."""
    jcfg = jax_get_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want = run_and_read(JaxServingProfiler, jax_aggregate, JaxTraceDB,
                        jstats, jax_serve, jcfg, tmp_path / "jax")
    got = run_and_read(ServingProfiler, aggregate, TraceDB, stats,
                       serve_mod.serve, cfg, tmp_path / "torch",
                       device="cpu", params=tp)
    for key in ("windows", "labels", "attribution", "gpu_events", "phases",
                "counts"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    rids = {"r0-r1", "r2"}
    assert set(got["attribution"]) == rids
    assert all(p == [DECODE, PREFILL] for p in got["attribution"].values())
    assert got["gpu_events"][("r2", DECODE)] == GEN - 1
    assert got["gpu_events"][("r0-r1", PREFILL)] == 1


def test_serve_writes_measurement_beside_serving_profiles(tmp_path):
    """With serving=, the steps' structure (ops, custom-calls bound,
    export seconds) lands in measurement.json in the profiler's
    directory; serving= and profile_dir= together are refused.  Each of
    reduced granite's two layers has two custom-calls a step: flash
    (prefill) or decode attention, and the MoE combine, bound at that
    step's own shapes."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    with pytest.raises(ValueError, match="serving= or profile_dir="):
        serve_mod.serve(cfg, device="cpu", serving=object(),
                        profile_dir=str(tmp_path / "p"))
    sp = ServingProfiler(str(tmp_path / "sp"), governor=False)
    with sp:
        serve_mod.serve(cfg, n_requests=2, batch=2, prompt_len=8,
                        gen_len=2, device="cpu", serving=sp,
                        rid_prefix="a-")
    with open(os.path.join(sp.profiler.out_dir, "measurement.json")) as f:
        steps = json.load(f)["steps"]
    assert set(steps) == {"prefill", "decode_step"}
    for info in steps.values():
        assert info["ops"] > 0 and info["custom_calls"] == 4
        assert info["seconds"] > 0
    combines = {}
    for mid, module in sp.profiler._modules.items():
        bound = [ks for ks in module.kernel_structures().values()
                 if ks.name == "moe_combine"]
        assert len(bound) == 2
        combines[sp.profiler._module_names[mid]] = bound[0]
    assert combines["prefill"].total_bytes > \
        combines["decode_step"].total_bytes > 0


class StubProfiler:
    """The three knobs the governor turns and scripted overhead counters
    (no dispatch, no clock)."""

    def __init__(self):
        self.sample_scale = self.sample_cap = self.unwind_depth = None
        self.c = {"dispatches": 0, "tool_ns": 0, "app_ns": 0}

    def overhead_counters(self):
        return dict(self.c)

    def window(self, n, frac):
        """Advance n dispatches at the given tool/app overhead."""
        self.c["dispatches"] += n
        self.c["app_ns"] += n * 1_000_000
        self.c["tool_ns"] += int(n * 1_000_000 * frac)


def make_gov(**cfg):
    prof = StubProfiler()
    gov = OverheadGovernor(prof, GovernorConfig(
        budget=0.10, headroom=0.5, interval=4, patience=2, **cfg))
    return prof, gov


def knobs(prof):
    return prof.sample_scale, prof.sample_cap, prof.unwind_depth


def test_governor_walks_down_to_floor_and_back():
    """Over budget steps down one level a window (knobs applied at once),
    clamps at the floor, which still measures; low windows step back up
    only after ``patience`` of them."""
    prof, gov = make_gov()
    lv = LEVELS[0]
    assert knobs(prof) == (lv.sample_scale, lv.sample_cap, lv.unwind_depth)
    prof.window(3, 0.5)                  # fewer than interval: no decision
    assert gov.observe() is None and gov.level == 0
    prof.window(1, 0.5)
    assert gov.observe().level == 1
    for _ in range(FLOOR + 2):
        prof.window(4, 0.9)
        gov.observe()
    assert gov.level == FLOOR and gov.throttle_downs == FLOOR
    lv = LEVELS[FLOOR]
    assert knobs(prof) == (lv.sample_scale, lv.sample_cap, lv.unwind_depth)
    assert lv.sample_scale == 0.0 and lv.sample_cap == 1
    prof.window(4, 0.01)
    gov.observe()
    assert gov.level == FLOOR            # one low window: patience holds
    prof.window(4, 0.01)
    gov.observe()
    assert gov.level == FLOOR - 1 and gov.throttle_ups == 1


def test_governor_slo_shed_and_backpressure():
    """Under budget but a p99 past the rolling baseline sheds a level;
    fleet backpressure sheds one and blocks step-up until released."""
    prof, gov = make_gov()
    for _ in range(2):
        prof.window(4, 0.01)
        gov.observe(p99_ms=10.0)         # the baseline learns 10 ms
    prof.window(4, 0.01)
    gov.observe(p99_ms=40.0)             # 4x the baseline: shed
    assert gov.level == 1 and gov.slo_sheds == 1
    _, gov = make_gov()
    gov.note_backpressure(True)
    assert gov.level == 1 and gov.throttle_downs == 1
    for _ in range(3):
        gov.profiler.window(4, 0.01)
        gov.observe()
    assert gov.level == 1
    gov.note_backpressure(False)
    for _ in range(2):
        gov.profiler.window(4, 0.01)
        gov.observe()
    assert gov.level == 0


def test_scenario_config_on_cuda_takes_the_kernels_shapes():
    """On a CUDA device the reduced configs run in bf16 at head_dim 64
    (the Hopper kernels' dtype and a head dim they take); on the CPU they
    are ``reduced()`` as it is."""
    for scn in sweep.SCENARIOS:
        cpu = sweep.scenario_config(scn.arch, "cpu")
        cuda = sweep.scenario_config(scn.arch, "cuda")
        assert cpu == get_config(scn.arch).reduced()
        assert cuda == dataclasses.replace(cpu, dtype="bfloat16",
                                           head_dim=64)
    assert {s.family for s in sweep.SCENARIOS} == {"dense", "moe", "ssm"}
    assert {s.mix for s in sweep.SCENARIOS} == {"prefill-heavy",
                                                "decode-heavy"}


def test_run_sweep_small_on_cpu(tmp_path):
    """All six scenarios end to end: each row has attribution for every
    request batch in both phases and trace latency percentiles for both,
    and the report line renders."""
    rows = sweep.run_sweep(str(tmp_path), small=True, device="cpu")
    assert [r["scenario"] for r in rows] == [s.name for s in
                                             sweep.SCENARIOS]
    for row in rows:
        assert {a["request"] for a in row["attribution"]} == \
            {"r0-r1", "r2-r3"}, row["scenario"]
        for a in row["attribution"]:
            assert a["total_ns"] > 0
            assert set(a["by_phase"]) == {PREFILL, DECODE}
        assert set(row["trace_latency_ms"]) == {PREFILL, DECODE}
        assert row["status"]["requests"] == 2.0      # distinct request ids
        assert row["governor"]["budget"] == 0.5
        assert row["scenario"] in sweep.report_line(row)
