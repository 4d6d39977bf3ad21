"""The port's serve under its profiler, through its own analysis back end
(the copies of ``aggregate``, ``viewer``, ``counters`` and ``derived``),
against the JAX package's back end on the same profiles: PC samples under
both step placeholders and inside every kernel's interior, byte-identical
databases, identical views.  Reduced models on the CPU."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.core import viewer as jviewer
from repro.core.pipeline.database import Database as JDatabase
from repro_torch.configs import get_config
from repro_torch.core import derived, export, sampling, viewer
from repro_torch.core.aggregate import aggregate
from repro_torch.core.profiler import Profiler
from repro_torch.launch.serve import serve

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("qwen2-1.5b", "hymba-1.5b")
COUNTERS = ("flops", "mxu_flops", "hbm_bytes", "inst_executed",
            "active_ns", "elapsed_ns")


def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    return cs


def jax_aggregate():
    """``repro.core.aggregate.aggregate`` (the package re-exports the
    function under the module's name)."""
    import importlib
    return importlib.import_module("repro.core.aggregate").aggregate


def profile_files(paths):
    profiles = sorted(v for k, v in paths.items()
                      if k.startswith(("cpu_", "gpu_")) and "trace" not in k)
    traces = sorted(v for k, v in paths.items() if "trace" in k)
    return profiles, traces


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{model: (serve's paths, the port's database)}: 2 requests of 2
    generated tokens after a 32-token prompt."""
    out = {}
    for name in MODELS:
        d = tmp_path_factory.mktemp(name)
        _, paths = serve(get_config(name).reduced(), n_requests=2, batch=2,
                         prompt_len=32, gen_len=3, seed=0,
                         profile_dir=str(d / "measure"), device="cpu")
        profiles, traces = profile_files(paths)
        db = aggregate(profiles, str(d / "db"), trace_paths=traces)
        out[name] = paths, db
    return out


@pytest.mark.parametrize("name", MODELS)
def test_serve_samples_reach_every_kernel_interior(served, name):
    paths, db = served[name]
    got = chip_smoke().interior_samples(db)
    assert set(got) == {"prefill", "decode_step"}
    want = {"prefill": {"flash_attention"} | (
                {"ssm_scan"} if name.startswith("hymba") else set()),
            "decode_step": {"decode_attention"}}
    for step, kernels in want.items():
        assert got[step]["samples"] > 0
        assert set(got[step]["kernels"]) == kernels
        for kname in kernels:
            k = got[step]["kernels"][kname]
            assert k["samples"] > 0 and k["dot_general"] > 0
            assert k["dot_lines"] and all(f == f"{kname}.cu"
                                          for f, _ in k["dot_lines"])
    with open(paths["measurement"]) as f:
        measurement = json.load(f)
    info = measurement["steps"]
    assert set(info) == {"prefill", "decode_step"}
    assert measurement["profiler"]["samples_kept"] > 0
    cfg = get_config(name).reduced()
    assert info["decode_step"]["custom_calls"] == cfg.n_layers
    assert all(v["ops"] > 0 and v["flops"] > 0 for v in info.values())


def _files(d):
    return sorted(f for f in os.listdir(d)
                  if os.path.isfile(os.path.join(d, f)))


@pytest.mark.parametrize("name", MODELS)
def test_port_and_reference_aggregate_byte_identically(served, name,
                                                       tmp_path):
    """Every database file byte for byte; meta.json but for its
    ``timing`` (seconds of each phase of this run)."""
    paths, db = served[name]
    profiles, traces = profile_files(paths)
    jax_aggregate()(profiles, str(tmp_path / "ref"), trace_paths=traces)
    ours, ref = db.out_dir, str(tmp_path / "ref")
    assert _files(ours) == _files(ref) and "meta.json" in _files(ours)
    for f in _files(ours):
        with open(os.path.join(ours, f), "rb") as a, \
                open(os.path.join(ref, f), "rb") as b:
            got, want = a.read(), b.read()
        if f == "meta.json":      # identical but for the phase timings
            got, want = json.loads(got), json.loads(want)
            assert got.pop("timing") and want.pop("timing")
        assert got == want, f


@pytest.mark.parametrize("name", MODELS)
def test_port_viewer_renders_as_the_reference(served, name):
    _, db = served[name]
    jdb = JDatabase.load(db.out_dir)
    for metric in ("gpu_inst/samples", "gpu_kernel/time_ns"):
        assert viewer.top_down(db, metric, max_depth=8) == \
            jviewer.top_down(jdb, metric, max_depth=8)
        assert viewer.flat(db, metric) == jviewer.flat(jdb, metric)
    hot = viewer.top_hot_loops(db)
    assert hot == jviewer.top_hot_loops(jdb)
    assert "grid:kv_blocks" in hot


def test_counters_on_serve(tmp_path):
    """Counters enabled through serve land as non-zero gpu_counter
    columns on both steps; flop efficiency is against the H100 peak."""
    _, paths = serve(get_config("qwen2-1.5b").reduced(), n_requests=2,
                     batch=2, prompt_len=16, gen_len=2,
                     profile_dir=str(tmp_path / "m"), device="cpu",
                     counters=COUNTERS)
    profiles, traces = profile_files(paths)
    db = aggregate(profiles, str(tmp_path / "db"), trace_paths=traces)
    cols = derived.database_columns(db, "sum")
    steps = [g for g, f in enumerate(db.frames) if f.kind == "placeholder"
             and f.name in ("kernel:prefill", "kernel:decode_step")]
    assert len(steps) >= 2
    for name in COUNTERS:
        assert all(cols[f"gpu_counter/{name}"][g] > 0 for g in steps), name
    table = viewer.counter_table(db)
    assert "kernel:prefill" in table and "kernel:decode_step" in table
    assert f"{sampling.PEAK_FLOPS * 1e-9}" in \
        derived.FLOP_EFFICIENCY.formula


def test_register_structure_and_build_trace_db(tmp_path):
    x = torch.randn(4, 8)
    w = torch.randn(8, 8)
    mod = export.module_from_export(
        "step", export.export_step(lambda a, b: (a @ b).exp(), (x, w)))
    assert {"dot", "exponential"} <= {op.opcode for op in mod.all_ops()}
    prof = Profiler(str(tmp_path), tracing=True, rng_seed=0, unwind=False)
    mid = prof.register_structure("step", mod, export.cost(mod))
    assert prof.module(mid) is mod
    with prof:
        for _ in range(3):
            with prof.dispatch("kernel", "step", stream=0, module_id=mid,
                               duration_ns=100_000):
                pass
        prof.flush()
        prof.write()
    path = prof.build_trace_db()
    assert os.path.getsize(path) > 0
    assert np.isclose(export.cost(mod)["flops"], 2 * 4 * 8 * 8)
