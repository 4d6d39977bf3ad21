"""The port's spans and counters (``core.scope.span``, ``models.moe``'s
dispatch counts, the profiler's ``deferred_between_ns`` and clock anchor)
on the CPU: nothing opens or launches while torch.profiler is not
recording; under it the spans nest as documented; the export's op_name
chains and the profiler's files are the same with spans in place; the
counters equal a plain recount; the profiler's trace rows land on
torch.profiler's timeline."""
import collections
import dataclasses
import hashlib
import json
import os
import threading
import time

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import export, scope
from repro_torch.core.aggregate import aggregate
from repro_torch.core.profiler import Profiler
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

# one intra-op thread: the suite runs in several workers at once
torch.set_num_threads(1)

B, S = 2, 32
OPTS = T.ModelOptions(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)


def dense_cfg():
    return dataclasses.replace(get_config("yi-6b").reduced(), n_layers=2)


def moe_cfg():
    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               n_layers=2)


def params_of(cfg):
    return T.init_params(torch.Generator().manual_seed(0), cfg)


def batch_of(cfg):
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    return {"tokens": toks, "labels": toks.int()}


def prefill_and_decode(cfg, params):
    batch = batch_of(cfg)
    logits, cache = steps.make_prefill_step(cfg, OPTS)(
        params, {"tokens": batch["tokens"]})
    cache = {e: {k: torch.cat([v, torch.zeros_like(v[:, :, :1])], dim=2)
                 if k in ("k", "v") else v for k, v in c.items()}
             for e, c in cache.items()}
    steps.make_decode_step(cfg, OPTS)(params, cache, S,
                                      token=logits.argmax(-1))


def train_step(cfg, params):
    fn = steps.make_train_step(cfg, OPTS, adamw.OptConfig())
    fn(params, adamw.init(params), batch_of(cfg))


def user_ranges(run):
    """(name, tid, start, end) of every ``record_function`` range that
    ``run()`` opened under a CPU torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name.startswith((scope.SPAN_PREFIX,) + scope.TRAIN_SCOPES):
            out.append((e.name, e.thread, e.time_range.start,
                        e.time_range.end))
    return out


def parents(ranges):
    """{name: Counter of the innermost enclosing range's name}."""
    got = collections.defaultdict(collections.Counter)
    for name, tid, s, e in ranges:
        up = [(s2, n2) for n2, t2, s2, e2 in ranges
              if t2 == tid and s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        got[name][max(up)[1] if up else None] += 1
    return got


def test_untraced_steps_open_no_range_and_count_nothing(monkeypatch):
    """No profiler recording: a prefill batch, a decode step and a train
    step construct no ``record_function`` and the MoE path never reaches
    its counter."""
    made, counted = [], []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    monkeypatch.setattr(moe, "_count", lambda *a: counted.append(a))
    moe.reset_dispatch_counts()
    assert not scope.recording()
    cfg = moe_cfg()
    params = params_of(cfg)
    prefill_and_decode(cfg, params)
    train_step(cfg, params)
    assert made == [] and counted == []
    assert moe.dispatch_counts() == dict(calls=0, capacity=0, routed=0,
                                         dropped=0, max_load=0,
                                         routed_all=0)
    assert moe._COUNTS == {}


def test_no_ranges_turns_recording_off():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert scope.recording()
        with scope.no_ranges():
            assert not scope.recording()
        assert scope.recording()
    assert not scope.recording()


def test_serving_spans_nest_as_documented(tmp_path):
    """Prefill and decode: the step's span holds the embedding, each
    block's attention and FFN, and the head; a dispatch of the port's
    profiler holds the step."""
    cfg = dense_cfg()
    params = params_of(cfg)
    prof = Profiler(str(tmp_path), tracing=False)
    prof.start()

    def run():
        with prof.dispatch("kernel", "serve"):
            prefill_and_decode(cfg, params)
    got = parents(user_ranges(run))
    prof.flush()
    prof.stop()
    L = cfg.n_layers
    step = {scope.PREFILL: 1, scope.DECODE: 1}
    assert dict(got[scope.PREFILL]) == {scope.SPAN_PREFIX + "kernel:serve": 1}
    assert dict(got[scope.DECODE]) == {scope.SPAN_PREFIX + "kernel:serve": 1}
    assert dict(got[scope.EMBED]) == step
    assert dict(got[scope.HEAD]) == step
    assert dict(got[scope.ATTN]) == {k: L for k in step}
    assert dict(got[scope.FFN]) == {k: L for k in step}
    assert scope.MOE not in got and scope.LOSS not in got


def test_train_spans_nest_as_documented():
    """A train step: ``fwd_bwd`` holds the embedding, each block's
    attention and MoE (twice: the forward and the remat's recompute), the
    head and the loss; ``optimizer`` holds none."""
    cfg = moe_cfg()
    params = params_of(cfg)
    got = parents(user_ranges(lambda: train_step(cfg, params)))
    L = cfg.n_layers
    assert dict(got["fwd_bwd"]) == {None: 1}
    assert dict(got["optimizer"]) == {None: 1}
    assert dict(got[scope.EMBED]) == {"fwd_bwd": 1}
    assert dict(got[scope.ATTN]) == {"fwd_bwd": 2 * L}
    assert dict(got[scope.MOE]) == {"fwd_bwd": 2 * L}
    assert dict(got[scope.HEAD]) == {"fwd_bwd": 1}
    assert dict(got[scope.LOSS]) == {"fwd_bwd": 1}
    assert scope.FFN not in got


def test_span_names_share_the_prefix():
    assert all(n.startswith(scope.SPAN_PREFIX) for n in scope.SPANS)
    assert len(set(scope.SPANS)) == len(scope.SPANS)
    assert not set(scope.SPANS) & set(scope.TRAIN_SCOPES)


def _recorded(on: bool):
    """A CPU torch.profiler around the block when ``on``."""
    from contextlib import nullcontext
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU]) if on \
        else nullcontext()


@pytest.mark.parametrize("step", ["prefill", "train"])
def test_export_chains_are_the_same_with_spans_in_place(step):
    """The exported step's op_name chains do not change when the export
    runs while torch.profiler records: spans never enter the chains."""
    cfg = moe_cfg()
    params = params_of(cfg)

    def chains(on):
        with _recorded(on):
            if step == "prefill":
                module = export.module_from_export(
                    "prefill", export.export_step(
                        steps.make_prefill_step(cfg, OPTS),
                        (params, {"tokens": batch_of(cfg)["tokens"]})))
            else:
                fn = steps.make_train_step(cfg, OPTS, adamw.OptConfig())
                module = export.module_from_graph(
                    "train_step", export.trace_train_step(
                        fn, (params, adamw.init(params), batch_of(cfg))))
        return [(op.op_name, op.frame_id) for op in module.all_ops()]
    off, on = chains(False), chains(True)
    assert off == on
    assert not any(scope.SPAN_PREFIX in name for name, _ in on)


class StepClock:
    """A clock that advances a fixed step a call: the profiler's
    durations, sample budgets and trace rows are then the same from run
    to run."""

    def __init__(self, step=1_000_000):
        self.t = 0
        self.step = step
        self.lock = threading.Lock()

    def __call__(self):
        with self.lock:
            self.t += self.step
            return self.t


def _measure(tmp, on: bool):
    cfg = dense_cfg()
    params = params_of(cfg)
    fn = steps.make_prefill_step(cfg, OPTS)
    toks = batch_of(cfg)["tokens"]
    module = export.module_from_export("prefill", export.export_step(
        fn, (params, {"tokens": toks})))
    prof = Profiler(str(tmp), tracing=True, rng_seed=3, clock=StepClock())
    mid = prof.register_structure("prefill", module, export.cost(module))
    prof.start()
    with _recorded(on):
        for _ in range(3):
            with prof.dispatch("kernel", "prefill", module_id=mid):
                fn(params, {"tokens": toks})
    prof.flush()
    paths = prof.write()
    prof.stop()
    files = sorted(v for k, v in paths.items())
    profiles = [p for k, p in sorted(paths.items())
                if k.startswith(("cpu_", "gpu_")) and "trace" not in k]
    traces = [p for k, p in sorted(paths.items()) if "trace" in k]
    db = str(tmp) + "-db"
    aggregate(profiles, db, trace_paths=traces)
    out = {os.path.basename(p): _sha(p) for p in files}
    out.update({"db/" + n: _sha(os.path.join(db, n))
                for n in sorted(os.listdir(db)) if n != "meta.json"})
    return out


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_profiler_files_and_database_are_the_same_with_spans_in_place(
        tmp_path):
    """Three profiled prefill dispatches on a step clock, once while
    torch.profiler records (every span and the dispatch span open) and
    once not: the profiles, traces and aggregated database hold the same
    bytes."""
    # one call site: the host frames unwound at a dispatch hold its line
    off, on = [_measure(tmp_path / k, k == "on") for k in ("off", "on")]
    assert off == on
    assert any(k.startswith("db/") for k in on)


def recount(x, wr, n_experts, top_k, capacity):
    """routed, dropped and the largest load of one MoE call, plainly:
    each flattened (token-major) assignment's position among its
    expert's, dropped at or past the capacity."""
    probs = torch.softmax(x.float() @ wr, dim=-1)
    eidx = torch.topk(probs, top_k, dim=-1).indices.reshape(-1).tolist()
    seen = collections.Counter()
    dropped = 0
    for e in eidx:
        if seen[e] >= capacity:
            dropped += 1
        seen[e] += 1
    return len(eidx), dropped, max(seen.values())


def test_dispatch_counts_equal_a_plain_recount():
    """A tiny MoE whose router sends most tokens to two experts drops
    assignments; the counter agrees with the recount, call by call
    summed, and counts only while torch.profiler records."""
    E, k, d, f = 4, 2, 16, 8
    g = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(g, d, f, E, torch.float32)
    params["router"][:, 0] += 1.0      # forced imbalance: inputs of
    params["router"][:, 1] += 0.5      # positive mean prefer 0, then 1
    xs = [torch.randn(2, 24, d, generator=g) + 0.5 for _ in range(3)]
    moe.reset_dispatch_counts()
    for x in xs:
        moe.moe_ffn(params, x, n_experts=E, top_k=k, capacity_factor=1.25)
    assert moe.dispatch_counts()["calls"] == 0
    with _recorded(True):
        for x in xs:
            moe.moe_ffn(params, x, n_experts=E, top_k=k,
                        capacity_factor=1.25)
    cap = max(k, int(2 * 24 * k / E * 1.25))
    want = [recount(x.reshape(-1, d), params["router"], E, k, cap)
            for x in xs]
    got = moe.dispatch_counts()
    assert got == {"calls": 3, "capacity": cap,
                   "routed": sum(w[0] for w in want),
                   "dropped": sum(w[1] for w in want),
                   "max_load": max(w[2] for w in want),
                   "routed_all": sum(w[0] for w in want)}
    assert got["dropped"] > 0
    moe.reset_dispatch_counts()


class SlowHandler(Profiler):
    """The monitor's attribution slowed, so its work outlasts the
    dispatches it follows."""

    def _attribute(self, st, act, node):
        time.sleep(0.004)
        super()._attribute(st, act, node)


def test_deferred_between_is_part_of_deferred(tmp_path):
    """A closed loop of short dispatches with host work between them and
    a slow handler: the monitor works while no dispatch is open, and that
    part of ``deferred_ns`` is counted apart."""
    prof = SlowHandler(str(tmp_path), tracing=False)
    prof.start()
    for _ in range(20):
        with prof.dispatch("kernel", "k"):
            time.sleep(0.001)
        time.sleep(0.006)            # the loop's own host work
    prof.flush()
    c = prof.overhead_counters()
    prof.stop()
    assert c["dispatches"] == 20
    assert 0 < c["deferred_between_ns"] <= c["deferred_ns"]
    # the handler runs mostly between the 1 ms dispatches
    assert c["deferred_between_ns"] > c["deferred_ns"] / 2


def test_deferred_between_is_zero_inside_one_long_dispatch(tmp_path):
    """Records drained while the thread stays inside a dispatch count
    nowhere between: a dispatch held open over the others' drain."""
    prof = SlowHandler(str(tmp_path), tracing=False)
    prof.start()
    for _ in range(5):
        with prof.dispatch("kernel", "k"):
            pass
    with prof.dispatch("kernel", "hold"):
        time.sleep(0.05)              # the monitor drains the five here
        c_in = prof.overhead_counters()
    prof.flush()
    prof.stop()
    assert c_in["deferred_ns"] > 0
    assert c_in["deferred_between_ns"] <= c_in["deferred_ns"] // 2 + 1


def test_clock_anchor_puts_rows_on_the_torch_timeline(tmp_path):
    """A dispatch's trace row, mapped by ``trace_rows_us``, lies within
    1 ms of a ``record_function`` range around the same work in
    torch.profiler's chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    prof = Profiler(str(tmp_path / "m"), tracing=False)
    prof.start()
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with prof.dispatch("kernel", "work"):
            with torch.profiler.record_function("work"):
                time.sleep(0.02)
    prof.flush()
    path = str(tmp_path / "t.json")
    tp.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    ev = [e for e in trace["traceEvents"] if e.get("name") == "work"
          and e.get("cat") == "user_annotation"]
    assert len(ev) == 1
    rows = prof.trace_rows_us(trace["baseTimeNanoseconds"])
    prof.stop()
    assert rows.shape == (1, 2)
    t0, t1 = float(ev[0]["ts"]), float(ev[0]["ts"]) + float(ev[0]["dur"])
    assert abs(rows[0, 0] - t0) < 1000 and abs(rows[0, 1] - t1) < 1000
    assert prof.clock_anchor is not None
