"""The harness finds cells, mixes and metrics by name from files added
alone, and runs tiny cells end to end on the CPU (the port's kernels run
their plain versions there); with the timed path broken underneath,
``correct`` comes out false."""
import json
import os

import pytest

import tiny
from hpcbench import harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def test_a_cell_mix_and_metric_added_as_files_alone(tmp_path):
    """A new traffic mix, cell and per-layer metric are found by name
    from new files and new entries, with no edit to a file there."""
    root = tiny.make_root(str(tmp_path))
    hb = os.path.join(root, "hpcbench")
    with open(os.path.join(hb, "traffic", "tiny-prefill.json")) as f:
        mix = json.load(f)
    mix.update(batch=1, prompt_len=32, profiler="none")
    with open(os.path.join(hb, "traffic", "tiny-bare.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(hb, "limits", "tiny.bare.json"), "w") as f:
        json.dump({"numbers": {"kv_err": {"limit": 1e9}}}, f)
    with open(os.path.join(hb, "metrics", "batches.bare.py"), "w") as f:
        f.write("def read(rec):\n    return rec['trace']['units']\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.bare", "config": "tiny-dense",
                               "traffic": "tiny-bare", "chips": 1,
                               "why": "t"})
    bench["end_to_end"][0]["workloads"].append("tiny.bare")
    bench["per_layer"].append({"name": "batches.bare", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "prefill_tok_s",
                               "workloads": ["tiny.bare"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = harness.find_cell(root, "tiny.bare")
    assert cell.traffic["profiler"] == "none"
    assert [m["name"] for m in cell.per_layer] == ["batches.bare"]
    assert "prefill_tok_s" in [m["name"] for m in cell.end_to_end]
    got = harness.read_metrics(cell, {"trace": {"units": 3}})
    assert got == {"batches.bare": {"value": 3.0, "unit": "count"}}
    out = tiny.run(root, "tiny.bare", seconds=0.2)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"prefill_tok_s", "setup_s"}


def test_unknown_cell(root):
    with pytest.raises(KeyError):
        harness.find_cell(root, "no.such.cell")


@pytest.mark.parametrize("name", ["tiny.prefill", "tiny.train"])
def test_tiny_cell_runs_and_is_correct(root, name):
    out = tiny.run(root, name)
    assert out["correct"], out["shown"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    line = json.loads(harness.result_line(
        out["correct"], out["attempted"], out["failed"], out["metrics"],
        out["device"], out["shown"]))
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("name", ["tiny.prefill", "tiny.train"])
def test_tiny_traced_run_reads_its_metrics(root, name):
    """On the CPU the segment holds no device record and no launch, so
    it is accepted; every reader answers or stays silent."""
    cell = harness.find_cell(root, name)
    out = tiny.run(root, name, trace=True)
    assert out["correct"]
    got = set(out["metrics"])
    assert got <= {m["name"] for m in cell.per_layer}
    assert any(n.startswith("mfu.") for n in got)
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    roof = [n for n in got if "roofline" in n]
    assert not roof             # no kernel record on the CPU: silent


# --- faults planted under the timed path --------------------------------
def _prefill_fault(kind):
    from repro_torch.launch import steps
    make = steps.make_prefill_step

    def broken(cfg, opts, **kw):
        fn = make(cfg, opts, **kw)

        def step(params, batch):
            logits, cache = fn(params, batch)
            if kind == "token":        # one answer altered where made
                logits = logits.clone()
                logits[0, 0] += 8.0
            elif kind == "half_batch":  # half the rows never computed
                half = logits.shape[0] // 2
                logits = logits.clone()
                logits[half:] = 0
                cache = {e: {k: v.clone() for k, v in c.items()}
                         for e, c in cache.items()}
                for c in cache.values():
                    for v in c.values():
                        v[:, half:] = 0
            return logits, cache
        return step
    return broken


def _train_fault(kind):
    from repro_torch.launch import steps
    make = steps.make_train_step

    def broken(cfg, opts, opt_cfg, **kw):
        fn = make(cfg, opts, opt_cfg, **kw)

        def step(params, opt_state, batch):
            if kind == "unchanged":     # the state comes back as it was
                before = {id(t): t.clone() for t in _leaves(params)}
                out = fn(params, opt_state, batch)
                for t in _leaves(params):
                    t.copy_(before[id(t)])
                return out
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return fn(params, opt_state, half)
        return step
    return broken


def _leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


# limits at these widths: the prefill cell's own; for training about 3x
# the largest a sound tiny run read over seeds 1-8 (loss 0.0013, gradient
# 0.0233, change 0.0135: tiny leaves have noisier norms than the cell's)
with open(os.path.join(tiny.BENCH, "limits",
                       "yi6b.prefill4k.prof.json")) as _f:
    TINY_LIMITS = {k: v["limit"] for k, v in json.load(_f)["numbers"].items()}
TINY_LIMITS.update(loss_gap=0.004, grad_gap=0.07, change_gap=0.04)


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("held")),
                          limits=TINY_LIMITS)


@pytest.mark.parametrize("name", ["tiny.prefill", "tiny.train"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sound_tiny_runs_pass_the_limits(held, name, seed):
    out = tiny.run(held, name, seed=seed, seconds=0.1)
    assert out["correct"], out["shown"]


@pytest.mark.parametrize("kind", ["token", "half_batch"])
def test_prefill_fault_is_not_correct(held, monkeypatch, kind):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "make_prefill_step", _prefill_fault(kind))
    out = tiny.run(held, "tiny.prefill")
    assert not out["correct"], out["shown"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(held, monkeypatch, kind):
    from repro_torch.launch import steps
    monkeypatch.setattr(steps, "make_train_step", _train_fault(kind))
    out = tiny.run(held, "tiny.train")
    assert not out["correct"], out["shown"]
