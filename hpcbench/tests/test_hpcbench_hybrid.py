"""The Mamba-2 hybrid's cell on the CPU at tiny widths: the driver runs
the window, the traced segment and the check end to end against the
plain reference, its calibration reads the program and the float8
control apart, and the configuration's file holds the catalog's numbers
with the one cut that ``reduced`` names."""
import json
import os
import time

import pytest
import torch

from conftest import ROOT
from hpcbench import harness
from hpcbench.drivers import prefill_hybrid

TINY = {"n_layers": 10, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "block_pattern": ["mamba"] * 5 + ["attn"]
        + ["mamba"] * 4, "mamba_heads": 4, "mamba_head_dim": 16,
        "mamba_groups": 1, "ssm_state": 16, "conv_width": 4, "d_ff": 32,
        "shared_ff": 48, "vocab": 256,
        "moe": {"n_experts": 8, "top_k": 2, "capacity_factor": 1.25,
                "held": 3},
        "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
        "attention_multiplier": 0.0625, "logits_scaling": 16.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
        "dtype": "bfloat16"}
CELL = "granite4h.prefill16k"


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell's own traffic, limits and readers over a tiny model."""
    root = str(tmp_path_factory.mktemp("hybrid"))
    hb = os.path.join(root, "hpcbench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for sub in ("metrics",):
        os.makedirs(os.path.join(hb, sub))
        for name in os.listdir(os.path.join(ROOT, "hpcbench", sub)):
            with open(os.path.join(ROOT, "hpcbench", sub, name)) as f:
                text = f.read()
            with open(os.path.join(hb, sub, name), "w") as f:
                f.write(text)
    with open(os.path.join(ROOT, "hpcbench", "traffic",
                           "prefill16k.hybrid.json")) as f:
        mix = json.load(f)
    mix.update(prompt_len=64, ssm_chunk=16)
    _dump(os.path.join(hb, "traffic", "prefill16k.hybrid.json"), mix)
    with open(os.path.join(ROOT, "hpcbench", "limits",
                           CELL + ".json")) as f:
        _dump(os.path.join(hb, "limits", CELL + ".json"), json.load(f))
    _dump(os.path.join(hb, "configs", "granite-4.0-h-small.json"),
          {"name": "granite-4.0-h-small",
           "port_config": "granite-4.0-h-small",
           "reference": "granite_hybrid", "model": TINY})
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return harness.find_cell(root, CELL)


def test_the_cell_runs_and_checks_on_the_cpu(cell):
    for trace in (False, True):
        out = prefill_hybrid.run(cell, seed=2 ** 31 + 3, seconds=0.3,
                                 trace=trace, device=torch.device("cpu"),
                                 t_process=time.monotonic())
        assert out["correct"], out["shown"]
        assert set(out["shown"]) == {"kv_err", "state_err", "logit_err"}
        if trace:
            # no device time on the CPU: the kernel and scope readers
            # find nothing; the counter and the window's FLOPs do
            assert "moe_drop_pct.prefill" in out["metrics"]
            assert "mfu.prefill" in out["metrics"]
            assert "ssd_roofline.prefill" not in out["metrics"]
        else:
            assert set(out["metrics"]) == {"prefill_tok_s", "ttft_p95_ms",
                                           "setup_s"}


def test_calibration_reads_program_and_control_apart(cell):
    """The float8 control lies above the program on every compared
    number, at tiny widths too."""
    got = []
    prefill_hybrid.calibrate(cell, [11, 12], 1, torch.device("cpu"),
                             lambda **kw: got.append(kw))
    prog = [r["numbers"] for r in got if r["side"] == "program"]
    ctrl = [r["numbers"] for r in got if r["side"] == "control_fp8"]
    assert len(prog) == 2 and len(ctrl) == 1
    for k in ("kv_err", "state_err", "logit_err"):
        assert ctrl[0][k] > 2 * max(p[k] for p in prog), k


def test_a_program_without_the_configuration_fails_at_once(cell):
    """The configuration is resolved before any weight is made."""
    bad = harness.Cell(cell.root, cell.workload,
                       dict(cell.config, port_config="no-such-config"),
                       cell.traffic, cell.limits, cell.end_to_end,
                       cell.per_layer)
    with pytest.raises(KeyError):
        prefill_hybrid.run(bad, seed=1, seconds=0.1, trace=False,
                           device=torch.device("cpu"),
                           t_process=time.monotonic())


def test_the_configuration_file_holds_the_catalog_numbers():
    with open(os.path.join(ROOT, "hpcbench", "configs",
                           "granite-4.0-h-small.json")) as f:
        body = json.load(f)
    assert body["reduced"] == ["num_local_experts"]
    assert body["num_local_experts"] == body["model"]["moe"]["held"] == 18
    assert body["num_local_experts_published"] == 72
    m = body["model"]
    assert (m["d_model"], m["mamba_heads"], m["mamba_head_dim"],
            m["ssm_state"], m["d_ff"], m["shared_ff"], m["vocab"]) == (
        body["hidden_size"], body["mamba_n_heads"], body["mamba_d_head"],
        body["mamba_d_state"], body["intermediate_size"],
        body["shared_intermediate_size"], body["vocab_size"])
    kinds = ["attn" if t == "attention" else "mamba"
             for t in body["layer_types"]]
    assert kinds == m["block_pattern"] * (m["n_layers"]
                                          // len(m["block_pattern"]))
    cfg = prefill_hybrid.port_config(m, body["port_config"])
    assert cfg.experts_held == 18 and not cfg.use_rope
