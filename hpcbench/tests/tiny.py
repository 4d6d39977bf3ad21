"""Tiny cells for the CPU tests: a checkout-like directory whose
BENCHMARK.json names cells of the real drivers at test sizes, with the
real readers.  Nothing here needs a card."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab": 256,
              "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
              "dtype": "bfloat16"}
TINY_MOE = dict(TINY_DENSE, d_ff=32,
                moe={"n_experts": 8, "top_k": 2, "capacity_factor": 1.25},
                z_loss=0.0001, aux_loss_coef=0.01)
LOOSE = 1e9


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str, limits=None) -> str:
    """A directory holding BENCHMARK.json with the cells ``tiny.prefill``
    (yi-6b's port config at tiny widths, the port's profiler) and
    ``tiny.train`` (granite-moe's), and the real metrics and traffic."""
    root = os.path.join(tmp, "root")
    hb = os.path.join(root, "hpcbench")
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(hb,
                                                                  "metrics"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _dump(os.path.join(hb, "configs", "tiny-dense.json"),
          {"name": "tiny-dense", "port_config": "yi-6b",
           "reference": "decoder", "model": TINY_DENSE})
    _dump(os.path.join(hb, "configs", "tiny-moe.json"),
          {"name": "tiny-moe", "port_config": "granite-moe-1b-a400m",
           "reference": "decoder", "model": TINY_MOE})
    with open(os.path.join(BENCH, "traffic", "prefill4k.prof.json")) as f:
        pre = json.load(f)
    pre.update(batch=2, prompt_len=64, check_batches=2, trace_units=2)
    with open(os.path.join(BENCH, "traffic", "train1k.json")) as f:
        tr = json.load(f)
    tr.update(batch=2, seq_len=64)
    _dump(os.path.join(hb, "traffic", "tiny-prefill.json"), pre)
    _dump(os.path.join(hb, "traffic", "tiny-train.json"), tr)
    lim = limits or {}
    _dump(os.path.join(hb, "limits", "tiny.prefill.json"), {"numbers": {
        k: {"limit": lim.get(k, LOOSE)}
        for k in ("kv_err", "logit_err", "token_gap")}})
    _dump(os.path.join(hb, "limits", "tiny.train.json"), {"numbers": {
        k: {"limit": lim.get(k, LOOSE)}
        for k in ("loss_gap", "grad_gap", "change_gap")}})
    bench["configs"] = [
        {"name": "tiny-dense", "source": "test", "reduced": [], "why": "t",
         "file": "hpcbench/configs/tiny-dense.json"},
        {"name": "tiny-moe", "source": "test", "reduced": [], "why": "t",
         "file": "hpcbench/configs/tiny-moe.json"}]
    bench["workloads"] = [
        {"name": "tiny.prefill", "config": "tiny-dense",
         "traffic": "tiny-prefill", "chips": 1, "why": "t"},
        {"name": "tiny.train", "config": "tiny-moe",
         "traffic": "tiny-train", "chips": 1, "why": "t"}]
    rename = {"yi6b.prefill4k.prof": "tiny.prefill",
              "granite.train1k": "tiny.train"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def run(root: str, name: str, seed: int = 7, seconds: float = 0.5,
        trace: bool = False):
    """One run of a tiny cell on the CPU, as run.py drives it."""
    import importlib
    import time
    import torch
    from hpcbench import harness
    cell = harness.find_cell(root, name)
    driver = importlib.import_module("hpcbench.drivers."
                                     + cell.traffic["kind"])
    return driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                      device=torch.device("cpu"),
                      t_process=time.monotonic())
