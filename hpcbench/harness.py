"""What every cell shares: finding a cell's files by name, the port's
configuration, the per-layer readers, the device line, the check that
JAX stayed out of the process, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under ``hpcbench/``, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the source's published keys at the top
  level, the sizes as run (``model``: only these are read), the port's
  registered name (``port_config``), the reference module
  (``reference/<reference>.py``), what was cut (``reduced``), where the
  port runs otherwise than the source (``port_departures``) and what was
  assumed;
- ``traffic/<traffic>.json``: ``kind`` names the driver
  (``drivers/<kind>.py``), the rest is that driver's parameters;
- ``limits/<workload>.json``: each compared number's limit and the
  readings it was set from;
- ``metrics/<metric>.py``: ``read(rec) -> float | None``, one per
  per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    root: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    wl = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    here = os.path.join(root, "hpcbench")
    traffic = _read_json(os.path.join(here, "traffic",
                                      wl["traffic"] + ".json"))
    limits = _read_json(os.path.join(here, "limits", name + ".json"))

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m)
             and m["moves"] in names]
    return Cell(root, wl, config, traffic, limits, e2e, layer)


def port_config(model: dict, port_name: str):
    """The port's registered configuration with the sizes of ``model``
    (a depth cut, a test's tiny widths).  Raises where the port would
    run something the reference does not model."""
    from repro_torch.configs import get_config
    cfg = get_config(port_name)
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "vocab", "rope_theta", "dtype")
    repl = {k: model[k] for k in keys}
    moe = model.get("moe")
    if moe:
        repl["moe"] = dataclasses.replace(
            cfg.moe, n_experts=moe["n_experts"], top_k=moe["top_k"],
            capacity_factor=moe["capacity_factor"])
    cfg = dataclasses.replace(cfg, **repl)
    unmodelled = {"block_pattern": cfg.block_pattern != ("attn",),
                  "window": cfg.window != 0, "qk_norm": cfg.qk_norm,
                  "qkv_bias": cfg.qkv_bias,
                  "frontend": cfg.frontend != "none",
                  "moe": bool(moe) != (cfg.moe is not None) or (
                      cfg.moe is not None and (cfg.moe.shared_expert
                                               or cfg.moe.moe_every != 1))}
    bad = [k for k, v in unmodelled.items() if v]
    if bad:
        raise ValueError(f"{port_name}: the reference does not model {bad}")
    return cfg


def reference_module(cell: Cell):
    return importlib.import_module(
        "hpcbench.reference." + cell.config["reference"])


def read_metrics(cell: Cell, rec: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        path = os.path.join(cell.root, "hpcbench", "metrics",
                            m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "hpcbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def foreign_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between the order statistics."""
    xs = sorted(values)
    pos = 0.95 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def device_line(device, count: int, peak: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak)}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, shown: dict, breakdown: Optional[dict] = None
                ) -> str:
    """The last line of standard output: the keys the check reads, the
    compared numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = shown
    return json.dumps(out)
