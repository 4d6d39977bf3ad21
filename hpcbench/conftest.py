"""Set-up for the benchmark's own CPU tests (``python -m pytest
hpcbench/tests``), loaded before ``tests/conftest.py``.

``tests/tiny.make_root`` builds a tiny checkout from BENCHMARK.json and
renames the cells in each metric's ``workloads`` list to its two tiny
cells, which stand in for the two cells the benchmark began with
(``TINY``).  A cell added since has no tiny counterpart, so
``make_root`` reads a copy of BENCHMARK.json whose lists hold only the
cells it renames."""
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "tests"))

import tiny  # noqa: E402

TINY = ("yi6b.prefill4k.prof", "granite.train1k")
_make_root = tiny.make_root


def _make_root_of_tiny_cells(tmp: str, limits=None) -> str:
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in TINY]
    root = tiny.ROOT
    with tempfile.TemporaryDirectory() as src:
        with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f)
        tiny.ROOT = src
        try:
            return _make_root(tmp, limits)
        finally:
            tiny.ROOT = root


tiny.make_root = _make_root_of_tiny_cells
