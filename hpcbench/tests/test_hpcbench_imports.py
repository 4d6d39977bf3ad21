"""Nothing of the benchmark imports JAX or the JAX package, by whole
top-level names; the reference imports nothing of the port."""
import ast
import os
import sys

import pytest

from conftest import ROOT

from hpcbench import harness

BENCH = os.path.join(ROOT, "hpcbench")


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    bad = {n for n in _imports(path) if top(n) in harness.FORBIDDEN}
    assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        bad = {n for n in _imports(path)
               if top(n) in ("repro_torch",) + harness.FORBIDDEN}
        assert not bad, f"{path} imports {bad}"


def test_names_are_compared_whole(monkeypatch):
    """``repro_torch`` starts with ``repro`` and is not it."""
    monkeypatch.setitem(sys.modules, "repro_torch_fake_check", sys)
    assert "repro" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_check", sys)
    assert "repro" in harness.foreign_modules()


def test_the_port_loads_no_jax():
    """The port's modules the drivers import leave no JAX behind (in a
    fresh interpreter: the test process may hold JAX for other tests)."""
    import subprocess
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import hpcbench.drivers.prefill, hpcbench.drivers.train\n"
            "import repro_torch.launch.serve, repro_torch.launch.steps\n"
            "import repro_torch.core.profiler, repro_torch.core.export\n"
            "import repro_torch.optim.adamw, repro_torch.kernels.ops\n"
            "from hpcbench import harness\n"
            "print(harness.foreign_modules())\n"
            % (ROOT, os.path.join(ROOT, "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
