"""The port's counterparts of the examples that drive JAX
(``examples/torch_*.py``): each imports with jax blocked outright and
loads no module of the JAX package.  ``tests/test_examples.py`` runs every
example, these included, at its defaults on the CPU."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference example each one ports
PORTED = {"torch_quickstart.py": "quickstart.py",
          "torch_serve_batch.py": "serve_batch.py",
          "torch_find_redundant_sync.py": "find_redundant_sync.py",
          "torch_blame_analysis.py": "blame_analysis.py",
          "torch_counter_report.py": "counter_report.py",
          "torch_trace_timeline.py": "trace_timeline.py",
          "torch_continuous_profiling.py": "continuous_profiling.py",
          "torch_analyze_db.py": "analyze_db.py"}


def test_every_example_that_drives_jax_has_a_port():
    """Each example that imports jax or serves through the JAX package
    has a ``torch_`` counterpart (the two jax-free aggregation examples
    need none)."""
    examples = os.path.join(REPO, "examples")
    drives_jax = set()
    for name in sorted(os.listdir(examples)):
        if name.startswith("torch_") or not name.endswith(".py"):
            continue
        with open(os.path.join(examples, name)) as f:
            text = f.read()
        if "import jax" in text or "repro.launch" in text:
            drives_jax.add(name)
    ported = set(PORTED.values()) | {"serve_live.py", "profile_train.py"}
    assert drives_jax <= ported, drives_jax - ported
    assert all(os.path.exists(os.path.join(examples, p)) for p in PORTED)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_example_imports_with_jax_blocked(name):
    code = ("import importlib.util, sys\n"
            "sys.modules['jax'] = None\n"
            f"spec = importlib.util.spec_from_file_location('ex', {name!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert callable(mod.main)\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.join(REPO, "examples"),
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
