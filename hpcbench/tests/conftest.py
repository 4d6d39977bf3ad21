"""CPU tests of the benchmark (``python -m pytest hpcbench/tests``): the
repository root and ``src`` on the path, one torch thread, and the
``chip`` marker for a test that needs a CUDA card (it decides inside the
test, never at import, and skips here with its reason)."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
for p in (HERE, os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")
