"""The port's package boundary, its device policy and its copy of the
measurement front end, against the JAX package's."""
import ast
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core.cct as jcct
import repro.core.profiler as jprofiler
import repro.core.trace as jtrace
import repro_torch.core.cct as tcct
import repro_torch.core.profiler as tprofiler
import repro_torch.core.trace as ttrace
from repro_torch import copies
from repro_torch.configs import get_config
from repro_torch.core import derived, kstruct, sampling
from repro_torch.core.profmt import read_profile
from repro_torch.launch import serve as serve_mod

# one intra-op thread: the suite runs in several workers at once, beside
# wall-clock tests (the serving governor's)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    bad = []
    files = _port_sources()
    assert len(files) > 60
    # the measurement and analysis subpackages are among them
    for sub in ("core/pipeline", "counters", "traceview", "ft", "serving",
                "fleet"):
        assert any(os.path.join(PORT, sub) + os.sep in f for f in files), sub
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Importing the serving path loads no jax (blocked outright) and no
    module of the JAX package."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.launch.serve, repro_torch.kernels.ops, "
            "repro_torch.core.profiler, repro_torch.convert, "
            "repro_torch.core.export, repro_torch.core.kstruct, "
            "repro_torch.core.aggregate, repro_torch.core.viewer, "
            "repro_torch.core.merge, repro_torch.core.derived, "
            "repro_torch.counters, repro_torch.traceview, repro_torch.ft, "
            "repro_torch.serving.window, repro_torch.serving.sweep, "
            "repro_torch.fleet, repro_torch.models.moe, "
            "repro_torch.models.xlstm, repro_torch.copies\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_serve_without_device_needs_cuda():
    """No silent CPU fallback: without CUDA, the default device raises."""
    cfg = get_config("qwen2-1.5b").reduced()
    if torch.cuda.is_available():
        assert serve_mod.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_mod.serve(cfg)
    assert serve_mod.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", copies.COPIES)
def test_copied_modules_differ_only_in_imports(name):
    """The measurement and analysis copies are the JAX package's modules
    with their imports pointed at repro_torch, nothing else changed."""
    with open(os.path.join(REPO, "src", "repro", name)) as f:
        want = copies.port_text(f.read())
    with open(os.path.join(PORT, name)) as f:
        got = f.read()
    assert got == want
    assert "import repro." not in got and "from repro." not in got


def _class_source(path, name, stop):
    """The text of class ``name`` in ``path`` up to the line ``stop``."""
    with open(path) as f:
        text = f.read()
    start = text.index(f"class {name}")
    return text[start:text.index(stop, start)]


def test_kstruct_copy_differs_only_in_front_end():
    """KernelLeaf, KernelStructure and the sample descent are the JAX
    package's byte for byte; the port replaces the jaxpr front end by the
    CUDA-source one and the chip constants by the H100's."""
    ref = os.path.join(REPO, "src", "repro", "core", "kstruct.py")
    port = os.path.join(PORT, "core", "kstruct.py")
    for name, stop in (("KernelLeaf", "class KernelStructure"),
                       ("KernelStructure", "    @classmethod")):
        assert _class_source(port, name, stop) == \
            _class_source(ref, name, stop)
    assert kstruct.PEAK_FLOPS == sampling.PEAK_FLOPS == 989e12
    assert kstruct.HBM_BW == sampling.HBM_BW
    assert "exp2" in kstruct._TRANSCENDENTAL


def test_h100_constants_and_pruned_tool_path():
    assert (sampling.PEAK_FLOPS, sampling.HBM_BW, sampling.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    assert tprofiler._PRUNE[0] == "repro_torch/core"
    assert tcct.unwind_host_stack.__defaults__[2][0] == "repro_torch/core"
    # counters are collected: flop efficiency is against the H100 peak
    prof = tprofiler.Profiler.__new__(tprofiler.Profiler)
    sched = tprofiler.Profiler.enable_counters(prof, ["flops", "hbm_bytes"])
    assert sched.n_passes >= 1 and prof._counters is not None
    assert str(sampling.PEAK_FLOPS * 1e-9) in derived.FLOP_EFFICIENCY.formula


def _scripted_run(prof_mod, cct_mod, out_dir):
    """A deterministic dispatch sequence: scripted clock, keyed rng, no
    unwinding, no module."""
    ticks = itertools.count(0, 1000)
    prof = prof_mod.Profiler(str(out_dir), tracing=True, rng_seed=0,
                             unwind=False, clock=lambda: next(ticks))
    prof.start()
    win = cct_mod.Frame(cct_mod.HOST, "request:r0", "", 0)
    for i in range(24):
        name = "prefill" if i % 6 == 0 else "decode_step"
        if i < 12:
            with prof.window(win):
                with prof.dispatch("kernel", name, stream=0):
                    pass
        else:
            with prof.dispatch("kernel", name, stream=0):
                pass
        if i % 5 == 2:
            with prof.dispatch("sync", "device_sync", stream=0):
                pass
        with prof.dispatch("copy", "h2d", stream=1, nbytes=4096):
            pass
    with prof.cpu_region("sample_tokens"):
        pass
    assert prof.flush()
    paths = prof.write()
    prof.stop()
    return paths


def _events(trace_mod, path):
    td = trace_mod.read_trace(path)
    ev = np.stack([td.starts, td.ends, td.ctx], axis=1)
    return td.identity, ev[np.lexsort(ev.T[::-1])]


def test_profiler_copy_writes_identical_profiles(tmp_path):
    jp = _scripted_run(jprofiler, jcct, tmp_path / "jax")
    tp = _scripted_run(tprofiler, tcct, tmp_path / "torch")
    assert sorted(jp) == sorted(tp)
    assert {os.path.basename(p) for p in jp.values()} == \
        {os.path.basename(p) for p in tp.values()}
    n_traces = 0
    for label, path in jp.items():
        if path.endswith(".rpro"):
            with open(path, "rb") as a, open(tp[label], "rb") as b:
                assert a.read() == b.read(), label
        else:
            ji, je = _events(jtrace, path)
            ti, te = _events(ttrace, tp[label])
            assert ji == ti, label
            np.testing.assert_array_equal(je, te, err_msg=label)
            n_traces += 1
    assert n_traces >= 3


def test_serve_profile_has_no_tool_frames(tmp_path):
    """The port's own measurement frames are pruned from every calling
    context: none lies under repro_torch/core, while the dispatch site in
    launch/serve.py, both step placeholders and the injected redundant
    syncs are there."""
    cfg = get_config("qwen2-1.5b").reduced()
    _, paths = serve_mod.serve(cfg, n_requests=2, batch=2, prompt_len=16,
                               gen_len=3, profile_dir=str(tmp_path),
                               device="cpu", redundant_sync=True)
    prof = read_profile(paths["cpu_0"])
    modules = {f.module for f in prof.frames}
    assert not [m for m in modules if "repro_torch/core" in m]
    assert any(m.endswith(os.path.join("repro_torch", "launch", "serve.py"))
               for m in modules)
    names = {f.name for f in prof.frames}
    assert {"kernel:prefill", "kernel:decode_step",
            "sync:device_sync"} <= names
    for label in ("cpu_trace_0", "gpu_0", "gpu_trace_0"):
        assert os.path.getsize(paths[label]) > 0


def test_profiler_keys_threads_that_run_one_after_another(tmp_path):
    """Eight threads started and joined one after another (so an ended
    thread's ident can pass to the next) each dispatch under the port's
    profiler: eight thread profiles, every dispatch attributed once.  The
    port keys a thread's state by a thread-local, not by
    ``threading.get_ident``."""
    import threading
    prof = tprofiler.Profiler(str(tmp_path), tracing=False, rng_seed=0,
                              unwind=False)
    n, k = 8, 3

    def worker():
        for _ in range(k):
            with prof.dispatch("kernel", "step", stream=0):
                pass

    with prof:
        for _ in range(n):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert prof.flush(timeout=30)
    paths = prof.write()
    cpu = [v for key, v in paths.items()
           if key.startswith("cpu_") and "trace" not in key]
    assert len(cpu) == n
    total = 0
    for path in cpu:
        d = read_profile(path)
        inv = d.metrics.index("gpu_kernel/invocations")
        total += sum(v for m, v in zip(d.value_mids, d.values) if m == inv)
    assert total == n * k


def test_callgraph_copy_rebuilds_fig5_as_the_reference():
    """The paper's Fig. 5 (``tests/test_callgraph.py``'s graph) through
    the port's copy of the reconstruction: the same tree as the JAX
    package's, node by node, with the same costs and SCC members."""
    from repro.core import callgraph as jcg
    from repro_torch.core import callgraph as tcg

    def fig5(mod):
        edges = {("A", "B"): 0.0, ("A", "C"): 1.0, ("B", "D"): 1.0,
                 ("C", "D"): 3.0, ("D", "E"): 2.0, ("E", "D"): 2.0}
        samples = {"A": 10.0, "B": 4.0, "C": 6.0, "D": 8.0, "E": 4.0}
        return mod.CallGraph(["A", "B", "C", "D", "E"], edges, samples)

    def walk(node):
        return (node.name, node.cost, tuple(node.members),
                tuple(walk(c) for c in node.children))

    want = jcg.reconstruct(fig5(jcg), roots=["A"])
    got = tcg.reconstruct(fig5(tcg), roots=["A"])
    assert walk(got) == walk(want)
    assert got.find("SCC{D,E}").members == ("D", "E")
    assert got.total() == pytest.approx(32.0)
