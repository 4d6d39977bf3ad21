"""Multi-rank helpers of the port's mesh tests: each rank is a CPU process
joined to a gloo group through a FileStore in the test's ``tmp_path`` (no
fixed port: the suite runs in several xdist workers), with one intra-op
thread.  ``run_ranks`` starts them, waits with a deadline and fails on any
non-zero exit (a mismatched gloo collective aborts every rank through a
fatal check, it does not raise); the rank functions below write what
they computed (rank 0) into the test's directory.  ``run_jax`` runs a
JAX script on N host devices (``--xla_force_host_platform_device_count``)
in a subprocess, as the JAX package's own multi-device tests do.

Run as a script, it is one rank: ``torch_ranks.py FN RANK WORLD STORE
KWARGS_JSON``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


# "<config>+<pattern>" names a reduced configuration with its block
# pattern replaced (no configuration of either package has a MAMBA
# block); the block kinds are the strings both packages' configs use
PATTERNS = {"mamba": ("mamba",), "mamba-attn": ("mamba", "attn")}


def reduced_config(get_config, name: str):
    """The reduced config of ``name`` from ``get_config`` (either
    package's), ``+<pattern>`` applied."""
    base, _, pattern = name.partition("+")
    cfg = get_config(base).reduced()
    return dataclasses.replace(cfg, block_pattern=PATTERNS[pattern]) \
        if pattern else cfg


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), HERE]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def run_ranks(fn: str, world: int, tmp_path, timeout: float = 120.0,
              **kwargs) -> None:
    """Run ``fn(rank, world, **kwargs)`` of this module in ``world``
    processes; fail unless each exits 0 within ``timeout`` seconds."""
    store = os.path.join(str(tmp_path), f"store-{fn}-{time.time_ns()}")
    logs = [open(os.path.join(str(tmp_path), f"{fn}-rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fn, str(r), str(world),
         store, json.dumps(kwargs)], stdout=logs[r], stderr=subprocess.STDOUT,
        env=_env(), cwd=str(tmp_path)) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        text = []
        for r, _ in bad:
            logs[r].seek(0)
            text.append(f"--- rank {r}\n" + logs[r].read()[-4000:])
        raise AssertionError(f"{fn}: ranks exited {bad} (killed at the "
                             f"{timeout} s deadline: -9)\n" + "\n".join(text))
    for f in logs:
        f.close()


def start_jax(script: str, n_devices: int, tmp_path, **fmt):
    """Start ``script`` (formatted with ``fmt``) on ``n_devices`` host
    devices; returns the process (see ``wait_jax``)."""
    path = os.path.join(str(tmp_path), f"jax_{time.time_ns()}.py")
    with open(path, "w") as f:
        f.write(script.format(**fmt) if fmt else script)
    log = open(path + ".log", "w+")
    proc = subprocess.Popen(
        [sys.executable, path], stdout=log, stderr=subprocess.STDOUT,
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
                 f"{n_devices}"), cwd=str(tmp_path))
    proc.log = log
    return proc


def wait_jax(proc, timeout: float = 120.0) -> None:
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.log.seek(0)
    text = proc.log.read()
    proc.log.close()
    assert proc.returncode == 0, f"JAX side exited {proc.returncode}:\n" \
                                 f"{text[-4000:]}"


def _main(argv):
    fn, rank, world, store, kwargs = argv
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import mesh
    mesh.init_process("gloo", rank=int(rank), world_size=int(world),
                      init_method=f"file://{store}", device="cpu",
                      timeout_s=120)
    import rank_fns
    getattr(rank_fns, fn)(int(rank), int(world), **json.loads(kwargs))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
