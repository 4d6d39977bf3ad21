"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.core.roofline``) against the JAX package's, on the CPU.

- ``roofline.analyze`` and ``model_flops`` give the reference's numbers
  for the same cost, chips and collectives (the reference run with the
  H100 constants), for every configuration and shape: exactly.
- The dry run's per-device argument bytes are those of the reference's
  ``input_specs`` shardings on a ``jax.sharding.AbstractMesh`` of the
  same shape, for every (arch x shape) on (16, 16) and (2, 16, 16):
  exactly (shapes only, no trace).
- Reduced configurations on fake worlds of 8 ((2, 4) and (2, 2, 2)):
  a train, a prefill and a decode cell each end ``ok``, with their
  kernels and collectives in the graph.
- On a fake world of 4 ((2, 2)) the recorded train step's collectives,
  count and operand bytes by kind, are what an eager gloo run of the
  same step on 4 CPU ranks logs.
- A profiled train step on two ranks writes one measurement directory a
  rank, and ``aggregate`` merges them.

A dry run joins a fake process group, and a pytest worker may hold a
real one already, so each runs in a subprocess."""
import glob
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_ranks
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.core import roofline as jroof
from repro.core.structure import parse_hlo as jparse
from repro.distributed import sharding as jshard
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.core import roofline as troof
from repro_torch.core import sampling
from repro_torch.core.structure import parse_hlo as tparse
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs
from repro_torch.launch.mesh import abstract_mesh

torch.set_num_threads(1)

HLO = """HloModule step, entry_computation_layout={()}

ENTRY %main (p0: f32[64,128], p1: bf16[32,256]) -> f32[64,128] {
  %p0 = f32[64,128]{1,0} parameter(0)
  %p1 = bf16[32,256]{1,0} parameter(1)
  %ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[128,256]{1,0} all-gather(bf16[32,256]{1,0} %p1), replica_groups=[4,4]<=[16], dimensions={0}
  %rs = f32[16,128]{1,0} reduce-scatter(f32[64,128]{1,0} %ar), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %cp = bf16[32,256]{1,0} collective-permute(bf16[32,256]{1,0} %p1), source_target_pairs={{0,1},{1,0}}
  ROOT %out = f32[64,128]{1,0} add(f32[64,128]{1,0} %ar, f32[64,128]{1,0} %ar)
}
"""
H100 = dict(peak_flops=sampling.PEAK_FLOPS, hbm_bw=sampling.HBM_BW,
            ici_bw=sampling.ICI_BW)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")]), OMP_NUM_THREADS="1")


@pytest.mark.parametrize("name", list_configs())
def test_roofline_and_model_flops_are_the_references(name, monkeypatch):
    """For every shape: ``model_flops`` equal, and ``analyze`` over the
    same cost dict, chips and module (one with each collective kind,
    parsed by the reference's parser and the port's copy) gives the same
    row, field for field, the reference given the H100's constants (its
    MFU reads its module's peak, set to the H100's for the test).  The
    module has no while loop, so the reference's trip-count scale is 1,
    as the port's always is."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", sampling.PEAK_FLOPS)
    cfg, jcfg = get_config(name), jax_get_config(name)
    jmod, tmod = jparse(HLO, name="step"), tparse(HLO, name="step")
    assert len(tmod.collective_ops()) == 4
    for sname, shape in SHAPES.items():
        want_mf = jroof.model_flops(jcfg, JSHAPES[sname])
        got_mf = troof.model_flops(cfg, shape)
        assert got_mf == want_mf
        cost = {"flops": 3.7 * want_mf / 256, "bytes accessed": 1.5e12}
        want = jroof.analyze(name, "pod16x16", 256, cost, module=jmod,
                             model_flops_total=want_mf, **H100)
        got = troof.analyze(name, "pod16x16", 256, cost, tmod,
                            model_flops_total=got_mf)
        assert got.row() == want.row()
        assert got.bytes_per_dev == want.bytes_per_dev
    assert troof.markdown_table([got.row()]) == \
        jroof.markdown_table([want.row()])


def _reference_bytes(jcfg, shape, mesh):
    """Per-device bytes of the reference's ``input_specs`` on an
    abstract mesh: each leaf's shard shape under its sharding, a leaf
    without one whole."""
    plan = jshard.make_plan(mesh, multi_pod=len(mesh.axis_names) == 3)
    tree = jspecs.input_specs(jcfg, shape, plan)
    total = 0
    for leaf in jax.tree.leaves(tree):
        sh = getattr(leaf, "sharding", None)
        dims = sh.shard_shape(leaf.shape) if sh is not None else leaf.shape
        total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list_configs())
def test_argument_bytes_are_the_references(name, mesh):
    shape_, axes = MESHES[mesh]
    cfg, jcfg = get_config(name), jax_get_config(name)
    amesh = abstract_mesh(shape_, axes)
    for sname, shape in SHAPES.items():
        plan = S.make_plan(amesh, multi_pod=mesh == "multi")
        got = D.argument_bytes(specs.input_specs(cfg, shape, plan), amesh)
        want = _reference_bytes(jcfg, JSHAPES[sname],
                                AbstractMesh(shape_, axes))
        assert got == want, (sname, got, want)


def run_dry(tmp_path, arch, kind, mesh_shape, seq=64, batch=8,
            **kw) -> dict:
    """One reduced cell in a subprocess (a fake world of its own)."""
    out = str(tmp_path / f"{arch}_{kind}_{'x'.join(map(str, mesh_shape))}")
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    script = (
        "import json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun as D\n"
        f"cfg = get_config({arch!r}).reduced()\n"
        f"shape = ShapeConfig('t', {seq}, {batch}, {kind!r})\n"
        f"rec = D.run_cell({arch!r}, 't', {len(mesh_shape) == 3}, {out!r},"
        f" cfg=cfg, shape=shape, mesh_shape={tuple(mesh_shape)!r},"
        f" axes={axes!r}, **{kw!r})\n"
        "json.dump(rec, sys.stdout)\n")
    proc = subprocess.run([sys.executable, "-c", script], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


CELLS = [("qwen2-1.5b", "train"), ("hymba-1.5b", "prefill"),
         ("granite-moe-1b-a400m", "decode")]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2, 2)],
                         ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("arch,kind", CELLS, ids=[c[1] for c in CELLS])
def test_reduced_cells_run_on_a_fake_world_of_8(tmp_path, arch, kind,
                                                mesh_shape):
    """Each cell ends ``ok``: its kernels are custom-calls bound to their
    interiors, its collectives are in the graph, its argument bytes are
    the traced inputs' (decode's ``pos``, a Python int here, aside) and
    its peak holds them."""
    rec = run_dry(tmp_path, arch, kind, mesh_shape)
    assert rec["status"] == "ok", rec.get("trace", rec)
    assert rec["chips"] == 8 and rec["custom_calls"] >= 2
    want = {"train": "flash_attention", "prefill": "ssm_scan",
            "decode": "decode_attention"}[kind]
    assert rec["kernels"].get(want, 0) >= 2
    assert sum(rec["collectives"].values()) > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] - mem["traced_input_bytes"] == \
        (4 if kind == "decode" else 0)
    assert mem["peak_per_device"] >= mem["traced_input_bytes"]
    if kind != "prefill":   # donated: written in place
        assert mem["alias_bytes"] > 0
    row = rec["roofline"]
    assert row["step_time_s"] == max(row["t_compute_s"], row["t_memory_s"],
                                     row["t_collective_s"]) > 0
    assert rec["cost"]["flops"] == row["hlo_flops_per_dev"] > 0


def test_collectives_are_what_an_eager_gloo_run_logs(tmp_path):
    """Reduced granite's train step (4 x 32) on (2, 2): the recorded
    step's collectives, their count and operand bytes by kind, equal the
    collectives an eager run of the same step on 4 gloo ranks makes."""
    torch_ranks.run_ranks("collective_cases", 4, tmp_path, timeout=180,
                          out=str(tmp_path), seq=32, batch=4)
    with open(tmp_path / "eager_collectives.json") as f:
        calls = json.load(f)
    eager: dict = {}
    for kind, nbytes in calls:
        n, b = eager.get(kind, (0, 0))
        eager[kind] = (n + 1, b + nbytes)
    rec = run_dry(tmp_path, "granite-moe-1b-a400m", "train", (2, 2),
                  seq=32, batch=4)
    assert rec["status"] == "ok", rec.get("trace", rec)
    assert rec["collectives"] == {k: n for k, (n, _) in eager.items()}
    row = rec["roofline"]
    assert row["coll_operand_bytes_per_dev"] == sum(
        b for _, b in eager.values())
    assert len(eager) >= 3


def test_profiled_train_on_two_ranks_writes_a_directory_a_rank(tmp_path):
    """``train(profile_dir=..., mesh=...)``: ``rank0`` and ``rank1`` each
    hold their rank's profiles and a measurement with the traced local
    step's collectives; ``aggregate`` over both merges the two ranks."""
    from repro_torch.core.aggregate import aggregate
    torch_ranks.run_ranks("profiled_train", 2, tmp_path, timeout=240,
                          out=str(tmp_path))
    dirs = sorted(glob.glob(str(tmp_path / "prof" / "rank*")))
    assert [os.path.basename(d) for d in dirs] == ["rank0", "rank1"]
    paths = []
    for r, d in enumerate(dirs):
        mine = sorted(glob.glob(os.path.join(d, "profile_*.rpro")))
        assert mine and all(f"_r{r}_" in os.path.basename(p)
                            for p in mine), mine
        with open(os.path.join(d, "measurement.json")) as f:
            step = json.load(f)["steps"]["train_step"]
        assert step["collectives"] > 0 and step["custom_calls"] > 0
        paths += mine
    db = aggregate(paths, str(tmp_path / "db"))
    assert {int(i["rank"]) for i in db.profile_ids.values()} == {0, 1}
