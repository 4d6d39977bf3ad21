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
  rank, and ``aggregate`` merges them; the port's collective op events
  of a step on two gloo ranks are its collective calls plus the entries
  of the remat's dispatch mode around some of them.
- MAMBA blocks (hymba's reduced widths, ``block_pattern`` (MAMBA,)):
  every kind of cell ends ``ok`` on (2, 2), and on a world of 1 the
  recorded train step's FLOPs are ``FlopCounterMode``'s over the same
  step run.
- Each cell writes its program text beside its record unless asked not
  to (``save_hlo``, ``--no-hlo``).

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
from repro.configs import list_configs as jax_list_configs
from repro.core import roofline as jroof
from repro.core.structure import parse_hlo as jparse
from repro.distributed import sharding as jshard
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config
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


@pytest.mark.parametrize("name", jax_list_configs())
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
@pytest.mark.parametrize("name", jax_list_configs())
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
            blocks=None, **kw) -> dict:
    """One reduced cell in a subprocess (a fake world of its own);
    ``blocks`` replaces the block pattern."""
    out = str(tmp_path / f"{arch}_{kind}_{'x'.join(map(str, mesh_shape))}")
    axes = ("data", "model") if len(mesh_shape) == 2 else \
        ("pod", "data", "model")
    script = (
        "import dataclasses, json, sys\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun as D\n"
        f"cfg = get_config({arch!r}).reduced()\n"
        f"if {blocks!r}:\n"
        f"    cfg = dataclasses.replace(cfg, block_pattern={blocks!r})\n"
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


def test_collective_op_events_are_the_calls_and_the_mode_entries(tmp_path):
    """Reduced granite's sharded train step on (1, 2) over gloo under
    torch.profiler: the port's collective ops that run the collective are
    c10d's collective calls and the dry run's collectives, kind by kind;
    every other op event is the entry of the remat's dispatch mode around
    one of them (``chip_smoke.collective_op_events``), so the all-reduce
    op events, more than the calls, are the calls plus those under the
    mode.  ``chip_smoke``'s multi-rank check holds the card to the same
    rule."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    torch_ranks.run_ranks("collective_event_cases", 2, tmp_path, timeout=180,
                          out=str(tmp_path))
    with open(tmp_path / "collective_events.json") as f:
        got = json.load(f)
    assert got["dry"] == got["c10d"] and "all-reduce" in got["dry"]
    chip_smoke.check_collective_events(got["ops"], got["dry"], "gloo")
    ar = got["ops"]["all-reduce"]
    assert ar["events"] > ar["calls"] and ar["calls_under_mode"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mamba_cells_run_on_a_fake_world_of_4(tmp_path, kind):
    """A stack of MAMBA blocks (2 layers) records ``ok`` on (2, 2): the
    SSD scan a custom-call a layer in prefill and two in train (the
    remat's recompute), none in decode (the recurrence), no attention
    kernel, collectives in the graph, a roofline."""
    rec = run_dry(tmp_path, "hymba-1.5b", kind, (2, 2), blocks=("mamba",))
    assert rec["status"] == "ok", rec.get("trace", rec)
    want = {"train": {"ssm_scan": 4}, "prefill": {"ssm_scan": 2},
            "decode": {}}[kind]
    assert rec["kernels"] == want
    assert sum(rec["collectives"].values()) > 0
    row = rec["roofline"]
    assert row["step_time_s"] > 0 and rec["cost"]["flops"] > 0


FLOPS_SCRIPT = r"""
import dataclasses, json
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs.base import MAMBA, ShapeConfig
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D, mesh as M, steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
torch.set_num_threads(1)
cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                          block_pattern=(MAMBA,))
opts = T.ModelOptions(q_chunk=16, kv_chunk=16, ssm_chunk=16, loss_chunk=32)
with D.fake_world(1):
    mesh = M.make_mesh((1, 1), ("data", "model"), "cpu")
    plan = S.make_plan(mesh, strategy="tp")
    rec = D.dry_run(cfg, ShapeConfig("t", 64, 4, "train"), plan,
                    label="mamba", mesh_desc="1x1", opts=opts)
    full = T.init_params(torch.Generator().manual_seed(0), cfg)
    params = S.shard_tree(full, S.param_shardings(full, cfg, plan))
    step = steps.make_train_step(cfg, opts, adamw.OptConfig(), donate=True,
                                 plan=plan)
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as counter:
        step(params, adamw.init(params), {"tokens": toks,
                                          "labels": toks.int()})
print(json.dumps(dict(status=rec["status"], kernels=rec["kernels"],
                      flops=rec["cost"]["flops"],
                      counted=counter.get_total_flops())))
"""


def test_mamba_dry_run_flops_are_flop_counter_modes():
    """The recorded train step of MAMBA blocks (2 layers, 4 x 64) on a
    world of 1: its FLOPs (the products and the SSD scan's ``work``, two
    calls a layer with the remat's recompute) equal ``FlopCounterMode``'s
    over the same step run eagerly, to 1e-9, as chip_smoke holds the card
    (``MR_FLOPS_TOL``)."""
    proc = subprocess.run([sys.executable, "-c", FLOPS_SCRIPT], env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["kernels"] == {"ssm_scan": 4}
    assert abs(rec["flops"] - rec["counted"]) <= 1e-9 * rec["counted"]


@pytest.mark.parametrize("save", [True, False], ids=["default", "no-hlo"])
def test_program_text_beside_the_record(tmp_path, save):
    """By default a cell writes its recorded graph's text gzipped beside
    its record (``hlo``: the path; ``hlo_s``, ``hlo_bytes``: its cost), one
    line a node; ``save_hlo=False`` (``--no-hlo``) writes none."""
    import gzip
    rec = run_dry(tmp_path, "qwen2-1.5b", "decode", (2, 2), save_hlo=save)
    assert rec["status"] == "ok", rec.get("trace", rec)
    out = tmp_path / "qwen2-1.5b_decode_2x2"
    written = sorted(p.name for p in out.iterdir())
    if not save:
        assert "hlo" not in rec and not any(".hlo" in n for n in written)
        return
    assert written == ["qwen2-1.5b_t_2x2.hlo.gz", "qwen2-1.5b_t_2x2.json"]
    assert rec["hlo"] == str(out / "qwen2-1.5b_t_2x2.hlo.gz")
    assert rec["hlo_bytes"] == os.path.getsize(rec["hlo"]) > 0
    assert rec["hlo_s"] >= 0
    with gzip.open(rec["hlo"], "rt") as f:
        text = f.read()
    assert len(text.splitlines()) >= rec["graph_nodes"]
    assert "repro_torch.all_reduce" in text or "all_reduce" in text


@pytest.mark.parametrize("flag", [[], ["--no-hlo"]], ids=["default",
                                                          "no-hlo"])
def test_cli_passes_save_hlo(flag, monkeypatch, tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes each cell's program
    text unless given ``--no-hlo``."""
    seen = []

    def cell(arch, shape, mp, out, **kw):
        seen.append(kw["save_hlo"])
        return {"arch": arch, "shape": shape, "mesh": "m",
                "status": "skipped", "reason": ""}
    monkeypatch.setattr(D, "run_cell", cell)
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                "--out", str(tmp_path)] + flag)
    assert done.value.code == 0 and seen == [not flag]


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
