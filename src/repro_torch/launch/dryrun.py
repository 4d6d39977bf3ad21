"""Dry run over the (architecture x input shape x mesh) cells, the JAX
package's ``repro/launch/dryrun.py`` on ``torch.distributed``.

For every cell it joins a fake process group of the production mesh's
size (256 or 512 ranks) as rank 0, lays the plan's inputs out on that
mesh (``launch.specs.input_specs(..., plan=)``), makes rank 0's blocks as
meta tensors (shapes and dtypes, no storage), and records the sharded
step's local body (``launch.steps.local_train_step``,
``local_prefill_step``, ``local_decode_step``) on them op by op
(``core.export.record_step``: the aten graph ``make_fx`` would trace, at
a tenth of its cost a node), donating what the reference donates (a
train step's params and AdamW state, a decode step's cache: updated in
place).  The model's only branches on the device are the plain routes'
raises on the card, so the graph is the card's program: the kernels and
the collectives are one node each.  From it:

- the program structure (``core.export.module_from_graph``), the
  kernels' interiors bound at their calls' shapes
  (``kernels.graph_structures``) and the roofline
  (``core.roofline.analyze``, ``model_flops``), the collectives being the
  step's ``repro_torch::`` collective nodes;
- the counterpart of ``memory_analysis()`` (``graph_memory``): the
  argument bytes (the local shards of ``input_specs``, exactly), the
  output and alias (donated) bytes, and the peak of a liveness walk over
  the traced graph, each storage live from the node that makes it to its
  last use, the inputs throughout.  ``fits_hbm`` holds the peak against
  one H100 80GB HBM3's memory as the card reports it (``HBM_PER_CARD``).

Nothing touches a card: the run is abstract, as the reference's is.  A
decode cell is traced at its last position (``pos = seq_len - 1``: every
slot of the cache valid), where the reference's position is abstract.  A
cell that fails writes ``status="error"`` with its trace.  With
``save_hlo`` (the default; ``--no-hlo`` turns it off) each cell also
writes its program text, the recorded graph's (``str(graph)``: one line
an op, its arguments and result), gzipped beside its record as
``<label>.hlo.gz``, where the reference writes its compiled HLO text;
the record names it under ``hlo`` and its cost under ``hlo_s`` and
``hlo_bytes``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh single --out dryrun_results
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (PORT_ONLY, SHAPES, get_config,
                                 list_configs, shape_applicable)
from repro_torch.core import export
from repro_torch.core import roofline as roof_mod
from repro_torch.distributed import sharding as shard_mod
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim.adamw import OptConfig
from repro_torch.tree import leaves, tree_map

# one H100 80GB HBM3's memory as torch.cuda.mem_get_info reports it
# (chip_smoke.init_big's "card free ... of 85017493504 bytes"; PERF.md
# §5: 85.0 GB); the reference's HBM_PER_CHIP is a TPU v5e's 16 GiB
HBM_PER_CARD = 85_017_493_504
HBM_SOURCE = ("torch.cuda.mem_get_info total of an NVIDIA H100 80GB HBM3 "
              "(chip_smoke.init_big)")
PRODUCTION = {False: ((16, 16), ("data", "model"), "pod16x16"),
              True: ((2, 16, 16), ("pod", "data", "model"), "pod2x16x16")}


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    (``torch.testing``'s ``FakeStore`` and backend ``"fake"``: its
    collectives move nothing); left when the block ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process is in a process group "
                           "already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under
    ``spec`` (every block is even)."""
    return tuple(n // mesh.axis_size(smc.entry_axes(spec[i]))
                 if i < len(spec) else n for i, n in enumerate(shape))


def local_inputs(specs: dict, mesh) -> dict:
    """``input_specs``' trees as rank 0's blocks: tensors of the local
    shapes on the meta device (no storage)."""
    def one(t, sh):
        return torch.empty(local_shape(t.shape, sh.spec, mesh),
                           dtype=t.dtype, device="meta")
    return {k: tree_map(one, v, specs["shardings"][k])
            for k, v in specs.items() if k != "shardings"
            and k in specs["shardings"]}


def argument_bytes(specs: dict, mesh) -> int:
    """Bytes of one rank's blocks of every input (``input_specs``'
    leaves under their shardings; a replicated leaf whole, ``pos`` 4)."""
    total = 0
    for k, tree in specs.items():
        if k == "shardings":
            continue
        sh = specs["shardings"].get(k)
        for t, s in zip(leaves(tree), leaves(sh) if sh is not None
                        else [None] * len(leaves(tree))):
            shape = local_shape(t.shape, s.spec, mesh) if s else t.shape
            total += math.prod(shape) * t.element_size()
    return total


def _storages(val) -> list:
    """(key, bytes) of every distinct storage a node's value holds."""
    out = []
    for t in export._tensors(val):
        st = t.untyped_storage()
        out.append((st._cdata, st.nbytes()))
    return out


def graph_memory(gm: torch.fx.GraphModule) -> dict:
    """The counterpart of ``compiled.memory_analysis()`` over a traced
    step: a liveness walk in graph order, each storage (views and
    in-place results share their base's) live from the node that makes
    it to its last use; the inputs' storages throughout (the caller holds
    them; a donated one is written in place), the outputs' to the end.
    Returns {input_bytes, output_bytes, alias_bytes (outputs that are
    inputs' storages: donated, updated in place), peak_bytes}."""
    nodes = list(gm.graph.nodes)
    size: Dict[int, int] = {}
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    inputs, outputs = set(), set()
    end = len(nodes)
    for i, node in enumerate(nodes):
        if node.op == "output":
            for a in node.all_input_nodes:
                for key, nb in _storages(a.meta.get("val")):
                    outputs.add(key)
                    last[key] = end
            continue
        for a in node.all_input_nodes:
            for key, _ in _storages(a.meta.get("val")):
                last[key] = max(last.get(key, i), i)
        for key, nb in _storages(node.meta.get("val")):
            size[key] = max(size.get(key, 0), nb)
            if key not in first:
                first[key] = 0 if node.op == "placeholder" else i
                last.setdefault(key, first[key])
            if node.op == "placeholder":
                inputs.add(key)
    for key in inputs:
        last[key] = end
    delta = [0] * (end + 2)
    for key, nb in size.items():
        delta[first[key]] += nb
        delta[last[key] + 1] -= nb
    live = peak = 0
    for d in delta:
        live += d
        peak = max(peak, live)
    return dict(input_bytes=sum(size[k] for k in inputs),
                output_bytes=sum(size[k] for k in outputs),
                alias_bytes=sum(size[k] for k in outputs & inputs),
                peak_bytes=peak)


def trace_cell(cfg, shape, plan, opts: ModelOptions, *,
               kv_seq_axis: Optional[str] = None,
               n_microbatches: int = 1) -> tuple:
    """Trace rank 0's step of one cell (the plan's mesh holds the ranks'
    coordinates).  Returns (the graph, ``input_specs``' result)."""
    specs = specs_mod.input_specs(cfg, shape, plan, kv_seq_axis=kv_seq_axis)
    mesh = plan.mesh
    pspecs = tree_map(lambda s: s.spec, specs["shardings"]["params"])
    ins = local_inputs(specs, mesh)
    if shape.kind == "train":
        fn = steps_mod.local_train_step(cfg, plan, opts, OptConfig(), pspecs,
                                        n_microbatches=n_microbatches)
        n = n_microbatches

        def train(lp, lo, batch):
            # the rank's rows of the batch in n microbatches
            return fn(lp, lo, [{k: v.reshape(
                (n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(n)])
        gm = export.record_step(train, (ins["params"], ins["opt_state"],
                                       ins["batch"]))
        return gm, specs
    rows = shape.global_batch
    if shape.kind == "prefill":
        cspecs = tree_map(lambda s: s.spec, shard_mod.cache_shardings(
            specs_mod.decode_struct(cfg, shape)["cache"], cfg, plan,
            kv_seq_axis=kv_seq_axis))
        fn = steps_mod.local_prefill_step(cfg, plan, opts, pspecs, cspecs,
                                          rows)
        gm = export.record_step(fn, (ins["params"], ins["batch"]))
        return gm, specs
    cspecs = tree_map(lambda s: s.spec, specs["shardings"]["cache"])
    step = steps_mod.local_decode_step(cfg, plan, opts, pspecs, cspecs, rows)
    pos = shape.seq_len - 1
    key = "token" if "token" in specs else "embed"
    # the new token (or frame) whole on every rank, as the reference's
    # unsharded input; the step keeps the rank's rows
    x = torch.empty(specs[key].shape, dtype=specs[key].dtype, device="meta")

    def decode(lp, lc, x):
        with smc.bind(mesh):
            mb = steps_mod.batch_rows({key: x}, plan, strict=False)
        # the cache is donated: written in place and returned
        return step(lp, lc, pos, **mb), lc
    gm = export.record_step(decode, (ins["params"], ins["cache"], x))
    return gm, specs


def dry_run(cfg, shape, plan, *, label: str, mesh_desc: str,
            kv_seq_axis: Optional[str] = None, opts: ModelOptions =
            ModelOptions(), n_microbatches: int = 1,
            save_hlo: Optional[str] = None) -> dict:
    """One cell on ``plan``'s mesh (a live one: a fake world, or the
    ranks of a real run): the trace, its module, roofline and memory.
    Returns the record's fields of an ``ok`` cell.  ``save_hlo``: a
    directory to write the program text into (``write_program``)."""
    from repro_torch.kernels import graph_structures
    t0 = time.monotonic()
    gm, specs = trace_cell(cfg, shape, plan, opts, kv_seq_axis=kv_seq_axis,
                           n_microbatches=n_microbatches)
    t_trace = time.monotonic() - t0
    module = export.module_from_graph(label, gm)
    bound = sum(module.bind_kernel_structure(ks)
                for ks in graph_structures(gm))
    cost = export.cost(module)
    chips = plan.mesh.size
    report = roof_mod.analyze(label, mesh_desc, chips, cost, module,
                              model_flops_total=roof_mod.model_flops(
                                  cfg, shape))
    mem = graph_memory(gm)
    args = argument_bytes(specs, plan.mesh)
    peak = mem["peak_bytes"]
    kernels: Dict[str, int] = {}
    for op in module.all_ops():
        if op.opcode == "custom-call":
            name = op.op_name.rsplit("/", 1)[-1]
            kernels[name] = kernels.get(name, 0) + 1
    coll: Dict[str, int] = {}
    for op in module.collective_ops():
        coll[op.opcode] = coll.get(op.opcode, 0) + 1
    rec = dict(
        status="ok", chips=chips,
        trace_s=t_trace, analysis_s=time.monotonic() - t0 - t_trace,
        graph_nodes=len(gm.graph.nodes), custom_calls=bound,
        kernels=kernels, collectives=coll,
        memory={
            "argument_bytes": args,
            "traced_input_bytes": mem["input_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": peak - mem["input_bytes"] - mem["output_bytes"]
            + mem["alias_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_per_device": peak,
            "fits_hbm": bool(peak < HBM_PER_CARD),
            "hbm_per_device": HBM_PER_CARD, "hbm_source": HBM_SOURCE,
        },
        cost={k: float(v) for k, v in cost.items()},
        roofline=report.row(),
        params=cfg.n_params(), active_params=cfg.n_active_params())
    if save_hlo:
        rec.update(write_program(gm, save_hlo, label))
    return rec


def write_program(gm, out_dir: str, label: str) -> dict:
    """The recorded graph's text, gzipped, as ``<out_dir>/<label>.hlo.gz``.
    Returns the record's fields: its path, the seconds it took and its
    bytes on disk."""
    t0 = time.monotonic()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{label}.hlo.gz")
    with gzip.open(path, "wt") as f:
        f.write(str(gm.graph))
    return dict(hlo=path, hlo_s=time.monotonic() - t0,
                hlo_bytes=os.path.getsize(path))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             *, strategy: str = "tp", attn_schedule: str = "dense",
             kv_seq_axis: Optional[str] = None,
             remat_policy: str = "dots_no_batch", moe_mode: str = "gather",
             loss_chunk: int = 512, n_microbatches: int = 1,
             ssm_chunk: int = 256, slstm_block: int = 16,
             save_hlo: bool = True, tag: str = "",
             cfg=None, shape=None, mesh_shape=None, axes=None) -> dict:
    """One cell on a fake production mesh ((16, 16) or (2, 16, 16));
    ``cfg``, ``shape``, ``mesh_shape`` and ``axes`` replace the
    configuration, the shape and the mesh (a reduced model at a small
    size on a small fake world).  ``save_hlo``: write the cell's program
    text beside its record.  Writes and returns its record."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    prod_shape, prod_axes, mesh_desc = PRODUCTION[multi_pod]
    if mesh_shape is not None:
        prod_shape, prod_axes = tuple(mesh_shape), tuple(axes)
        mesh_desc = "x".join(map(str, prod_shape))
    label = f"{arch}_{shape_name}_{mesh_desc}" + (f"_{tag}" if tag else "")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_desc,
           "strategy": strategy, "tag": tag, "status": "pending"}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(out_dir, label, rec)
        return rec
    opts = ModelOptions(attn_schedule=attn_schedule,
                        remat_policy=remat_policy, loss_chunk=loss_chunk,
                        ssm_chunk=ssm_chunk, slstm_block=slstm_block)
    try:
        with fake_world(math.prod(prod_shape)):
            mesh = mesh_mod.make_mesh(prod_shape, prod_axes, "cpu")
            plan = shard_mod.make_plan(mesh, multi_pod=multi_pod,
                                       strategy=strategy,
                                       moe_weight_mode=moe_mode)
            rec.update(dry_run(cfg, shape, plan, label=label,
                               mesh_desc=mesh_desc, kv_seq_axis=kv_seq_axis,
                               opts=opts, n_microbatches=n_microbatches,
                               save_hlo=out_dir if save_hlo else None))
    except Exception as e:  # a failure here is a bug in the system
        rec.update(status="error", error=str(e)[-2000:],
                   trace=traceback.format_exc()[-4000:])
    _write(out_dir, label, rec)
    return rec


def _write(out_dir: str, label: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{label}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def _report(rec: dict) -> str:
    status = rec["status"]
    extra = rec.get("reason", rec.get("error", ""))[:120]
    if status == "ok":
        extra = (f"trace {rec['trace_s']:.1f} s, peak "
                 f"{rec['memory']['peak_per_device']} bytes, "
                 f"{rec['roofline']['dominant']}")
        if "hlo" in rec:
            extra += (f", program text {rec['hlo_bytes']} bytes gzipped "
                      f"in {rec['hlo_s']:.1f} s")
    return f"{rec['arch']} x {rec['shape']} x {rec['mesh']}: {status} {extra}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--strategy", default="tp")
    ap.add_argument("--attn-schedule", default="dense")
    ap.add_argument("--kv-seq-axis", default=None)
    ap.add_argument("--remat-policy", default="dots_no_batch")
    ap.add_argument("--moe-mode", default="gather",
                    choices=("gather", "stationary"))
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ssm-chunk", type=int, default=256)
    ap.add_argument("--slstm-block", type=int, default=16)
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-hlo", action="store_true",
                    help="write no program text")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose record file already exists")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in a process of its own "
                         "(each joins its own fake world)")
    args = ap.parse_args(argv)

    # --all: the reference's cells (a port-only configuration by name)
    archs = [a for a in list_configs() if a not in PORT_ONLY] \
        if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    kw = dict(strategy=args.strategy, attn_schedule=args.attn_schedule,
              kv_seq_axis=args.kv_seq_axis, remat_policy=args.remat_policy,
              moe_mode=args.moe_mode, loss_chunk=args.loss_chunk,
              n_microbatches=args.microbatch, ssm_chunk=args.ssm_chunk,
              slstm_block=args.slstm_block, save_hlo=not args.no_hlo,
              tag=args.tag)
    cells = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch}_{shape}_{PRODUCTION[mp][2]}" + (
                    f"_{args.tag}" if args.tag else "")
                path = os.path.join(args.out, f"{label}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"{label}: exists, skipping", flush=True)
                            continue
                cells.append((arch, shape, mp))
    failures = 0
    if args.jobs <= 1:
        for arch, shape, mp in cells:
            rec = run_cell(arch, shape, mp, args.out, **kw)
            print(_report(rec), flush=True)
            failures += rec["status"] == "error"
    else:
        import concurrent.futures
        import multiprocessing
        # the train cells first: they take the longest
        cells.sort(key=lambda c: SHAPES[c[1]].kind != "train")
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            futures = [pool.submit(run_cell, arch, shape, mp, args.out, **kw)
                       for arch, shape, mp in cells]
            for fut in concurrent.futures.as_completed(futures):
                rec = fut.result()
                print(_report(rec), flush=True)
                failures += rec["status"] == "error"
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
