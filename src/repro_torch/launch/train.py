"""Training on one device, the JAX package's
``repro/launch/train.py``.

Wires the substrates together: config -> seeded parameters and AdamW
state (or a resumed checkpoint) -> the synthetic token pipeline with its
prefetch thread -> the train step (``steps.make_train_step``: loss,
backward, optional int8 gradient wire model, AdamW) -> the checkpoint
manager (atomic, async) -> the straggler watchdog.  Each step is
donated its parameters and AdamW state, as the reference jits its step
with ``donate_argnums=(0, 1)``: the update writes them in place, so a
step holds one copy of the weights and moments (about 14 bytes a
parameter beside the activations, where two copies were 22; what lets
musicgen-large and yi-6b train on one 80 GB card).  A caller's
``params`` and ``opt_state`` are therefore updated in place: after
``train`` they hold the last step's values, and the returned parameters
are the same tensors.  The checkpoint manager copies every leaf to the
host before ``save`` returns, so its background write never sees a later
step's values.  On the card the
attention and the mamba mixer run the hand-written Hopper kernels
(``ModelOptions.use_flash_kernel``, on by default), their recompute under
remat included; their backward is plain torch, as the reference's.

With a profile directory the paper's measurement stack runs around every
step: before the profiler starts, the whole train step is recorded
(``core.export.trace_train_step`` on meta tensors), the kernels' interiors
recovered from their CUDA source at the step's shapes are bound to its
``custom-call`` ops and the module is registered; every step is then
dispatched under ``Profiler.dispatch("kernel", "train_step")`` and ends
in a synchronize inside the dispatch, so the profile's times are device
times, and PC samples descend into the kernels.  The step's phases carry the JAX
package's named scopes (``steps.make_train_step``), so the database's
top-down view under the ``train_step`` placeholder splits into
``fwd_bwd`` (``fwd_bwd_micro``), ``grad_compression`` and
``optimizer``; torch.profiler sees the same names as ranges.

Runs on the card unless the caller asks for the CPU (``device="cpu"``,
as the tests do); there is no CPU fallback.

On a device mesh (``mesh=``, a ``launch.mesh.Mesh`` over the world's
ranks, every rank calling ``train``) the reference's sharding plan
(``strategy``: ``tp``, ``fsdp`` or ``dp_only``; the MoE weight mode
too) lays the parameters and AdamW state out as DTensors: each rank
builds the seeded parameters whole and keeps its blocks, or takes a
sharded tree (``convert.params_from_jax(..., plan=)``), and the step is
``steps.make_train_step(..., plan=)``.  Every rank draws the same global
batches; the step keeps its rows.  Checkpoints are written by block and
restored onto the mesh's layout.  With a profile directory each rank
measures itself into ``<profile_dir>/rank<R>`` under its own rank
(profiles ``profile_r<R>_t<i>.rpro``), the traced step being its local
body (``steps.local_train_step`` on its blocks and rows, the
collectives as nodes), so ``aggregate`` over every rank's profiles
merges the ranks as it merges processes.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed import sharding as shard_mod
from repro_torch.distributed import shardmap_compat as smc
from repro_torch.ft import StragglerWatchdog
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import leaves


def to_device(batch: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: token ids as
    int64 (the embedding's index), labels as given (int32)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if k == "tokens" else t).to(device)
    return out


def train(cfg: ModelConfig, shape: ShapeConfig, *, n_steps: int = 20,
          mesh=None, strategy: str = "tp",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          profile_dir: Optional[str] = None,
          opts: Optional[T.ModelOptions] = None,
          opt_cfg: Optional[adamw.OptConfig] = None,
          grad_compression: bool = False, n_microbatches: int = 1,
          seed: int = 0, resume: bool = False, log_every: int = 10,
          host_id: int = 0, watchdog: Optional[StragglerWatchdog] = None,
          device="cuda", params=None, opt_state=None):
    """Returns (final params, metrics history, profile paths or None).

    ``params`` / ``opt_state`` take a parameter tree and an AdamW state
    (e.g. from ``convert.params_from_jax`` / ``opt_state_from_jax``)
    instead of the seeded initialisation and zero moments; every step
    updates them in place (donated).  The history
    holds ``{"step", "loss", "gnorm"}`` every ``log_every`` steps and at
    the last.  With a profile directory, ``paths["measurement"]`` is a
    JSON file of the registered train step's op count, custom-calls bound,
    trace and registration seconds and cost under ``steps``, and the
    profiler's overhead counters under ``profiler``."""
    dev = resolve_device(device)
    opts = opts or T.ModelOptions()
    opt_cfg = opt_cfg or adamw.OptConfig(total_steps=max(n_steps, 2))
    watchdog = watchdog or StragglerWatchdog()
    plan = None
    if mesh is not None:
        plan = shard_mod.make_plan(mesh, strategy=strategy)

    # ---- init or resume --------------------------------------------------
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = T.init_params(gen, cfg)
    if plan is not None and not any(isinstance(t, smc.DTensor)
                                    for t in leaves(params)):
        # whole tensors (the same on every rank): each keeps its blocks
        params = shard_mod.shard_tree(
            params, shard_mod.param_shardings(params, cfg, plan))
    if opt_state is None:
        opt_state = adamw.init(params)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        start_step, state = mgr.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]

    # ---- data -------------------------------------------------------------
    ds = SyntheticLM(cfg, shape, seed=seed, host_id=host_id)
    step_fn = steps_mod.make_train_step(cfg, opts, opt_cfg,
                                        grad_compression=grad_compression,
                                        n_microbatches=n_microbatches,
                                        donate=True, plan=plan)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # ---- optional measurement (the paper's tool) ---------------------------
    prof = mid = None
    structure = {}
    if profile_dir:
        from repro_torch.core.profiler import Profiler
        rank = 0
        if mesh is not None:
            rank = mesh.rank
            profile_dir = os.path.join(profile_dir, f"rank{rank}")
        prof = Profiler(profile_dir, tracing=True, rng_seed=seed, rank=rank)
        mid, structure["train_step"] = register_train_step(
            prof, cfg, opts, step_fn, params, opt_state,
            to_device(ds.batch_at(start_step), dev))
        prof.start()

    prefetch = Prefetcher(ds, start_step=start_step)
    history = []
    try:
        for step in range(start_step, n_steps):
            _, batch = next(prefetch)
            batch = to_device(batch, dev)
            if prof is not None:
                with prof.dispatch("kernel", "train_step", stream=0,
                                   module_id=mid):
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    sync()
            else:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            watchdog.beat(f"host{host_id}", step)
            if step % log_every == 0 or step == n_steps - 1:
                loss = float(metrics["loss"])
                history.append({"step": step, "loss": loss,
                                "gnorm": float(metrics["grad_norm"])})
                print(f"step {step:5d} loss {loss:.4f}", flush=True)
            if mgr and ((step + 1) % ckpt_every == 0
                        or step == n_steps - 1):
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         block=False)
        if mgr:
            mgr.wait()
    finally:
        prefetch.close()
    paths = None
    if prof is not None:
        prof.flush()
        paths = prof.write()
        prof.stop()
        paths["measurement"] = os.path.join(prof.out_dir, "measurement.json")
        with open(paths["measurement"], "w") as f:
            json.dump({"steps": structure,
                       "profiler": prof.overhead_counters(),
                       "clock_anchor": prof.clock_anchor}, f, indent=1,
                      sort_keys=True)
    return params, history, paths


def register_train_step(prof, cfg: ModelConfig, opts: T.ModelOptions,
                        step_fn, params, opt_state, batch) -> tuple:
    """Record the whole train step at these inputs' shapes
    (``core.export.trace_train_step``: a donated step's in-place update
    is recorded as in-place ops and leaves the inputs as they are; a
    sharded step's local body on this rank's blocks, its collectives as
    nodes), bind the kernels' interiors at the
    shapes its ``custom-call`` ops take (``kernels.graph_structures``) and
    register the module with ``prof`` (with its cost).  Returns (module
    id, {op count, custom-calls bound, collectives, trace and
    registration seconds, cost})."""
    from repro_torch.core import export
    from repro_torch.kernels import graph_structures
    t0 = time.perf_counter()
    fn, args = step_fn, (params, opt_state, batch)
    if hasattr(step_fn, "local_args"):
        fn, args = step_fn.local_args(params, opt_state, batch)
    gm = export.trace_train_step(fn, args)
    module = export.module_from_graph("train_step", gm)
    bound = sum(module.bind_kernel_structure(ks)
                for ks in graph_structures(gm))
    cost = export.cost(module)
    mid = prof.register_structure("train_step", module, cost)
    return mid, dict(ops=len(module.all_ops()), custom_calls=bound,
                     collectives=len(module.collective_ops()),
                     seconds=time.perf_counter() - t0, **cost)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-125m",
                    help="model config (default xlstm-125m, as in the JAX "
                         "package; it runs none of the port's kernels: "
                         "the reference has none for the mLSTM and "
                         "sLSTM. qwen2-1.5b, hymba-1.5b, "
                         "granite-moe-1b-a400m, musicgen-large (on audio "
                         "frame embeddings) and yi-6b train through the "
                         "flash prefill kernel, hymba also through the "
                         "SSD scan)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh of D*M ranks "
                         "(one process per rank, as torchrun "
                         "--nproc-per-node starts them)")
    ap.add_argument("--strategy", default="tp",
                    choices=("tp", "fsdp", "dp_only"))
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from repro_torch.launch import mesh as mesh_mod
        shape_dm = tuple(int(n) for n in args.mesh.split("x"))
        mesh_mod.init_process(device=args.device)
        mesh = mesh_mod.make_mesh(shape_dm, ("data", "model"), args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    opts = T.ModelOptions(q_chunk=min(256, args.seq),
                          kv_chunk=min(256, args.seq),
                          ssm_chunk=min(128, args.seq),
                          loss_chunk=min(256, args.seq))
    t0 = time.monotonic()
    _, history, paths = train(
        cfg, shape, n_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, profile_dir=args.profile_dir,
        opts=opts, grad_compression=args.grad_compression, seed=args.seed,
        resume=args.resume, device=args.device, mesh=mesh,
        strategy=args.strategy)
    print(f"done in {time.monotonic() - t0:.1f}s; "
          f"final loss {history[-1]['loss']:.4f}")
    if paths:
        print(f"profiles: {sorted(paths)[:4]} ...")


if __name__ == "__main__":
    main()
