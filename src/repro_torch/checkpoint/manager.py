"""Atomic, async checkpointing of trees of tensors, in the JAX package's
on-disk layout (``repro/checkpoint/manager.py``).

- **Layout.**  ``<dir>/step_<N:08d>/manifest.json`` plus one
  ``<leaf>.s0.npy`` per leaf, named by its path in the tree (``params.
  layers.e0.attn.wq``, ``opt.mu.embed``, ``opt.step``: dict keys and the
  optimizer state's field names joined by dots, dict keys in sorted
  order), so a checkpoint written by the JAX manager on one device
  restores here, and the reverse for every leaf but bf16 ones (below).
- **Atomicity.**  A checkpoint is staged in ``step_<N>.tmp`` and renamed
  to ``step_<N>`` once every file and the manifest are written; restore
  only ever sees complete directories.
- **Async.**  ``save(..., block=False)`` copies every leaf to host memory
  (the only synchronous part) and writes in a background thread,
  overlapping the I/O with the next steps; ``wait`` joins it.
- **bfloat16.**  numpy has no bfloat16.  The JAX manager saves such a
  leaf through ``ml_dtypes`` as 2-byte void records (``|V2`` in the
  ``.npy`` header) with ``"dtype": "bfloat16"`` in the manifest; the port
  writes and reads the same raw 16-bit words (``ml_dtypes`` is not
  needed, and not imported).  The JAX manager's own ``restore`` cannot
  cast such records back (numpy has no cast from void), so a bf16 leaf
  goes from the JAX package to the port, not back.
- **Pipeline state.**  The data pipeline is a pure function of (seed,
  step, host), so the manifest's ``step`` is the whole pipeline state.
- **Sharded writes.**  A DTensor leaf (a tree sharded over a mesh of
  ranks) is written as its distinct blocks, ``<leaf>.s<k>.npy`` with k
  the block's place in the grid of its split axes, each with its index
  (``[[start, stop], ...]``) in the manifest, as the JAX manager writes a
  leaf's addressable shards.  Every rank writes the blocks it owns; a
  block replicated over some axes is written by the lowest rank holding
  it, and a whole (non-DTensor) leaf by rank 0.  The ranks meet at a
  barrier (a gloo group of the manager's own, so an async save's
  barriers never interleave with the step's collectives) before rank 0
  writes the manifest and renames, and again after.
- **Elastic restore.**  ``restore`` reads each target block from the
  files it intersects (memory-mapped), for any target: a DTensor leaf of
  ``tree_like`` (its mesh and placements, on any mesh), or a whole tensor
  on one process.  The JAX manager's sharded checkpoints restore here.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import types
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import shardmap_compat as smc
from repro_torch.tree import leaves_with_paths, map_with_paths

_NP_DTYPES = {torch.float32: "float32", torch.float16: "float16",
              torch.float64: "float64", torch.int64: "int64",
              torch.int32: "int32", torch.int16: "int16",
              torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a leaf's dtype."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    if dtype not in _NP_DTYPES:
        raise TypeError(f"checkpoint: no numpy dtype for {dtype}")
    return _NP_DTYPES[dtype]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf; bf16 as 2-byte records."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _blocks(leaf) -> Tuple[list, Optional[str]]:
    """([(suffix, index)] of every distinct block of a leaf, the suffix
    this rank writes or None).  A whole tensor is one block, written by
    rank 0."""
    shape = tuple(leaf.shape)
    whole = [("s0", tuple(slice(0, d) for d in shape))]
    if not isinstance(leaf, smc.DTensor):
        rank = dist.get_rank() if dist.is_initialized() else 0
        return whole, ("s0" if rank == 0 else None)
    dm = leaf.device_mesh
    names = dm.mesh_dim_names
    grid = types.SimpleNamespace(shape=dict(zip(names, dm.shape)))
    spec = smc.spec_of(leaf)
    split = smc.spec_axes(spec)
    split = tuple(a for a in names if a in split)
    mine = dict(zip(names, dm.get_coordinate()))
    out, me = [], None
    for k, cs in enumerate(itertools.product(
            *(range(grid.shape[a]) for a in split))):
        coords = {a: 0 for a in names}
        coords.update(zip(split, cs))
        out.append((f"s{k}", smc.local_slices(shape, spec, grid, coords)))
        if all(mine[a] == (coords[a] if a in split else 0) for a in names):
            me = f"s{k}"
    return out, me


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor of the manifest's dtype from a host array."""
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint: a bfloat16 leaf holds "
                             f"{arr.dtype} records")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=True))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._group = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, block: bool = True,
             extra_meta: Optional[dict] = None) -> str:
        """Checkpoint a tree of tensors (nested dicts and NamedTuples;
        DTensor leaves are written by block).  In a world of several
        ranks every rank calls ``save``.  Returns the final directory."""
        self.wait()  # only one async save in flight
        records = []
        for path, leaf in leaves_with_paths(tree):
            name = ".".join(map(str, path))
            blocks, me = _blocks(leaf)
            arr = None
            if me is not None:
                arr = _to_host(smc.local(leaf))
            records.append((name, list(leaf.shape), _dtype_name(leaf.dtype),
                            blocks, me, arr))
        ranks = dist.is_initialized() and dist.get_world_size() > 1
        if ranks and self._group is None:
            self._group = dist.new_group(backend="gloo")
        lead = not ranks or dist.get_rank() == 0
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"

        def barrier():
            if ranks:
                dist.barrier(group=self._group)

        def write():
            if lead:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
            barrier()
            manifest = {"step": step, "leaves": [],
                        "extra": extra_meta or {}}
            for name, shape, dtype, blocks, me, arr in records:
                if me is not None:
                    np.save(os.path.join(tmp, f"{name}.{me}.npy"), arr)
                manifest["leaves"].append({
                    "name": name, "shape": shape, "dtype": dtype,
                    "shards": [{"file": f"{name}.{k}.npy",
                                "index": [[x.start, x.stop] for x in idx]}
                               for k, idx in blocks]})
            barrier()
            if lead:
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic publish
                self._gc()
            barrier()

        if block:
            write()
        else:
            def run():
                try:
                    write()
                except Exception as e:   # re-raised by wait()
                    self._error = e
            self._pending = threading.Thread(target=run, daemon=True,
                                             name="repro-ckpt")
            self._pending.start()
        return final

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> List[int]:
        return sorted(int(d[5:]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    def restore(self, tree_like: Any, *,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into ``tree_like``'s structure, onto any target layout:
        a DTensor leaf of ``tree_like`` gives a DTensor of its mesh and
        placements, any other leaf a whole tensor.  Each leaf has the
        checkpoint's dtype, the device of ``tree_like``'s leaf of the same
        name and must have its (global) shape.  ``step`` defaults to the
        latest.  Returns (step, restored tree)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        out = {}
        for path, like in leaves_with_paths(tree_like):
            name = ".".join(map(str, path))
            entry = by_name[name]
            shape = tuple(entry["shape"])
            if tuple(like.shape) != shape:
                raise ValueError(f"checkpoint leaf {name}: shape {shape}, "
                                 f"the tree wants {tuple(like.shape)}")
            if isinstance(like, smc.DTensor):
                dm = like.device_mesh
                grid = types.SimpleNamespace(
                    shape=dict(zip(dm.mesh_dim_names, dm.shape)))
                index = smc.local_slices(
                    shape, smc.spec_of(like), grid,
                    dict(zip(dm.mesh_dim_names, dm.get_coordinate())))
                out[name] = smc.like(like, _read(d, entry, index)
                                     .to(like.device))
            else:
                out[name] = _read(d, entry, tuple(
                    slice(0, n) for n in shape)).to(like.device)
        return step, map_with_paths(
            lambda path, _: out[".".join(map(str, path))], tree_like)


def _read(d: str, entry: dict, index: tuple) -> torch.Tensor:
    """The block ``index`` of a leaf from the shard files it intersects."""
    bf16 = entry["dtype"] == "bfloat16"
    buf = np.empty([s.stop - s.start for s in index],
                   np.uint16 if bf16 else np.dtype(entry["dtype"]))
    if bf16:
        buf = buf.view("V2")
    for s in entry["shards"]:
        src = tuple(slice(a, b) for a, b in s["index"])
        inter = []
        for tgt, sr in zip(index, src):
            lo, hi = max(tgt.start, sr.start), min(tgt.stop, sr.stop)
            if lo >= hi:
                break
            inter.append((lo, hi, tgt.start, sr.start))
        else:
            arr = np.load(os.path.join(d, s["file"]), mmap_mode="r")
            if not index:
                buf = np.array(arr).reshape(buf.shape)
                continue
            buf[tuple(slice(lo - t0, hi - t0) for lo, hi, t0, _ in inter)] \
                = arr[tuple(slice(lo - s0, hi - s0)
                            for lo, hi, _, s0 in inter)]
    return _from_file(buf, entry["dtype"])
