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

Sharded writes and elastic restore onto another mesh come with the
multi-device slice; every leaf here is one shard (``s0``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, map_with_paths

_NP_DTYPES = {torch.float32: "float32", torch.float16: "float16",
              torch.float64: "float64", torch.int64: "int64",
              torch.int32: "int32", torch.int16: "int16",
              torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_DTYPES.items()}


def _to_host(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(manifest dtype, host array) of a leaf; bf16 as 2-byte records."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view("V2")
    if t.dtype not in _NP_DTYPES:
        raise TypeError(f"checkpoint: no numpy dtype for {t.dtype}")
    return _NP_DTYPES[t.dtype], t.numpy()


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

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, block: bool = True,
             extra_meta: Optional[dict] = None) -> str:
        """Checkpoint a tree of tensors (nested dicts and NamedTuples).
        Returns the final directory."""
        self.wait()  # only one async save in flight
        records = []
        for path, leaf in leaves_with_paths(tree):
            name = ".".join(map(str, path))
            dtype, arr = _to_host(leaf)
            records.append((name, list(arr.shape), dtype, arr))
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"

        def write():
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": [],
                        "extra": extra_meta or {}}
            for name, shape, dtype, arr in records:
                fname = f"{name}.s0.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append({
                    "name": name, "shape": shape, "dtype": dtype,
                    "shards": [{"file": fname,
                                "index": [[0, d] for d in shape]}]})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

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
    def restore(self, tree_like: Any, *, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Restore into ``tree_like``'s structure: each leaf a tensor of
        the checkpoint's dtype on the device of ``tree_like``'s leaf of
        the same name, whose shape it must have.  ``step`` defaults to the
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
            buf = np.empty(shape, np.uint16 if entry["dtype"] == "bfloat16"
                           else np.dtype(entry["dtype"]))
            if entry["dtype"] == "bfloat16":
                buf = buf.view("V2")
            for s in entry["shards"]:
                arr = np.load(os.path.join(d, s["file"]), mmap_mode="r")
                buf[tuple(slice(a, b) for a, b in s["index"])] = arr
            out[name] = _from_file(buf, entry["dtype"]).to(like.device)
        return step, map_with_paths(
            lambda path, _: out[".".join(map(str, path))], tree_like)
