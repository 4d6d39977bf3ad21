"""On-disk sparse profile format (paper §4.6, Fig. 3b).

Each profile file has the sections the paper describes:

- **Load Modules** — libraries / compiled HLO modules seen in execution;
- **CCT**          — tree structure: per node (id, parent, frame);
- **Metrics**      — index + name (+ properties) of every metric;
- **Metric Values** and **CCT Metric Values** — only non-zero values: a node
  with index range [I, I+N) owns positions I..I+N-1 of Metric Values.

plus a string table and a small identity header (the (node, rank, thread,
stream) tuple of §7).  Everything little-endian, numpy-readable so the
aggregator can stream values without materializing objects.
"""
from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cct import CCT, CCTNode, Frame
from repro_torch.core.metrics import MetricRegistry

MAGIC = b"RPRO"
VERSION = 2

_FRAME_KINDS = ("root", "host", "placeholder", "gpu_op", "gpu_func",
                "gpu_loop")
_KIND_IDX = {k: i for i, k in enumerate(_FRAME_KINDS)}

# public aliases: the aggregator's batched frame interning keys frames by
# (kind idx, name, module, line) and needs the same kind numbering
FRAME_KINDS = _FRAME_KINDS
FRAME_KIND_IDX = _KIND_IDX


class _StringTable:
    def __init__(self):
        self._idx: Dict[str, int] = {}
        self.strings: List[str] = []

    def intern(self, s: str) -> int:
        i = self._idx.get(s)
        if i is None:
            i = len(self.strings)
            self._idx[s] = i
            self.strings.append(s)
        return i


def write_profile(path: str, cct: CCT, registry: MetricRegistry,
                  identity: Dict[str, object],
                  load_modules: Optional[List[str]] = None) -> Dict[str, int]:
    """Writes one profile.  Returns section byte sizes (for §8.2 size
    accounting)."""
    strings = _StringTable()
    nodes = cct.nodes()

    # --- CCT section ------------------------------------------------------
    cct_rows = np.zeros((len(nodes), 5), np.int64)
    for i, n in enumerate(nodes):
        cct_rows[i] = (
            n.node_id,
            n.parent.node_id if n.parent is not None else -1,
            _KIND_IDX[n.frame.kind],
            (strings.intern(n.frame.name) << 32)
            | strings.intern(n.frame.module),
            n.frame.line,
        )

    # --- sparse metric values (Fig. 3b) ------------------------------------
    mids: List[int] = []
    vals: List[float] = []
    node_ranges: List[Tuple[int, int, int]] = []   # (node_id, start, count)
    for n in nodes:
        if n.metrics.empty:
            continue
        start = len(mids)
        for gid, v in n.metrics.nonzero_items(registry):
            mids.append(gid)
            vals.append(v)
        count = len(mids) - start
        if count:
            node_ranges.append((n.node_id, start, count))

    header = {
        "identity": identity,
        "n_nodes": len(nodes),
        "n_values": len(vals),
        "metrics": registry.metric_names,
        "load_modules": load_modules or [],
    }

    sizes: Dict[str, int] = {}
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", VERSION))
        hdr = json.dumps(header).encode()
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        sizes["header"] = len(hdr) + 12

        def section(name: str, arr: np.ndarray):
            data = arr.tobytes()
            f.write(struct.pack("<I", len(data)))
            f.write(data)
            sizes[name] = len(data) + 4

        section("cct", cct_rows)
        section("mids", np.asarray(mids, np.uint32))
        section("vals", np.asarray(vals, np.float64))
        section("ranges", np.asarray(node_ranges, np.int64).reshape(-1, 3))
        blob = json.dumps(strings.strings).encode()
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        sizes["strings"] = len(blob) + 4
    return sizes


@dataclasses.dataclass
class ProfileData:
    identity: Dict[str, object]
    metrics: List[str]
    load_modules: List[str]
    node_ids: np.ndarray        # (N,)
    parents: np.ndarray         # (N,)
    frames: List[Frame]         # per node
    value_mids: np.ndarray      # (V,) uint32 global metric ids
    values: np.ndarray          # (V,) float64
    ranges: np.ndarray          # (R, 3) node_id, start, count
    # raw frame keys, parallel to ``frames`` — lets the aggregator intern
    # frames with array-level gathers over the profile string table instead
    # of hashing Frame objects per node (None on hand-built ProfileData)
    frame_kinds: Optional[np.ndarray] = None    # (N,) kind index
    frame_name_sids: Optional[np.ndarray] = None  # (N,) local string id
    frame_mod_sids: Optional[np.ndarray] = None   # (N,) local string id
    frame_lines: Optional[np.ndarray] = None    # (N,)
    strings: Optional[List[str]] = None         # local string table

    def node_values(self, node_id: int) -> Dict[int, float]:
        row = self.ranges[self.ranges[:, 0] == node_id]
        if len(row) == 0:
            return {}
        _, start, count = row[0]
        return {int(m): float(v)
                for m, v in zip(self.value_mids[start:start + count],
                                self.values[start:start + count])}

    def dense_matrix(self, n_metrics: int) -> np.ndarray:
        """(n_nodes, n_metrics) dense expansion — for the §8.2 comparison."""
        out = np.zeros((len(self.node_ids), n_metrics), np.float64)
        idx_of = {int(n): i for i, n in enumerate(self.node_ids)}
        for nid, start, count in self.ranges:
            i = idx_of[int(nid)]
            out[i, self.value_mids[start:start + count]] = \
                self.values[start:start + count]
        return out


def read_profile(path: str) -> ProfileData:
    with open(path, "rb") as f:
        magic = f.read(4)
        assert magic == MAGIC, f"bad magic in {path}"
        (version,) = struct.unpack("<I", f.read(4))
        assert version == VERSION
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))

        def section(dtype, cols=None):
            (n,) = struct.unpack("<I", f.read(4))
            arr = np.frombuffer(f.read(n), dtype)
            return arr.reshape(-1, cols) if cols else arr

        cct_rows = section(np.int64, 5)
        mids = section(np.uint32)
        vals = section(np.float64)
        ranges = section(np.int64, 3)
        (slen,) = struct.unpack("<I", f.read(4))
        strings = json.loads(f.read(slen))

    packed = cct_rows[:, 3]
    name_sids = (packed >> 32).astype(np.int64)
    mod_sids = (packed & 0xFFFFFFFF).astype(np.int64)
    frames = [Frame(_FRAME_KINDS[k], strings[n], strings[m], ln)
              for k, n, m, ln in zip(cct_rows[:, 2].tolist(),
                                     name_sids.tolist(), mod_sids.tolist(),
                                     cct_rows[:, 4].tolist())]
    return ProfileData(
        identity=header["identity"],
        metrics=header["metrics"],
        load_modules=header["load_modules"],
        node_ids=cct_rows[:, 0].copy(),
        parents=cct_rows[:, 1].copy(),
        frames=frames,
        value_mids=mids.copy(),
        values=vals.copy(),
        ranges=ranges.copy(),
        frame_kinds=cct_rows[:, 2].copy(),
        frame_name_sids=name_sids,
        frame_mod_sids=mod_sids,
        frame_lines=cct_rows[:, 4].copy(),
        strings=strings,
    )


def dense_profile_nbytes(n_nodes: int, n_metrics: int) -> int:
    """Size the original dense format would need (§8.2 comparison)."""
    return n_nodes * n_metrics * 8
