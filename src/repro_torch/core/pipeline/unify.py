"""Phase 2 — call-path unification (paper §6.1) + canonical renumbering.

Each rank unifies its profiles' CCTs into a rank-local tree; rank trees
merge up a reduction tree to the root, yielding the global calling
context tree and a local->global id mapping per profile.  The tree is
then renumbered into **canonical** BFS/frame-key order
(``canonical_order``), the heart of the canonical-database contract
(docs/aggregation.md): database bytes become a pure function of the
profile set, independent of ``n_ranks`` / ``n_threads`` / path order —
which is what makes shard databases composable (``repro.core.merge``)
and the parallel shard driver byte-identical by construction
(``pipeline.driver``).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cct import Frame, GPU_OP, tree_depths
from repro_torch.core.pipeline.acquire import Acquisition
from repro_torch.core.pipeline.contracts import UnifiedProfile, Unification
from repro_torch.core.profmt import FRAME_KIND_IDX, ProfileData, read_profile

_GPU_OP_KIND = FRAME_KIND_IDX[GPU_OP]


# --------------------------------------------------------------------------
# Global tree under construction
# --------------------------------------------------------------------------
class GlobalTree:
    """Global CCT built by merging per-profile trees.

    Frames are interned into an integer id table (strings interned once,
    then a frame is a (kind, name id, module id, line) key), and children
    are resolved through a dict keyed by the packed integer
    ``(parent << 32) | frame_id`` — per-node tuple/Frame hashing is off the
    hot path entirely; ``merge_paths`` computes each profile's frame ids
    with array-level gathers over the profile's string table.
    """

    def __init__(self):
        self.frames: List[Frame] = [Frame("root", "<program root>")]
        self.parents: List[int] = [-1]
        self._children: Dict[int, int] = {}      # (parent<<32)|fid -> gid
        self._strings: Dict[str, int] = {}       # string intern table
        self._key_fids: Dict[Tuple[int, int, int, int], int] = {}
        self._frame_of_fid: List[Frame] = []     # fid -> canonical Frame
        self._frame_cache: Dict[Frame, int] = {}  # fast path for child()

    # -- interning ----------------------------------------------------------
    def _intern_string(self, s: str) -> int:
        i = self._strings.get(s)
        if i is None:
            i = len(self._strings)
            self._strings[s] = i
        return i

    def _fid_for_key(self, key: Tuple[int, int, int, int],
                     frame: Frame) -> int:
        fid = self._key_fids.get(key)
        if fid is None:
            fid = len(self._frame_of_fid)
            self._key_fids[key] = fid
            self._frame_of_fid.append(frame)
        return fid

    def intern_frame(self, frame: Frame) -> int:
        fid = self._frame_cache.get(frame)
        if fid is None:
            kind = FRAME_KIND_IDX.get(frame.kind)
            if kind is None:   # kinds outside the profile format's table
                kind = -2 - self._intern_string(frame.kind)
            key = (kind, self._intern_string(frame.name),
                   self._intern_string(frame.module), int(frame.line))
            fid = self._fid_for_key(key, frame)
            self._frame_cache[frame] = fid
        return fid

    # -- tree construction ---------------------------------------------------
    def _child_fid(self, parent: int, fid: int) -> int:
        key = (parent << 32) | fid
        gid = self._children.get(key)
        if gid is None:
            gid = len(self.frames)
            self.frames.append(self._frame_of_fid[fid])
            self.parents.append(parent)
            self._children[key] = gid
        return gid

    def child(self, parent: int, frame: Frame) -> int:
        return self._child_fid(parent, self.intern_frame(frame))

    def _profile_fids(self, prof: ProfileData) -> np.ndarray:
        """Per-node global frame ids, resolved with one dict lookup per
        *unique* frame (array-level dedup) instead of one per node."""
        if prof.frame_kinds is None:
            return np.fromiter((self.intern_frame(f) for f in prof.frames),
                               np.int64, len(prof.frames))
        gsid = np.fromiter((self._intern_string(s) for s in prof.strings),
                           np.int64, len(prof.strings)) \
            if prof.strings else np.zeros(0, np.int64)
        rows = np.stack([prof.frame_kinds,
                         gsid[prof.frame_name_sids],
                         gsid[prof.frame_mod_sids],
                         prof.frame_lines], axis=1)
        uniq, first, inv = np.unique(rows, axis=0, return_index=True,
                                     return_inverse=True)
        fids_u = np.empty(len(uniq), np.int64)
        for j in range(len(uniq)):
            r = uniq[j]
            fids_u[j] = self._fid_for_key(
                (int(r[0]), int(r[1]), int(r[2]), int(r[3])),
                prof.frames[int(first[j])])
        return fids_u[inv.ravel()]

    def merge_paths(self, prof: ProfileData,
                    expand=None) -> np.ndarray:
        """Insert one profile's tree; returns local node id -> global id."""
        n = len(prof.node_ids)
        local_to_global = np.zeros(int(prof.node_ids.max()) + 1 if n else 1,
                                   np.int64)
        fids = self._profile_fids(prof).tolist()
        node_ids = prof.node_ids.tolist()
        parents = prof.parents.tolist()
        is_gpu = (prof.frame_kinds == _GPU_OP_KIND).tolist() \
            if (expand is not None and prof.frame_kinds is not None) else None
        l2g = local_to_global.tolist()
        children = self._children
        frames_out, parents_out = self.frames, self.parents
        frame_of_fid = self._frame_of_fid
        # profiles store nodes in creation order: parents precede children
        for i in range(n):
            par = parents[i]
            if par < 0:
                l2g[node_ids[i]] = 0
                continue
            gpar = l2g[par]
            if expand is not None and (
                    is_gpu[i] if is_gpu is not None
                    else prof.frames[i].kind == GPU_OP):
                for f in expand(prof.frames[i], prof):
                    gpar = self.child(gpar, f)
                l2g[node_ids[i]] = gpar
                continue
            key = (gpar << 32) | fids[i]
            gid = children.get(key)
            if gid is None:
                gid = len(frames_out)
                frames_out.append(frame_of_fid[fids[i]])
                parents_out.append(gpar)
                children[key] = gid
            l2g[node_ids[i]] = gid
        local_to_global[:] = l2g
        return local_to_global

    def merge_tree(self, other: "GlobalTree") -> np.ndarray:
        """Merge another tree into this one (reduction-tree step),
        vectorized.

        Bitwise-identical to ``merge_tree_reference`` (pinned in
        tests/test_merge_tree_vector.py) by this argument: within one
        merge the children keys ``(mapped_parent << 32) | fid`` are
        globally unique (the mapping is injective by induction on
        depth), so whether a node hits an existing child or misses is
        independent of visit order, and any child of a missing parent
        must itself miss — its key's parent id is >= the pre-merge node
        count, which no existing key contains.  That lets the merge run
        as three batch phases instead of one dict transaction per node:

        A. classify hit/miss level-by-level (dict lookups only for
           nodes whose parent hit);
        B. number the misses ``base + rank`` in gid order — exactly the
           ids the sequential loop hands out;
        C. batch-append frames/parents and bulk-update the children
           index with the final ids.
        """
        n = len(other.frames)
        mapping = np.zeros(n, np.int64)
        if n <= 1:
            return mapping
        parents = np.asarray(other.parents, np.int64)
        # per-node global frame ids (index 0 unused: the roots align)
        fids = np.zeros(n, np.int64)
        frames = other.frames
        intern = self.intern_frame
        for gid in range(1, n):
            fids[gid] = intern(frames[gid])
        children = self._children
        depth = tree_depths(parents)
        is_miss = np.zeros(n, bool)
        for lvl in range(1, int(depth.max()) + 1):
            idx = np.nonzero(depth == lvl)[0]
            par_miss = is_miss[parents[idx]]
            is_miss[idx[par_miss]] = True       # miss parent -> miss child
            cand = idx[~par_miss]
            keys = ((mapping[parents[cand]] << 32) | fids[cand]).tolist()
            got = np.fromiter((children.get(k, -1) for k in keys),
                              np.int64, len(cand))
            hit = got >= 0
            mapping[cand[hit]] = got[hit]
            is_miss[cand[~hit]] = True
        miss = np.nonzero(is_miss)[0]           # gid order == visit order
        if len(miss):
            base = len(self.frames)
            mapping[miss] = base + np.arange(len(miss))
            new_parents = mapping[parents[miss]]
            fof = self._frame_of_fid
            self.frames.extend(fof[int(f)] for f in fids[miss])
            self.parents.extend(new_parents.tolist())
            children.update(zip(
                ((new_parents << 32) | fids[miss]).tolist(),
                mapping[miss].tolist()))
        return mapping

    def merge_tree_reference(self, other: "GlobalTree") -> np.ndarray:
        """The sequential merge loop ``merge_tree`` vectorizes; kept as
        the equivalence oracle (tests assert bitwise-equal trees and
        mappings between the two on randomized inputs)."""
        mapping = np.zeros(len(other.frames), np.int64)
        m = mapping.tolist()
        other_parents = other.parents
        for gid in range(1, len(other.frames)):
            m[gid] = self.child(m[other_parents[gid]], other.frames[gid])
        mapping[:] = m
        return mapping

    def topo_order(self) -> np.ndarray:
        return np.arange(len(self.frames))  # creation order is topological

    def depths(self) -> np.ndarray:
        """Per-node depth (root = 0), see ``cct.tree_depths``."""
        return tree_depths(self.parents)


# --------------------------------------------------------------------------
# Canonicalization: the database-bytes-are-a-pure-function contract
# --------------------------------------------------------------------------
def canonical_order(frames: List[Frame], parents) -> np.ndarray:
    """Old context id -> canonical id.

    Canonical numbering is a BFS of the tree with each node's children
    visited in sorted frame-key order ``(kind, name, module, line)`` —
    a pure function of the tree's *shape*, independent of the insertion
    order that built it.  Properties the pipeline relies on:

    - topological: a parent's canonical id precedes all its children's
      (so the reverse-id / level-order inclusive sweeps stay valid);
    - the relative order of any two children of one parent is decided by
      frame-key comparison alone, so it is identical in every tree that
      contains both — per-profile inclusive values come out bitwise
      identical whether a profile is aggregated inside a shard or inside
      the full union (the heart of the ``merge_databases`` byte-identity
      contract, docs/aggregation.md);
    - restriction-stable: dropping an ancestor-closed subset of nodes
      (retention, ``repro.core.retention``) and compressing ids
      preserves canonical order, because the numbering is lexicographic
      in (depth, parent id, frame key) and all three survive the
      restriction unchanged.
    """
    n = len(frames)
    parents = np.asarray(parents, np.int64)
    key_rank = {k: i for i, k in enumerate(sorted(
        {(f.kind, f.name, f.module, f.line) for f in frames}))}
    frank = np.fromiter(
        (key_rank[(f.kind, f.name, f.module, f.line)] for f in frames),
        np.int64, n)
    depth = tree_depths(parents)
    new_id = np.zeros(n, np.int64)
    done = 1                       # root keeps id 0
    for lvl in range(1, int(depth.max()) + 1 if n > 1 else 1):
        idx = np.nonzero(depth == lvl)[0]
        if len(idx) == 0:
            break
        order = np.lexsort((frank[idx], new_id[parents[idx]]))
        new_id[idx[order]] = np.arange(done, done + len(idx))
        done += len(idx)
    return new_id


def apply_order(frames: List[Frame], parents, new_id: np.ndarray
                ) -> Tuple[List[Frame], np.ndarray]:
    """Permute a (frames, parents) tree by an old->new id map."""
    parents = np.asarray(parents, np.int64)
    frames_c: List[Frame] = list(frames)
    for old, new in enumerate(new_id.tolist()):
        frames_c[new] = frames[old]
    parents_c = np.full(len(frames), -1, np.int64)
    has_par = parents >= 0
    parents_c[new_id[has_par]] = new_id[parents[has_par]]
    return frames_c, parents_c


# --------------------------------------------------------------------------
# The phase-2 stage
# --------------------------------------------------------------------------
def unify(acq: Acquisition, *, n_threads: int = 4,
          expand=None) -> Unification:
    """Unify every rank's profiles and canonicalize the global tree.

    Threads are the dynamic per-thread tasks inside a rank; rank trees
    fold into the root rank's tree (the hpcprof-mpi reduction step),
    and every profile's local->global map is composed with the rank
    conversion and the canonical renumbering, so downstream stages only
    ever see canonical ctx ids.
    """
    t0 = time.monotonic()

    def unify_rank(paths: Sequence[str]):
        tree = GlobalTree()
        profs: List[Tuple[str, ProfileData, np.ndarray]] = []

        def load(path):
            return path, read_profile(path)
        with ThreadPoolExecutor(max(1, n_threads)) as ex:
            loaded = list(ex.map(load, paths))
        for path, prof in loaded:
            mapping = tree.merge_paths(prof, expand)
            profs.append((path, prof, mapping))
        return tree, profs

    with ThreadPoolExecutor(max(1, len(acq.rank_paths))) as ex:
        rank_results = list(ex.map(unify_rank, acq.rank_paths))

    # reduction tree (arity = n_threads) to the root rank
    trees = [r[0] for r in rank_results]
    mappings: List[Optional[np.ndarray]] = [None] * len(trees)
    root = trees[0]
    for i in range(1, len(trees)):
        mappings[i] = root.merge_tree(trees[i])

    # canonical context renumbering: database ids are a pure function of
    # the profile set, independent of n_ranks / path order (merge contract)
    new_id = canonical_order(root.frames, root.parents)
    frames_c, parents_c = apply_order(root.frames, root.parents, new_id)

    # broadcast: convert each profile's local->rank mapping to ->canonical
    profiles: List[UnifiedProfile] = []
    for r, (tree, profs) in enumerate(rank_results):
        conv = mappings[r]
        for path, prof, mapping in profs:
            gmap = mapping if conv is None else conv[mapping]
            profiles.append(UnifiedProfile(path, prof, new_id[gmap]))

    return Unification(frames_c, parents_c, profiles,
                       unify_s=time.monotonic() - t0)
