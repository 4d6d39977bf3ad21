"""Fine-grained measurement — the PC-sampling analogue (paper §4.2).

NVIDIA GPUs expose hardware PC sampling (instruction address + stall reason
+ count).  TPUs expose no public equivalent, so we adapt (DESIGN.md §2): the
"instruction" is an HLO op inside the compiled module, the sampling weight
is the op's roofline-model time, and the *stall reason* analogue is the
op's dominant bound class:

    stall_compute    — MXU/VPU-bound (flops term dominates)
    stall_memory     — HBM-bound (bytes term dominates)
    stall_collective — ICI-bound (collective term dominates)

The attribution machinery downstream of the sample source (samples ->
activity records -> CCT nodes under the kernel placeholder -> lines/loops
via structure info) is exactly the paper's.  On real TPUs the same
``Sample`` records could be filled from XProf/XPlane device traces instead.

The GT-Pin instrumentation path (§4.2's second mode) is the *exact* op
count: ``instrument=True`` emits one record per op with its true executed
count (1, or trip count inside while bodies) instead of sampled counts.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.structure import HloModule, HloOp

# NVIDIA H100 SXM5 constants (NVIDIA H100 Tensor Core GPU data sheet,
# dense rates without sparsity, at the full 700 W power limit)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
ICI_BW = 450e9               # NVLink bytes/s per card, each way

STALL_CLASSES = ("compute", "memory", "collective")

# budgets at or below this draw as n categorical samples (inverse CDF)
# instead of one multinomial — see draw_samples
_SMALL_DRAW = 32


@dataclasses.dataclass(slots=True)
class Sample:
    op_index: int            # index of the op within the module
    stall: str               # one of STALL_CLASSES
    count: int
    leaf: int = -1           # kernel-interior leaf index (kstruct), or -1


def op_time_model(op: HloOp) -> Dict[str, float]:
    """Roofline time terms for one op (seconds)."""
    tc = op.flops / PEAK_FLOPS
    tm = op.bytes / HBM_BW
    tcoll = 0.0
    if op.is_collective:
        g = max(op.group_size, 1)
        tcoll = op.bytes * 2.0 * (g - 1) / g / ICI_BW
    return {"compute": tc, "memory": tm, "collective": tcoll}


# pseudo-ops that are not executed instructions (never sampled)
_NON_INST = frozenset({"parameter", "constant", "get-tuple-element", "tuple",
                       "bitcast", "after-all", "partition-id", "replica-id"})


def op_weights(module: HloModule) -> "np.ndarray":
    """(n_ops,) expected-time weights + (n_ops,) stall class indices.

    Cached on the module — recomputing per dispatch dominated tool overhead
    (bench_overhead: 4.1x -> ~2x after caching; EXPERIMENTS.md §Perf)."""
    cached = getattr(module, "_op_weights_cache", None)
    if cached is not None:
        return cached
    ops = module.all_ops()
    kstructs = module.kernel_structures() \
        if hasattr(module, "kernel_structures") else {}
    w = np.zeros(len(ops))
    stall = np.zeros(len(ops), np.int32)
    for i, op in enumerate(ops):
        if op.opcode in _NON_INST:
            continue
        t = op_time_model(op)
        ks = kstructs.get(op.index)
        if ks is not None:
            # a bound Pallas kernel parses as an opaque custom-call with
            # flops=0; its recovered interior structure supplies the
            # modeled compute/memory terms instead
            t["compute"] = max(t["compute"], ks.total_flops / PEAK_FLOPS)
            t["memory"] = max(t["memory"], ks.total_bytes / HBM_BW)
        w[i] = max(t.values())
        stall[i] = int(np.argmax([t["compute"], t["memory"],
                                  t["collective"]]))
    module._op_weights_cache = (w, stall)
    return w, stall


def sample_budget(duration_s: float, rate_hz: float,
                  cap: Optional[int] = None) -> int:
    """The per-dispatch sample count for one kernel execution — the
    cheap integer math the dispatch path computes inline before
    deferring the draw itself to the monitor thread (``draw_samples``).
    At least one sample is always budgeted (the never-off contract)."""
    n = max(1, int(duration_s * rate_hz))
    if cap is not None:
        n = max(1, min(n, int(cap)))
    return n


def pc_samples(module: HloModule, duration_s: float,
               rate_hz: float = 1e6, rng: Optional[np.random.Generator] = None,
               cap: Optional[int] = None) -> List[Sample]:
    """Draw PC samples for one kernel execution of ``duration_s``.

    Expected total samples = duration * rate; distributed over ops
    proportionally to modeled op time (multinomial when rng given,
    deterministic expectation rounding otherwise).  ``cap`` bounds the
    samples drawn for this one execution — the serving governor's
    per-dispatch throttle (repro.serving.governor); at least one sample
    is always drawn, so fine-grained attribution never fully stops.

    This is ``sample_budget`` + ``draw_samples``; the profiler's
    deferred path calls the two halves from different threads.
    """
    return draw_samples(module, sample_budget(duration_s, rate_hz, cap),
                        rng)


def draw_samples(module: HloModule, n: int,
                 rng: Optional[np.random.Generator] = None) -> List[Sample]:
    """Distribute exactly-budgeted ``n`` samples over the module's ops
    (the draw core of ``pc_samples``).  Runs on the monitor thread in
    the deferred path: the ``w/total_w`` lookups are cached on the
    module, so consecutive dispatches of the same module amortize to
    the multinomial itself."""
    ops = module.all_ops()
    if not ops:
        return []
    w, stall = op_weights(module)
    # normalized weights cached with the module: the division is O(ops)
    p = getattr(module, "_op_p_cache", None)
    if p is None:
        total_w = w.sum()
        p = w / total_w if total_w > 0 else None
        module._op_p_cache = p
    if p is None:
        return []
    counts = None
    items = None
    if rng is not None:
        if n <= _SMALL_DRAW:
            # n independent categorical draws by inverse CDF — the same
            # distribution as multinomial(n, p) but ~4x cheaper at the
            # small per-dispatch budgets the governor runs (the deferred
            # path pays this per dispatch on the monitor thread).  Pure
            # python (bisect over a cached cdf list): at budget ~1 the
            # numpy searchsorted/bincount/nonzero round-trips dominated
            # the draw.  bisect_right == searchsorted(side="right") on
            # the same float64 values, so the drawn ops are identical.
            cdf_list = getattr(module, "_op_cdf_list_cache", None)
            if cdf_list is None:
                cdf = np.cumsum(p)
                cdf[-1] = 1.0           # guard fp drift: u < 1 always lands
                module._op_cdf_cache = cdf
                cdf_list = cdf.tolist()
                module._op_cdf_list_cache = cdf_list
            cnt: Dict[int, int] = {}
            for u in rng.random(n).tolist():
                i = bisect.bisect_right(cdf_list, u)
                cnt[i] = cnt.get(i, 0) + 1
            items = sorted(cnt.items())
        else:
            counts = rng.multinomial(n, p)
    else:
        counts = np.floor(n * p + 0.5).astype(np.int64)
        if counts.sum() == 0:
            # expectation rounding can floor *every* op to zero when the
            # governor cap forces n=1 and weights are spread thin across
            # many ops (max p < 0.5) — the documented guarantee is that
            # at least one sample is always drawn, attributed to the
            # heaviest op
            counts[int(np.argmax(p))] = 1
    # touch only the ops that drew samples: with the governor capping n
    # far below the op count, the per-dispatch draw cost must be
    # O(samples), not O(module ops)
    if items is None:
        items = [(int(i), int(counts[i])) for i in np.nonzero(counts)[0]]
    kstructs = module.kernel_structures() \
        if hasattr(module, "kernel_structures") else {}
    out: List[Sample] = []
    for i, c in items:
        op = ops[i]
        ks = kstructs.get(op.index)
        if ks is None:
            out.append(Sample(op_index=op.index,
                              stall=STALL_CLASSES[stall[i]], count=c))
            continue
        # two-level draw (§7): the op's samples descend into the bound
        # kernel-interior structure, apportioned over leaves by modeled
        # leaf weight — exactly ``c`` samples total, so the governor's
        # per-dispatch cap survives the descent unchanged
        for leaf, lc in ks.distribute(c, rng):
            out.append(Sample(op_index=op.index,
                              stall=ks.leaves[leaf].stall, count=lc,
                              leaf=leaf))
    return out


_MASK48 = (1 << 48) - 1
_MASK64 = (1 << 64) - 1

# splitmix64 constants (vectorized counter-hash uniforms)
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_INV53 = 1.0 / (1 << 53)


def _mix64(z: int) -> int:
    """One splitmix64 finalizer round over python ints (64-bit wrap)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return z ^ (z >> 31)


class DispatchStream:
    """One dispatch's deterministic random stream, duck-typed to the
    slice of the Generator API the draw uses (``random``,
    ``multinomial``).

    Small draws — the per-dispatch budgets the governor actually runs —
    come from a counter-mode splitmix64 hash of the dispatch key, a few
    integer ops per value; re-keying the Philox generator costs ~7us in
    numpy state plumbing, which dominated the whole deferred draw.  The
    real keyed Generator is materialized lazily only for draws above
    ``_SMALL_DRAW``, where a kernel ran long enough that the multinomial
    amortizes.  Values are a pure function of (seed, lane, seq, draw
    position) either way — drain-order invariant.

    One mutable instance per KeyedRng, re-keyed per record (monitor
    thread only); never hold one across records."""

    __slots__ = ("_owner", "_key", "_pos", "_lane", "_seq", "_gen")

    def __init__(self, owner: "KeyedRng"):
        self._owner = owner

    def rekey(self, lane: int, seq: int) -> None:
        # _mix64(seed ^ _mix64(k2 + GOLDEN)), both rounds inlined: this
        # runs once per drained activity record
        z = ((((lane & 0xFFFF) << 48) | (seq & _MASK48)) + _GOLDEN) \
            & _MASK64
        z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
        z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
        z = self._owner._seed ^ z ^ (z >> 31)
        z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
        z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
        self._key = z ^ (z >> 31)
        self._pos = 0
        self._lane = lane
        self._seq = seq
        self._gen = None

    def random(self, n: int = 1):
        """n uniforms in [0, 1), consumed from the stream position."""
        pos = self._pos
        self._pos = pos + n
        if n == 1:
            out = np.empty(1)
            out[0] = (_mix64(self._key + (pos + 1) * _GOLDEN)
                      >> 11) * _INV53
            return out
        idx = np.arange(pos + 1, pos + n + 1, dtype=np.uint64)
        z = np.uint64(self._key) + idx * np.uint64(_GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_MIX2)
        z ^= z >> np.uint64(31)
        return (z >> np.uint64(11)).astype(np.float64) * _INV53

    def multinomial(self, n: int, p) -> np.ndarray:
        n = int(n)
        if n <= _SMALL_DRAW:
            cdf = np.cumsum(p)
            cdf[-1] = 1.0
            idx = cdf.searchsorted(self.random(n), side="right")
            return np.bincount(idx, minlength=len(p))
        if self._gen is None:
            self._gen = self._owner.keyed(self._lane, self._seq)
        return self._gen.multinomial(n, p)


class KeyedRng:
    """Deterministic per-dispatch generator streams for the deferred
    PC-sample draw.

    The legacy inline path consumed one shared ``default_rng(seed)`` in
    dispatch order, so the drawn values depended on the order draws
    happened to run — unacceptable once the draw moves off-thread,
    where drain batching would permute it.  ``keyed(lane, seq)``
    instead re-keys a single Philox bit generator to the 128-bit key
    ``(seed, lane << 48 | seq)`` — ``lane`` the dispatching thread's
    stable index, ``seq`` its per-thread dispatch sequence number — so
    every dispatch owns an independent counter-mode stream and the
    draw is a pure function of (seed, lane, seq), invariant under any
    drain order or batch split.

    Re-keying swaps the bit-generator state in place instead of
    constructing ``Generator(Philox(key=...))`` per dispatch (~4x
    cheaper; the states are bit-identical to fresh construction, which
    ``tests/test_dispatch_path.py`` pins).  Not thread-safe: the
    monitor thread is the only caller.
    """

    def __init__(self, seed: int):
        self._seed = int(seed) & _MASK64
        self._bg = np.random.Philox(key=[self._seed, 0])
        self.generator = np.random.Generator(self._bg)
        self._stream = DispatchStream(self)

    def stream(self, lane: int, seq: int) -> DispatchStream:
        """The cheap per-dispatch stream (the deferred path's default);
        see DispatchStream.  Returns the shared instance re-keyed."""
        s = self._stream
        s.rekey(lane, seq)
        return s

    def keyed(self, lane: int, seq: int) -> np.random.Generator:
        state = self._bg.state
        inner = state["state"]
        inner["key"][:] = (self._seed,
                           ((lane & 0xFFFF) << 48) | (seq & _MASK48))
        inner["counter"][:] = 0
        state["buffer_pos"] = 4         # buffer empty: first draw refills
        state["has_uint32"] = 0
        state["uinteger"] = 0
        self._bg.state = state
        return self.generator


def instruction_counts(module: HloModule,
                       trip_counts: Optional[Dict[str, int]] = None,
                       ) -> List[Sample]:
    """GT-Pin-analogue instrumentation: exact per-op executed counts.

    ``trip_counts``: while-op name -> trip count (defaults to 1); counts
    multiply through nested loop bodies, mirroring basic-block count
    propagation in §4.2.
    """
    trip_counts = trip_counts or {}
    # computation -> execution multiplier
    mult: Dict[str, int] = {module.entry: 1}
    callers = module.callers()

    def comp_mult(comp: str, seen=frozenset()) -> int:
        if comp in mult:
            return mult[comp]
        if comp in seen:
            return 1
        sites = callers.get(comp, [])
        if not sites:
            mult[comp] = 1
            return 1
        site = sites[0]
        m = comp_mult(site.comp, seen | {comp})
        if site.opcode == "while":
            m *= trip_counts.get(site.name, 1)
        mult[comp] = m
        return m

    out = []
    for op in module.all_ops():
        m = comp_mult(op.comp)
        out.append(Sample(op_index=op.index, stall="compute", count=m))
    return out
