"""Program structure recovery — the ``hpcstruct`` analogue (paper §5).

HPCToolkit analyzes GPU binaries (nvdisasm / IGA / Dyninst) to map machine
instructions to source lines, loop nests, and inlined call chains.  Our
"GPU binary" is a compiled HLO module (``compiled.as_text()``): it carries

- ``FileNames`` / ``FunctionNames`` / ``FileLocations`` / ``StackFrames``
  tables — the DWARF analogue, but with *complete* inline chains
  (``parent_frame_id`` links), fixing exactly the deficiency the paper
  laments in §9 "Attribution";
- per-op ``metadata={op_name="jit(f)/scope/..." stack_frame_id=N}`` — the
  JAX name-stack, i.e. the high-level-model scope chain (the RAJA/Kokkos
  template-instantiation problem of §1 solved at the metadata level);
- explicit computation boundaries, ``while`` loops (loop recovery), and
  ``fusion``/``call``/``to_apply`` edges (the static call graph §6.3 needs).

This module parses all of that, estimates per-op roofline costs (the weight
source for the PC-sampling analogue), and exposes the static call graph.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cct import Frame, GPU_FUNC, GPU_LOOP, GPU_OP

# dtype -> bytes per element
_DT = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
       "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
       "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
       "f8e4m3fn": 1, "f8e5m2fnuz": 1, "f8e4m3b11fnuz": 1}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(ROOT\s+)?%([\w.\-]+)\s*=\s*(.+?)\s+([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*{")
_META_RE = re.compile(
    r'metadata=\{[^}]*?op_name="([^"]*)"(?:[^}]*?stack_frame_id=(\d+))?')
_CALLS_RE = re.compile(r"(?:calls|body|condition|to_apply)=%([\w.\-]+)")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{([^}]*)\}")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_BODY_RE = re.compile(r"body=%([\w.\-]+)")


def parse_shape(type_str: str) -> Tuple[int, int]:
    """Returns (total elements, total bytes) over all leaves of a possibly
    tuple-typed string."""
    elems = 0
    nbytes = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DT:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems += n
        nbytes += n * _DT[dt]
    return elems, nbytes


@dataclasses.dataclass
class HloOp:
    name: str
    opcode: str
    comp: str                      # owning computation
    type_str: str
    out_elems: int
    out_bytes: int
    operands: Tuple[str, ...]
    op_name: str = ""
    frame_id: int = 0
    callees: Tuple[str, ...] = ()
    attrs: str = ""
    index: int = 0                 # position within the module
    flops: float = 0.0
    bytes: float = 0.0
    group_size: int = 1            # collective group size
    trip_count: int = 1            # while ops: known_trip_count from XLA

    @property
    def collective_kind(self) -> str:
        """Base collective opcode ("all-reduce", ...) with any async
        ``-start``/``-done`` suffix removed, or "" for non-collectives.

        NB: this must strip a *suffix*, not a character set —
        ``"reduce-scatter".rstrip("-start")`` eats the trailing ``r``
        (rstrip takes characters, not a substring) and previously
        misclassified reduce-scatter via that path."""
        opc = self.opcode
        for suffix in ("-start", "-done"):
            if opc.endswith(suffix):
                opc = opc[: -len(suffix)]
                break
        return opc if opc in COLLECTIVES else ""

    @property
    def is_collective(self) -> bool:
        return bool(self.collective_kind)


@dataclasses.dataclass
class Computation:
    name: str
    ops: List[HloOp]
    is_entry: bool = False


@dataclasses.dataclass
class StackFrame:
    function: str
    file: str
    line: int
    parent: int                    # 0 = none


@dataclasses.dataclass
class HloModule:
    name: str
    computations: Dict[str, Computation]
    entry: str
    frames: Dict[int, StackFrame]
    ops: Dict[str, HloOp]

    _all_ops_cache: Optional[List[HloOp]] = None

    # -- derived ----------------------------------------------------------
    def all_ops(self) -> List[HloOp]:
        if self._all_ops_cache is None:
            self._all_ops_cache = [op for c in self.computations.values()
                                   for op in c.ops]
        return self._all_ops_cache

    def frame_chain(self, frame_id: int, max_depth: int = 64) -> List[Frame]:
        """Inline call chain (outermost first) for a stack_frame_id."""
        chain: List[Frame] = []
        fid = frame_id
        seen = 0
        while fid and fid in self.frames and seen < max_depth:
            fr = self.frames[fid]
            chain.append(Frame(GPU_FUNC, fr.function, fr.file, fr.line))
            fid = 0 if fr.parent == fid else fr.parent
            seen += 1
        return chain[::-1]

    def callers(self) -> Dict[str, List[HloOp]]:
        """computation name -> call-site ops."""
        out: Dict[str, List[HloOp]] = {c: [] for c in self.computations}
        for op in self.all_ops():
            for callee in op.callees:
                if callee in out:
                    out[callee].append(op)
        return out

    def loop_depth(self) -> Dict[str, List[HloOp]]:
        """computation name -> chain of enclosing while-ops (outer first).

        Cached: the call graph is immutable after parse, and op_context
        runs this on the dispatch path for every fresh PC-sample op."""
        cached = getattr(self, "_loop_depth_cache", None)
        if cached is not None:
            return cached
        callers = self.callers()
        memo: Dict[str, List[HloOp]] = {}

        def chain(comp: str, seen) -> List[HloOp]:
            if comp in memo:
                return memo[comp]
            if comp in seen:
                return []
            seen = seen | {comp}
            sites = callers.get(comp, [])
            if not sites:
                memo[comp] = []
                return []
            site = sites[0]  # first caller approximation (cf. §6.3)
            parent_chain = chain(site.comp, seen)
            own = [site] if site.opcode == "while" else []
            memo[comp] = parent_chain + own
            return memo[comp]

        for c in self.computations:
            chain(c, frozenset())
        self._loop_depth_cache = memo
        return memo

    def op_context(self, op: HloOp) -> List[Frame]:
        """Structure frames for an op: scope chain from op_name, enclosing
        loops, inline chain, then the op itself — what hpcstruct feeds the
        calling-context expansion (§6.1)."""
        frames: List[Frame] = []
        if op.op_name:
            parts = [p for p in op.op_name.split("/") if p]
            for p in parts[:-1]:
                frames.append(Frame(GPU_FUNC, p))
        for loop_op in self.loop_depth().get(op.comp, []):
            frames.append(Frame(GPU_LOOP, loop_op.name,
                                loop_op.op_name, loop_op.index))
        chain = self.frame_chain(op.frame_id)
        if chain:
            frames.extend(chain[-2:])  # innermost inline frames
        frames.append(Frame(GPU_OP, f"{op.opcode}:{op.name}", self.name,
                            op.index))
        return frames

    def collective_ops(self) -> List[HloOp]:
        """Collective *initiation* ops: sync spellings and async
        ``-start`` halves.  ``-done`` completions are classified
        collective (is_collective) but carry no payload of their own, so
        byte accounting skips them to avoid double counting."""
        return [op for op in self.all_ops()
                if op.collective_kind and not op.opcode.endswith("-done")]

    # -- kernel-interior structures (repro.core.kstruct) ------------------
    def bind_kernel_structure(self, ks, match: Optional[str] = None) -> int:
        """Attach a ``kstruct.KernelStructure`` to every ``custom-call``
        op whose ``op_name`` / attrs mention ``match`` (default: the
        structure's kernel name).  This is the §5 binding step: the
        opaque GPU binary region (a Pallas kernel behind a custom-call)
        gets its recovered interior structure, so pc_samples can descend
        into it.  Returns the number of ops bound."""
        needle = match or ks.name
        bound = 0
        for op in self.all_ops():
            if op.opcode != "custom-call":
                continue
            if needle in op.op_name or needle in op.attrs:
                if not hasattr(self, "_kernel_structs"):
                    self._kernel_structs = {}
                self._kernel_structs[op.index] = ks
                bound += 1
        if bound:
            # op weights and counter totals change: bound custom-calls
            # gain the kernel's modeled interior cost (custom-call
            # parses with flops=0)
            self._op_weights_cache = None
            self._op_p_cache = None
            self._op_cdf_cache = None
            self._counter_cache = None
        return bound

    def kernel_structures(self) -> Dict[int, object]:
        """op index -> bound KernelStructure (empty if none bound)."""
        return getattr(self, "_kernel_structs", None) or {}

    def comp_multipliers(self) -> Dict[str, float]:
        """Computation -> expected execution count.

        XLA's HloCostAnalysis counts a while body ONCE regardless of trip
        count (verified empirically), so scan-over-layers undercounts
        flops/bytes by ~n_layers.  We fix that here: each computation's
        multiplier is the sum over its call sites of the caller's
        multiplier, times the site's known_trip_count when the site is a
        ``while``."""
        callers = self.callers()
        memo: Dict[str, float] = {}

        def mult(comp: str, seen=frozenset()) -> float:
            if comp in memo:
                return memo[comp]
            if comp in seen:
                return 1.0
            sites = callers.get(comp, [])
            if not sites:
                m = 1.0  # entry (or dead) computation
            else:
                m = 0.0
                for site in sites:
                    sm = mult(site.comp, seen | {comp})
                    if site.opcode == "while":
                        sm *= max(site.trip_count, 1)
                    m += sm
            memo[comp] = m
            return m

        for c in self.computations:
            mult(c)
        return memo

    def fused_comps(self) -> frozenset:
        """Computations reached via fusion/call/to_apply (their ops live in
        registers/VMEM; HBM traffic is carried by the boundary op)."""
        out = set()
        for op in self.all_ops():
            if op.opcode in ("fusion", "call", "reduce", "map", "sort",
                             "scatter", "reduce-window", "select-and-scatter",
                             "all-reduce", "reduce-scatter"):
                out.update(op.callees)
        return frozenset(out)

    def total_costs(self) -> Dict[str, float]:
        """Module-level {flops, bytes} x {once, scaled}.

        ``once`` mirrors XLA cost-analysis semantics (every computation
        counted a single time); ``scaled`` applies comp_multipliers.  The
        ratio scaled/once is how roofline.py corrects
        ``compiled.cost_analysis()`` for loop trip counts."""
        mults = self.comp_multipliers()
        fused = self.fused_comps()
        out = {"flops_once": 0.0, "flops_scaled": 0.0,
               "bytes_once": 0.0, "bytes_scaled": 0.0}
        for comp in self.computations.values():
            m = mults.get(comp.name, 1.0)
            for op in comp.ops:
                if op.opcode in ("fusion", "call", "while", "conditional"):
                    flops = 0.0     # callees counted with their own mult
                else:
                    flops = op.flops
                nbytes = 0.0 if comp.name in fused else op.bytes
                out["flops_once"] += flops
                out["flops_scaled"] += flops * m
                out["bytes_once"] += nbytes
                out["bytes_scaled"] += nbytes * m
        return out

    def cost_scale(self) -> Tuple[float, float]:
        """(flops_ratio, bytes_ratio) to apply to cost_analysis numbers."""
        t = self.total_costs()
        fr = t["flops_scaled"] / t["flops_once"] if t["flops_once"] else 1.0
        br = t["bytes_scaled"] / t["bytes_once"] if t["bytes_once"] else 1.0
        return max(fr, 1.0), max(br, 1.0)

    def call_graph(self):
        """(nodes, edges): nodes = computation names; edges =
        {(caller, callee): n_call_sites}."""
        edges: Dict[Tuple[str, str], int] = {}
        for op in self.all_ops():
            for callee in op.callees:
                key = (op.comp, callee)
                edges[key] = edges.get(key, 0) + 1
        return list(self.computations), edges


def _estimate_costs(op: HloOp, ops: Dict[str, HloOp],
                    comps: Dict[str, Computation]) -> Tuple[float, float]:
    """(flops, bytes) roofline estimate for one op."""
    in_bytes = sum(ops[o].out_bytes for o in op.operands if o in ops)
    nbytes = float(in_bytes + op.out_bytes)
    opc = op.opcode
    flops = 0.0
    if opc == "dot":
        # flops = 2 * out_elems * K;  K = lhs_elems / (out "lhs part")
        lhs = ops.get(op.operands[0]) if op.operands else None
        if lhs is not None and op.out_elems:
            m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
            k = 1
            if m and m.group(1):
                dims_m = _SHAPE_RE.search(lhs.type_str)
                if dims_m and dims_m.group(2):
                    dims = [int(d) for d in dims_m.group(2).split(",")]
                    for ci in m.group(1).split(","):
                        ci = int(ci)
                        if ci < len(dims):
                            k *= dims[ci]
            flops = 2.0 * op.out_elems * k
        else:
            flops = 2.0 * op.out_elems
    elif opc == "convolution":
        flops = 2.0 * op.out_elems * max(1, in_bytes // max(op.out_bytes, 1))
    elif opc in ("fusion", "call"):
        for cname in op.callees:
            comp = comps.get(cname)
            if comp:
                flops += sum(o.flops for o in comp.ops)
        # fusion reads inputs + writes outputs once
    elif opc == "reduce":
        flops = float(sum(ops[o].out_elems for o in op.operands[:1]
                          if o in ops))
    elif opc in ("exponential", "tanh", "log", "rsqrt", "sqrt", "power",
                 "logistic", "sine", "cosine"):
        flops = 10.0 * op.out_elems      # transcendental weight
    elif opc in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "compare", "select", "and", "or", "xor",
                 "negate", "abs", "floor", "ceil", "clamp"):
        flops = float(op.out_elems)
    return flops, nbytes


def parse_hlo(text: str, name: str = "module") -> HloModule:
    """Parse a (compiled or lowered) HLO module text dump."""
    m = re.match(r"HloModule\s+([\w.\-]+)", text)
    if m:
        name = m.group(1)

    # --- metadata tables ---------------------------------------------------
    def table(section: str) -> Dict[int, str]:
        out: Dict[int, str] = {}
        sec = re.search(rf"^{section}\n((?:\d+ .*\n)+)", text, re.M)
        if sec:
            for line in sec.group(1).strip().splitlines():
                i, _, rest = line.partition(" ")
                out[int(i)] = rest.strip().strip('"')
        return out

    files = table("FileNames")
    funcs = table("FunctionNames")
    locs: Dict[int, Tuple[int, int, int]] = {}
    sec = re.search(r"^FileLocations\n((?:\d+ .*\n)+)", text, re.M)
    if sec:
        for line in sec.group(1).strip().splitlines():
            i, _, rest = line.partition(" ")
            fm = re.search(r"file_name_id=(\d+) function_name_id=(\d+) "
                           r"line=(\d+)", rest)
            if fm:
                locs[int(i)] = (int(fm.group(1)), int(fm.group(2)),
                                int(fm.group(3)))
    frames: Dict[int, StackFrame] = {}
    sec = re.search(r"^StackFrames\n((?:\d+ .*\n)+)", text, re.M)
    if sec:
        for line in sec.group(1).strip().splitlines():
            i, _, rest = line.partition(" ")
            fm = re.search(r"file_location_id=(\d+)(?: parent_frame_id=(\d+))?",
                           rest)
            if fm:
                loc = locs.get(int(fm.group(1)), (0, 0, 0))
                parent = int(fm.group(2) or 0)
                fid = int(i)
                frames[fid] = StackFrame(
                    funcs.get(loc[1], "?"), files.get(loc[0], "?"), loc[2],
                    0 if parent == fid else parent)

    # --- computations & ops -------------------------------------------------
    comps: Dict[str, Computation] = {}
    ops: Dict[str, HloOp] = {}
    entry = ""
    cur: Optional[Computation] = None
    index = 0
    for raw in text.splitlines():
        line = raw.rstrip()
        if cur is None:
            cm = _COMP_RE.match(line)
            if cm:
                cur = Computation(cm.group(2), [], bool(cm.group(1)))
                comps[cur.name] = cur
                if cm.group(1):
                    entry = cur.name
            continue
        if line.startswith("}"):
            cur = None
            continue
        om = _OP_RE.match(line)
        if not om:
            continue
        _, opname, type_str, opcode, rest = om.groups()
        elems, nbytes = parse_shape(type_str)
        # operand names: %foo tokens inside the call parens (first level ok)
        operand_names = tuple(re.findall(r"%([\w.\-]+)", rest.split("),")[0]
                                         if ")," in rest else rest))
        meta = _META_RE.search(line)
        op = HloOp(
            name=opname, opcode=opcode, comp=cur.name, type_str=type_str,
            out_elems=elems, out_bytes=nbytes, operands=operand_names,
            op_name=meta.group(1) if meta else "",
            frame_id=int(meta.group(2)) if meta and meta.group(2) else 0,
            callees=tuple(_CALLS_RE.findall(line)),
            attrs=line, index=index)
        if opcode == "while":
            tm = _TRIP_RE.search(line)
            if tm:
                op.trip_count = int(tm.group(1))
        gm = _GROUPS_RE.search(line)
        if gm:
            op.group_size = int(gm.group(2))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            if gl and gl.group(1):
                first = gl.group(1).split("}")[0].strip("{} ")
                op.group_size = max(1, len([t for t in first.split(",")
                                            if t.strip() != ""]))
        cur.ops.append(op)
        ops[opname] = op
        index += 1

    # cost estimation needs two passes (fusion sums inner-computation flops)
    for op in ops.values():
        if op.opcode not in ("fusion", "call"):
            op.flops, op.bytes = _estimate_costs(op, ops, comps)
    for op in ops.values():
        if op.opcode in ("fusion", "call"):
            op.flops, op.bytes = _estimate_costs(op, ops, comps)

    return HloModule(name=name, computations=comps, entry=entry,
                     frames=frames, ops=ops)


def collective_bytes(module: HloModule) -> Dict[str, float]:
    """Per-collective-kind operand bytes and modeled wire bytes (per device).

    Wire model (ring): all-reduce 2(g-1)/g x operand; all-gather (g-1) x
    operand (operand = local shard); reduce-scatter / all-to-all (g-1)/g x
    operand; collective-permute 1 x operand.
    """
    out = {"operand_bytes": 0.0, "wire_bytes": 0.0}
    per_kind: Dict[str, float] = {}
    mults = module.comp_multipliers()
    for op in module.collective_ops():
        in_bytes = sum(module.ops[o].out_bytes for o in op.operands
                       if o in module.ops)
        # collectives inside while bodies (e.g. MoE all-to-all under
        # scan-over-layers) execute trip_count times
        in_bytes *= max(mults.get(op.comp, 1.0), 1.0)
        g = max(op.group_size, 1)
        kind = op.collective_kind
        if kind == "all-reduce":
            wire = 2.0 * (g - 1) / g * in_bytes
        elif kind == "all-gather":
            wire = float((g - 1)) * in_bytes
        elif kind in ("reduce-scatter", "all-to-all"):
            wire = (g - 1) / g * in_bytes
        else:  # collective-permute
            wire = float(in_bytes)
        out["operand_bytes"] += in_bytes
        out["wire_bytes"] += wire
        per_kind[kind] = per_kind.get(kind, 0.0) + in_bytes
    out.update({f"operand_bytes/{k}": v for k, v in per_kind.items()})
    return out
