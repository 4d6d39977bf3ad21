"""Kernel-interior structure recovery — ``hpcstruct`` for the port's
Hopper kernels (paper §5 applied *inside* the GPU binary; §7 PC-sampling
attribution).

The program structure (``core.export``) stops at op granularity: each
hand-written kernel is one opaque ``custom-call`` op, so a whole
flash-attention kernel would get one context however hot its loops are.
HPCToolkit recovers kernel interiors from the GPU binary; the JAX
package recovers its Pallas kernels' from their jaxprs.  Here the
interior comes from the kernel's CUDA source, ``csrc/*.cu``, read as
text (there is no compiler front end here; ``chip_smoke.py`` grounds the
result in the built binary's line table on the card):

- each ``__global__`` function of the file is the kernel (a file with
  several, the SSD scan's three steps, gets one ``GPU_FUNC`` each under
  one root);
- a ``for`` loop tagged ``// kstruct: grid:<name>`` on its line is a
  ``GPU_LOOP`` frame named as the reference names its sequential grid
  axis (``grid:kv_blocks``, ``grid:chunks``); other loops only scale the
  weights of what they hold, by their trip count where it is a constant
  expression of the kernel's shapes and ``constexpr`` values;
- a call of a ``__device__`` helper (of the file or of the headers it
  includes, ``hopper.cuh`` and ``common.cuh``) is an inlined ``GPU_FUNC``
  scope at its call-site line, except a helper whose body is one PTX
  instruction of the vocabulary below, whose call is that instruction;
  ``if constexpr`` takes the branch the shapes select;
- statements become ``GPU_OP`` leaves named in the reference's primitive
  vocabulary, so that the counter collector classifies them unchanged:
  ``wgmma``/``mma.sync`` products are ``dot_general``, ``ex2``/``exp2f``
  ``exp2``, ``cp.async`` and TMA copies (and global reads tagged
  ``// kstruct: load <bytes>``) ``load``, global writes tagged
  ``// kstruct: store <bytes>`` ``store``, plus the reductions,
  maxima and conversions of the online softmax.  A run of statements
  that each issue one instruction of the same kind (two unrolled
  ``mma.sync`` in a row, say) is one leaf at the first one's line: the
  compiler's line table gives such a run to that line, so finer leaves
  would name lines without instructions.

Leaf weights are taken at the call's shapes: the function's own FLOPs
(its products) and bytes (each input read once, each output written
once), given in ``shapes``, are split over the ``dot_general`` leaves by
product size (instruction shape times trip count) and over the memory
leaves by bytes moved; a leaf's weight is its roofline time, FLOPs at
the H100's bf16 peak against bytes at its HBM rate (the bytes are the
function's global traffic).

``KernelLeaf``, ``KernelStructure`` (but its front end) and the sample
descent are the JAX package's, byte for byte; only the chip constants
differ.  Structures are plain data.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cct import Frame, GPU_FUNC, GPU_LOOP, GPU_OP
# the card's rates, shared with the op time model: a leaf's load and store
# bytes are the function's global traffic (cp.async, TMA, global stores),
# so they move at the HBM rate, as a custom-call's total bytes do there
from repro_torch.core.sampling import HBM_BW, PEAK_FLOPS

# transcendental primitives get the same 10x element weight the HLO
# cost model uses (structure._estimate_costs)
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt",
    "pow", "integer_pow", "logistic", "sin", "cos", "erf", "erf_inv"})


@dataclasses.dataclass(frozen=True)
class KernelLeaf:
    """One sampled 'instruction' inside a kernel: a (scope chain, source
    line) group of jaxpr equations."""
    frames: Tuple[Frame, ...]   # GPU_LOOP/GPU_FUNC chain + GPU_OP leaf
    weight: float               # modeled seconds (roofline max term)
    stall: str                  # "compute" | "memory"
    flops: float = 0.0
    bytes: float = 0.0

    @property
    def line(self) -> int:
        return self.frames[-1].line


class KernelStructure:
    """The kernel-interior analogue of ``structure.HloModule``: a
    GPU_FUNC root, loop/scope frames, and weighted GPU_OP leaves."""

    def __init__(self, name: str, file: str, line: int,
                 leaves: Sequence[KernelLeaf],
                 grid: Tuple[int, ...] = ()):
        self.name = name
        self.file = file
        self.line = line
        self.grid = tuple(grid)
        self.leaves: Tuple[KernelLeaf, ...] = tuple(leaves)
        self.root = Frame(GPU_FUNC, name, file, line)
        self._p: Optional[np.ndarray] = None

    def __repr__(self) -> str:
        return (f"KernelStructure({self.name!r}, {len(self.leaves)} "
                f"leaves, grid={self.grid})")

    # -- totals (the counter-collector refinement inputs) -----------------
    @property
    def total_flops(self) -> float:
        return sum(lf.flops for lf in self.leaves)

    @property
    def total_bytes(self) -> float:
        return sum(lf.bytes for lf in self.leaves)

    @property
    def active_s(self) -> float:
        return sum(lf.weight for lf in self.leaves)

    def leaf_frames(self, i: int) -> Tuple[Frame, ...]:
        """Full interior frame path for leaf ``i`` (root included) — what
        the profiler splices under the kernel's GPU_OP context."""
        return (self.root,) + self.leaves[i].frames

    # -- sample descent ---------------------------------------------------
    def leaf_p(self) -> np.ndarray:
        """Normalized leaf weights (cached — the descent runs on the
        dispatch path, cf. sampling._op_weights_cache)."""
        if self._p is None:
            w = np.asarray([lf.weight for lf in self.leaves], np.float64)
            total = w.sum()
            self._p = w / total if total > 0 else \
                np.full(len(w), 1.0 / max(len(w), 1))
        return self._p

    def distribute(self, count: int, rng=None) -> List[Tuple[int, int]]:
        """Apportion ``count`` samples over leaves; returns non-zero
        ``(leaf_index, count)`` pairs summing to exactly ``count`` (the
        governor's per-dispatch cap survives the descent unchanged).

        Deterministic mode uses largest-remainder apportionment (floor +
        remainder ranking), so the two-level draw is a pure function of
        (structure, count); with ``rng`` it is one multinomial."""
        if count <= 0 or not self.leaves:
            return []
        p = self.leaf_p()
        if rng is not None:
            counts = rng.multinomial(int(count), p)
        else:
            exact = count * p
            counts = np.floor(exact).astype(np.int64)
            short = int(count - counts.sum())
            if short > 0:
                # ties broken by leaf order: stable + deterministic
                order = np.argsort(-(exact - counts), kind="stable")
                counts[order[:short]] += 1
        return [(int(i), int(counts[i])) for i in np.nonzero(counts)[0]]

    # -- recovery front ends ---------------------------------------------
    @classmethod
    def from_cuda_source(cls, path: str, kernel: str,
                         shapes: Mapping[str, float]) -> "KernelStructure":
        """Recover the interior of the kernel in the CUDA source ``path``
        (a ``.cu`` file) as the structure ``kernel``.  ``shapes`` holds the
        call's sizes by the names the source uses (``D`` for a template
        parameter, say), read where a ``constexpr`` branch or a loop's
        trip count needs them, and the function's own ``flops`` and
        ``bytes`` that the leaves split between them."""
        src = _Sources(path)
        globals_ = [f for f in src.functions.values()
                    if f.is_global and f.file == src.main]
        if not globals_:
            raise ValueError(f"no __global__ function in {path}")
        globals_.sort(key=lambda f: f.line)
        env = dict(src.constants)
        env.update({k: v for k, v in shapes.items()
                    if isinstance(v, (int, float))})
        walk = _Walk(src, env)
        for fn in globals_:
            top = () if len(globals_) == 1 else (
                Frame(GPU_FUNC, fn.name, fn.base, fn.line),)
            walk.body(fn, top, 1.0, (fn.name,))
        base = os.path.basename(path)
        leaves = walk.leaves(float(shapes.get("flops", 0.0)),
                             float(shapes.get("bytes", 0.0)))
        return cls(kernel, base, globals_[0].line, leaves)


# --------------------------------------------------------------------------
# CUDA source scan
# --------------------------------------------------------------------------
# primitive -> rank when one line holds several (the leaf takes the first)
_PRIMS = ("dot_general", "load", "store", "exp2", "exp", "reduce_max",
          "reduce_sum", "max", "convert_element_type")
# PTX that makes a one-instruction helper an instruction: (pattern,
# primitive); a product's size is its shape m*n*k, a copy's its bytes
_PTX = ((re.compile(r"(?:wgmma\.mma_async|mma\.sync)[\w.]*?\.m(\d+)n(\d+)"
                    r"k(\d+)"), "dot_general"),
        (re.compile(r"ex2\.approx"), "exp2"),
        (re.compile(r"cp\.async\.bulk\.tensor"), "load"),
        (re.compile(r"cp\.async\.c[ag]\.shared\.global[^\"]*?(\d+),"),
         "load"))
# one TMA box of the port's kernels: 64 columns x 64 rows of bf16
TMA_BOX_BYTES = 64 * 64 * 2
# CUDA intrinsics and the small reductions of common.cuh, by name
_NAMED = {"exp2f": "exp2", "expf": "exp", "__expf": "exp", "fmaxf": "max",
          "quad_max": "reduce_max", "warp_max": "reduce_max",
          "quad_sum": "reduce_sum", "warp_sum": "reduce_sum",
          "pack_bf16x2": "convert_element_type",
          "__float2bfloat16": "convert_element_type",
          "__floats2bfloat162_rn": "convert_element_type"}
_TAG_RE = re.compile(r"//\s*kstruct:\s*(\S+)(?:\s+(\d+))?")
_CALL_RE = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;(){}]*?>)?\s*\(")
_FOR_RE = re.compile(r"^\s*(?:const\s+)?(?:int|long|unsigned)?\s*(\w+)\s*=\s*"
                     r"(.+?);\s*(\w+)\s*(<=?)\s*(.+?);\s*(?:\+\+(\w+)|(\w+)"
                     r"\+\+|(\w+)\s*\+=\s*(.+?))\s*$")
_CONST_RE = re.compile(r"constexpr\s+(?:int|long|float)\s+(\w+)\s*=\s*"
                       r"([^;{}]+);")
_INCLUDE_RE = re.compile(r'#include\s+"([^"]+)"')
_LAMBDA_RE = re.compile(r"^\s*auto\s+(\w+)\s*=\s*\[[^\]]*\]\s*\([^)]*\)\s*\{")


def _strip_comments(text: str) -> str:
    """``text`` with every comment blanked (newlines kept, so offsets and
    lines stay), string and character literals left alone."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [ch if ch == "\n" else " " for ch in text[i:j]]
            i = j
        else:
            i += 1
    return "".join(out)


def _skip_literal(text: str, i: int) -> int:
    q = text[i]
    j = i + 1
    while j < len(text) and text[j] != q:
        j += 2 if text[j] == "\\" else 1
    return j + 1


def _close(text: str, i: int) -> int:
    """The offset just past the bracket matching the one at ``i``."""
    pairs = {"(": ")", "[": "]", "{": "}"}
    stack = [pairs[text[i]]]
    j = i + 1
    while j < len(text) and stack:
        c = text[j]
        if c in "\"'":
            j = _skip_literal(text, j)
            continue
        if c in pairs:
            stack.append(pairs[c])
        elif c == stack[-1]:
            stack.pop()
        j += 1
    return j


def _statement_end(text: str, i: int, hi: int) -> int:
    """The offset just past the ``;`` that ends the simple statement at
    ``i`` (brackets and literals skipped)."""
    j = i
    while j < hi:
        c = text[j]
        if c in "\"'":
            j = _skip_literal(text, j)
        elif c in "([{":
            j = _close(text, j)
        elif c == ";":
            return j + 1
        elif c == "}":
            return j
        else:
            j += 1
    return hi


def _eval(expr: str, env: Mapping[str, float]):
    """A C constant expression over ``env``, or None."""
    e = expr.strip()
    if not e or not re.fullmatch(r"[\w\s+\-*/%()<>=!&|.]+", e):
        return None
    e = re.sub(r"(?<!/)/(?!/)", "//", e)
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"!(?!=)", " not ", e)
    e = re.sub(r"\b(\d+)[uUlLfF]+\b", r"\1", e)
    e = e.replace("true", "True").replace("false", "False")
    try:
        return eval(e, {"__builtins__": {}}, dict(env))  # noqa: S307
    except Exception:   # not a constant of the shapes: no value
        return None


@dataclasses.dataclass
class _Function:
    name: str
    file: str        # path
    base: str
    line: int        # line of the qualifier (``__global__``/``__device__``)
    lo: int          # body offsets (inside the braces)
    hi: int
    is_global: bool
    ptx: Optional[Tuple[str, float]] = None   # one-instruction helper


class _Sources:
    """A ``.cu`` file and the headers it includes (by ``#include "..."``,
    transitively): comment-free texts, tags by (file, line), functions by
    name (the ``.cu``'s own first) and ``constexpr`` integers."""

    def __init__(self, path: str):
        self.main = os.path.abspath(path)
        self.texts: Dict[str, str] = {}
        self.tags: Dict[Tuple[str, int], Tuple[str, Optional[int]]] = {}
        self.functions: Dict[str, _Function] = {}
        self.constants: Dict[str, float] = {}
        self._newlines: Dict[str, np.ndarray] = {}
        order = self._read(self.main, [])
        for p in order:               # headers before the .cu: constants
            for name, expr in _CONST_RE.findall(self.texts[p]):
                v = _eval(expr, self.constants)
                if v is not None:
                    self.constants.setdefault(name, v)
        for p in reversed(order):     # the .cu first: its names win
            self._functions(p)

    def _read(self, path: str, order: List[str]) -> List[str]:
        if path in self.texts:
            return order
        with open(path) as f:
            raw = f.read()
        for i, line in enumerate(raw.splitlines(), 1):
            m = _TAG_RE.search(line)
            if m:
                self.tags[(path, i)] = (m.group(1), int(m.group(2))
                                        if m.group(2) else None)
        self.texts[path] = _strip_comments(raw)
        self._newlines[path] = np.asarray(
            [i for i, c in enumerate(raw) if c == "\n"], np.int64)
        for inc in _INCLUDE_RE.findall(raw):
            p = os.path.join(os.path.dirname(path), inc)
            if os.path.exists(p):
                self._read(os.path.abspath(p), order)
        order.append(path)
        return order

    def line(self, path: str, pos: int) -> int:
        return int(np.searchsorted(self._newlines[path], pos)) + 1

    def _functions(self, path: str) -> None:
        text = self.texts[path]
        end = 0
        for m in re.finditer(r"\b(__global__|__device__)\b", text):
            if m.start() < end:
                continue       # inside a function already read
            j = m.start()
            while j < len(text) and text[j] not in "{;":
                j = _close(text, j) if text[j] == "(" else j + 1
            if j >= len(text) or text[j] == ";":
                continue       # a declaration
            head = re.sub(r"__launch_bounds__\s*\([^)]*\)", "",
                          text[m.start():j])
            name = re.search(r"(\w+)\s*\(", head)
            body_end = _close(text, j)
            end = body_end
            if name is None or name.group(1) in self.functions:
                continue
            fn = _Function(name.group(1), path, os.path.basename(path),
                           self.line(path, m.start()), j + 1, body_end - 1,
                           m.group(1) == "__global__")
            fn.ptx = _one_instruction(text[j + 1:body_end - 1])
            self.functions[fn.name] = fn


def _one_instruction(body: str) -> Optional[Tuple[str, float]]:
    """(primitive, size) of a helper whose body is one PTX instruction of
    the vocabulary, else None."""
    if body.count("asm") != 1:
        return None
    for pat, prim in _PTX:
        m = pat.search(body)
        if m is None:
            continue
        if prim == "dot_general":
            return prim, float(int(m.group(1)) * int(m.group(2))
                               * int(m.group(3)))
        if pat.pattern.startswith("cp\\.async\\.bulk"):
            return prim, float(TMA_BOX_BYTES)
        return prim, float(m.group(1)) if m.groups() else 1.0
    return None


class _Walk:
    """Walks function bodies, statement by statement, collecting the
    instructions (primitive, size times trip count) of each (frames, file,
    line) in first-seen order."""

    def __init__(self, src: _Sources, env: Dict[str, float]):
        self.src = src
        self.env = env
        self.groups: Dict[tuple, Dict[str, float]] = {}
        # (frames, file, primitive, line) of the last statement if it was
        # one instruction: the run a next such statement joins
        self.run: Optional[tuple] = None

    def body(self, fn: _Function, frames: tuple, trip: float,
             active: tuple, local: Optional[dict] = None) -> None:
        self.block(fn.file, fn.lo, fn.hi, frames, trip, active,
                   dict(local or {}))

    def block(self, path, lo, hi, frames, trip, active, local) -> None:
        text = self.src.texts[path]
        i = lo
        while i < hi:
            c = text[i]
            if c.isspace() or c in ";}":
                i += 1
                continue
            if c == "#":                      # pragma / preprocessor
                j = text.find("\n", i)
                i = hi if j < 0 else j
                continue
            if c == "{":
                j = _close(text, i)
                self.run = None
                self.block(path, i + 1, j - 1, frames, trip, active, local)
                self.run = None
                i = j
                continue
            i = self.statement(path, i, hi, frames, trip, active, local)

    def _sub(self, path, i, hi, frames, trip, active, local) -> int:
        """Walk the statement at ``i`` (compound or not); its end."""
        text = self.src.texts[path]
        while i < hi and text[i].isspace():
            i += 1
        if i < hi and text[i] == "{":
            j = _close(text, i)
            self.block(path, i + 1, j - 1, frames, trip, active, local)
            return j
        return self.statement(path, i, hi, frames, trip, active, local)

    def statement(self, path, i, hi, frames, trip, active, local) -> int:
        text = self.src.texts[path]
        kw = re.match(r"(for|while|if|else)\b", text[i:i + 6])
        if kw:
            self.run = None
        if kw and kw.group(1) in ("for", "while"):
            p = text.index("(", i)
            q = _close(text, p)
            line = self.src.line(path, i)
            tag = self.src.tags.get((path, line))
            inner, t = frames, trip
            if tag and tag[0].startswith("grid:"):
                inner = frames + (Frame(GPU_LOOP, tag[0],
                                        os.path.basename(path), line),)
            elif kw.group(1) == "for":
                t = trip * self._trip(text[p + 1:q - 1])
            return self._sub(path, q, hi, inner, t, active, local)
        if kw and kw.group(1) == "if":
            p = text.index("(", i)
            q = _close(text, p)
            cond = _eval(text[p + 1:q - 1], self.env) \
                if "constexpr" in text[i:p] else None
            j = (self._sub(path, q, hi, frames, trip, active, local)
                 if cond is None or cond else self._skip(path, q, hi))
            k = j
            while k < hi and text[k].isspace():
                k += 1
            if re.match(r"else\b", text[k:k + 5]):
                if cond is None or not cond:
                    return self._sub(path, k + 4, hi, frames, trip, active,
                                     local)
                return self._skip(path, k + 4, hi)
            return j
        if kw and kw.group(1) == "else":
            return self._sub(path, i + 4, hi, frames, trip, active, local)
        j = _statement_end(text, i, hi)
        lam = _LAMBDA_RE.match(text[i:j])
        if lam:                              # a local helper: walked where
            b = text.index("{", i + lam.start())   # it is called
            local[lam.group(1)] = _Function(lam.group(1), path,
                                            os.path.basename(path),
                                            self.src.line(path, i), b + 1,
                                            _close(text, b) - 1, False)
            return j
        self.simple(path, i, j, frames, trip, active, local)
        return j

    def _skip(self, path, i, hi) -> int:
        text = self.src.texts[path]
        while i < hi and text[i].isspace():
            i += 1
        if i < hi and text[i] == "{":
            return _close(text, i)
        kw = re.match(r"(for|while|if)\b", text[i:i + 5])
        if kw:
            q = _close(text, text.index("(", i))
            j = self._skip(path, q, hi)
            k = j
            while k < hi and text[k].isspace():
                k += 1
            if kw.group(1) == "if" and re.match(r"else\b", text[k:k + 5]):
                return self._skip(path, k + 4, hi)
            return j
        return _statement_end(text, i, hi)

    def _trip(self, header: str) -> float:
        m = _FOR_RE.match(header)
        if m is None:
            return 1.0
        var, a, cvar, op, b = m.group(1, 2, 3, 4, 5)
        step_var = m.group(6) or m.group(7) or m.group(8)
        if cvar != var or step_var != var:
            return 1.0
        lo, top = _eval(a, self.env), _eval(b, self.env)
        step = _eval(m.group(9), self.env) if m.group(9) else 1
        if lo is None or top is None or not step or step <= 0:
            return 1.0
        n = (top - lo + (1 if op == "<=" else 0) + step - 1) // step
        return float(max(n, 0))

    def simple(self, path, i, j, frames, trip, active, local) -> None:
        """One simple statement: walk the helpers it calls and collect its
        instructions.  A statement of one instruction that follows one of
        the same kind in the same scope joins that leaf (the compiler's
        line table attributes such a run of unrolled products or copies
        to its first line)."""
        text = self.src.texts[path]
        base = os.path.basename(path)
        found = []
        for m in _CALL_RE.finditer(text, i, j):
            name = m.group(1)
            line = self.src.line(path, m.start())
            fn = local.get(name) or self.src.functions.get(name)
            if name in _NAMED:
                found.append((line, _NAMED[name], 1.0))
            elif fn is not None and fn.ptx is not None:
                found.append((line, fn.ptx[0], fn.ptx[1] * trip))
            elif fn is not None and name not in active and len(active) < 16:
                scope = frames + (Frame(GPU_FUNC, name, base, line),)
                self.block(fn.file, fn.lo, fn.hi, scope, trip,
                           active + (name,), local)
        if "asm" in text[i:j]:
            prim = _one_instruction(text[i:j])
            if prim is not None:
                found.append((self.src.line(path, i), prim[0],
                              prim[1] * trip))
        first, last = self.src.line(path, i), self.src.line(path, j - 1)
        for line in range(first, last + 1):
            tag = self.src.tags.get((path, line))
            if tag and tag[0] in ("load", "store"):
                found.append((line, tag[0], float(tag[1] or 4) * trip))
        run = self.run
        self.run = None
        if len(found) == 1:
            line, prim, size = found[0]
            if run is not None and run[:3] == (frames, base, prim):
                line = run[3]
            self.run = (frames, base, prim, line)
            found = [(line, prim, size)]
        for line, prim, size in found:
            self.add(frames, base, line, prim, size)

    def add(self, frames, base, line, prim, size) -> None:
        g = self.groups.setdefault((frames, base, line), {})
        g[prim] = g.get(prim, 0.0) + size

    def leaves(self, flops: float, nbytes: float) -> List[KernelLeaf]:
        dot = sum(g.get("dot_general", 0.0) for g in self.groups.values())
        mem = sum(g.get("load", 0.0) + g.get("store", 0.0)
                  for g in self.groups.values())
        out = []
        for (frames, base, line), g in self.groups.items():
            prim = next(p for p in _PRIMS if p in g)
            fl = flops * g.get("dot_general", 0.0) / dot if dot else 0.0
            by = nbytes * (g.get("load", 0.0) + g.get("store", 0.0)) / mem \
                if mem else 0.0
            t_c, t_m = fl / PEAK_FLOPS, by / HBM_BW
            out.append(KernelLeaf(
                frames=frames + (Frame(GPU_OP, prim, base, line),),
                weight=max(t_c, t_m, 1.0 / PEAK_FLOPS),
                stall="memory" if t_m > t_c else "compute",
                flops=fl, bytes=by))
        return out
