"""Program structure from ``torch.export`` — the port's front end in the
place of ``structure.parse_hlo`` (paper §5).

The JAX package reads its "GPU binary" from compiled HLO text: ops with
opcodes, a ``jax.named_scope`` chain in each op's ``op_name`` and inline
call chains in the ``StackFrames`` table.  Here the binary is a
``torch.export`` graph of one serving step, and ``module_from_export``
turns it into the same ``structure.HloModule`` dataclasses, so everything
downstream (PC-sample weights, kernel-interior binding, counters,
aggregation) runs unchanged:

- **Opcodes.**  Each aten op maps onto the HLO opcode the shared code
  keys on (``OPCODES``): the matmul family becomes ``dot``, ``exp``
  becomes ``exponential``, views (which move no data in PyTorch) become
  ``bitcast``; graph inputs become ``parameter`` (``constant`` for lifted
  constants), ``getitem`` a ``get-tuple-element``, and the graph's output
  a ``tuple``: pseudo-ops that are never sampled.  The three Hopper
  kernels (``repro_torch::flash_attention``, ``::flash_decode``,
  ``::ssm_scan``) become ``custom-call`` ops whose ``op_name`` ends in
  the kernel's name (``KERNEL_NAMES``), so
  ``HloModule.bind_kernel_structure`` binds their recovered interiors
  (``core.kstruct``) unchanged.  An aten op missing from the table maps
  to ``copy`` and says ``unmapped`` in its ``attrs``.
- **Scope chain and frames.**  The models are plain functions, so there
  is no ``nn_module_stack``; the scope chain is the Python call chain
  instead, the counterpart of the reference's ``jax.named_scope`` chain:
  ``op_name`` is ``<step>/<function>/.../<aten op>``, the functions being
  the frames inside ``repro_torch/models`` and ``repro_torch/kernels``,
  outermost first (``prefill/_stack_forward/_apply_entry/_attention/
  project_qkv/apply_rope/mul``).  The same frames, with files and lines,
  become ``StackFrame``s linked by ``parent``.  ``torch.export`` keeps
  only ``forward`` frames in a node's ``stack_trace`` in some versions,
  so ``export_step`` writes the full chain of model frames into each
  node's ``stack_trace`` as the node is created.  A node without one
  takes its nearest traced producer's chain; no node is dropped.
- **Costs.**  FLOPs of a product come from ``torch.utils.flop_counter``
  (its registry, reached through torch's own decomposition of
  ``matmul``/``einsum`` into ``mm``/``bmm``), run on meta tensors of the
  shapes in the node's ``meta["val"]``; other ops have 0 FLOPs.  Bytes
  are the node's tensor inputs plus outputs; views and pseudo-ops move
  none.  A ``custom-call`` has 0 FLOPs and takes its cost from the bound
  kernel structure, as in the reference.
- **Loops.**  The port unrolls the layer loop in Python, so the module
  has one computation, no ``while``, and ``comp_multipliers`` is 1
  everywhere.
- **Train step.**  ``torch.export`` traces forward only, so a train step
  (forward, backward, optimizer) is traced by ``trace_train_step``
  (``make_fx`` on fake tensors) and mapped by the same code
  (``module_from_graph``).
"""
from __future__ import annotations

import contextlib
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.structure import (Computation, HloModule, HloOp,
                                        StackFrame)

# the frames that make the scope chain: the model code and the kernels'
# wrappers (never the step closure, the tool or torch)
SCOPE_DIRS = (os.path.join("repro_torch", "models") + os.sep,
              os.path.join("repro_torch", "kernels") + os.sep)

# custom op -> the kernel's name, which its structure carries
KERNEL_NAMES = {"repro_torch::flash_attention": "flash_attention",
                "repro_torch::flash_decode": "decode_attention",
                "repro_torch::ssm_scan": "ssm_scan"}

_VIEWS = ("view", "_unsafe_view", "reshape", "_reshape_alias", "unsqueeze",
          "squeeze", "expand", "expand_as", "permute", "transpose", "t",
          "alias", "slice", "select", "split", "split_with_sizes", "chunk",
          "unbind", "as_strided", "detach", "detach_", "unflatten",
          "flatten", "narrow", "view_as", "movedim", "diagonal")
OPCODES: Dict[str, str] = {
    **{v: "bitcast" for v in _VIEWS},
    # products
    "mm": "dot", "bmm": "dot", "addmm": "dot", "baddbmm": "dot",
    "matmul": "dot", "linear": "dot", "einsum": "dot",
    # elementwise
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "reciprocal": "divide", "neg": "negate",
    "square": "multiply", "pow": "power", "maximum": "maximum",
    "minimum": "minimum", "clamp": "clamp", "clamp_min": "maximum",
    "clamp_max": "minimum", "abs": "abs", "floor": "floor", "ceil": "ceil",
    "where": "select", "eq": "compare", "ne": "compare", "lt": "compare",
    "le": "compare", "gt": "compare", "ge": "compare",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_not": "not", "bitwise_not": "not",
    # transcendentals
    "exp": "exponential", "exp2": "exponential", "log": "log",
    "log1p": "log-plus-one", "softplus": "log-plus-one", "rsqrt": "rsqrt",
    "sqrt": "sqrt", "tanh": "tanh", "sigmoid": "logistic",
    "silu": "logistic", "sin": "sine", "cos": "cosine",
    # reductions
    "sum": "reduce", "mean": "reduce", "amax": "reduce", "amin": "reduce",
    "max": "reduce", "min": "reduce", "argmax": "reduce",
    "argmin": "reduce", "cumsum": "reduce-window", "_softmax": "reduce",
    "softmax": "reduce",
    # data movement and creation
    "cat": "concatenate", "stack": "concatenate", "roll": "concatenate",
    "_to_copy": "convert", "to": "convert", "type_as": "convert",
    "clone": "copy", "copy": "copy", "copy_": "copy", "contiguous": "copy",
    "lift_fresh_copy": "copy", "index": "gather", "embedding": "gather",
    "gather": "gather", "index_select": "gather", "index_put": "scatter",
    "index_put_": "scatter", "scatter": "scatter",
    "slice_scatter": "dynamic-update-slice",
    "select_scatter": "dynamic-update-slice", "arange": "iota",
    "full": "broadcast", "zeros": "broadcast", "ones": "broadcast",
    "empty": "broadcast", "new_zeros": "broadcast", "new_ones": "broadcast",
    "new_empty": "broadcast", "new_full": "broadcast",
    "zeros_like": "broadcast", "ones_like": "broadcast",
    "empty_like": "broadcast", "full_like": "broadcast",
    "scalar_tensor": "constant", "fmod": "remainder", "remainder": "remainder",
    # host-side shape checks: no device work
    "_assert_tensor_metadata": "after-all", "_assert_scalar": "after-all",
    "sym_constrain_range_for_size": "after-all",
}
# every opcode a module built here can hold
HLO_VOCABULARY = frozenset(OPCODES.values()) | {
    "parameter", "constant", "get-tuple-element", "tuple", "custom-call"}
# moves no data of its own
_NO_TRAFFIC = frozenset({"bitcast", "after-all", "parameter", "constant",
                         "get-tuple-element", "tuple"})

_HLO_DTYPES = {torch.float32: "f32", torch.float16: "f16",
               torch.bfloat16: "bf16", torch.float64: "f64",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}
_FRAME_RE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


class _Step(torch.nn.Module):
    """Holds nothing; calls the step function on its pytree inputs."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _model_frames(frame, in_scope: Dict[object, bool]
                  ) -> List[Tuple[str, int, str]]:
    """(file, line, function) of the live frames inside ``SCOPE_DIRS``,
    outermost first; ``in_scope`` memoises the test per code object."""
    out = []
    while frame is not None:
        code = frame.f_code
        hit = in_scope.get(code)
        if hit is None:
            hit = in_scope[code] = any(d in code.co_filename
                                       for d in SCOPE_DIRS)
        if hit:
            out.append((code.co_filename, frame.f_lineno, code.co_name))
        frame = frame.f_back
    return out[::-1]


@contextlib.contextmanager
def _recording_model_frames():
    """While open, every graph node created by the tracer gets the chain
    of model frames live at its creation as its ``stack_trace`` (in
    ``traceback`` format), before the tracer's own filter runs.  The hook
    is on ``torch.fx.Graph`` itself, so it is process-wide while open:
    one export at a time."""
    create = torch.fx.Graph.create_node
    in_scope: Dict[object, bool] = {}

    def create_node(graph, *args, **kwargs):
        node = create(graph, *args, **kwargs)
        if node.op == "call_function" and not node.meta.get("stack_trace"):
            frames = _model_frames(sys._getframe(1), in_scope)
            if frames:
                node.meta["stack_trace"] = "\n".join(
                    f'  File "{f}", line {n}, in {fn}' for f, n, fn in frames)
        return node

    torch.fx.Graph.create_node = create_node
    try:
        yield
    finally:
        torch.fx.Graph.create_node = create


def export_step(fn, args: Sequence, kwargs: Optional[dict] = None
                ) -> torch.export.ExportedProgram:
    """``torch.export`` one serving step ``fn(*args, **kwargs)`` (which may
    hold pytrees: the params and cache dicts) with ``strict=False``, its
    nodes carrying their model frames.  Python ints among the inputs
    (decode's ``pos``) are specialised.  The export runs under
    ``torch.no_grad``, so a step decorated with it is traced undecorated
    (its ``__wrapped__``): the grad-mode switch would only add a pass."""
    fn = getattr(fn, "__wrapped__", fn)
    with _recording_model_frames(), torch.no_grad():
        return torch.export.export(_Step(fn), tuple(args), kwargs,
                                   strict=False)


def _aten_name(target) -> str:
    """``aten.mm.default`` -> ``mm``."""
    name = getattr(target, "__name__", str(target))
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        name = packet.__name__
    return name.split(".")[-1]


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _type_str(vals: list) -> str:
    parts = [f"{_HLO_DTYPES.get(t.dtype, 'f32')}"
             f"[{','.join(str(int(d)) for d in t.shape)}]" for t in vals]
    return parts[0] if len(parts) == 1 else "(" + ", ".join(parts) + ")"


def _meta(x):
    """A node argument with every tensor value on the meta device."""
    if isinstance(x, torch.fx.Node):
        x = x.meta.get("val")
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_meta(a) for a in x)
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


def _flops(target, node) -> float:
    """The node's FLOPs as ``FlopCounterMode`` counts them (its registry,
    through torch's own decompositions of the matmul family), run on
    meta tensors of the node's shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        target(*_meta(node.args), **_meta(node.kwargs))
    return float(counter.get_total_flops())


def _chain(node, chains: Dict[torch.fx.Node, tuple]) -> tuple:
    """The node's model frames, or its nearest traced producer's."""
    if node in chains:
        return chains[node]
    frames = tuple((f, int(n), fn) for f, n, fn in
                   _FRAME_RE.findall(node.meta.get("stack_trace") or ""))
    frames = tuple(fr for fr in frames if any(d in fr[0] for d in SCOPE_DIRS))
    if not frames:
        todo, seen = list(node.all_input_nodes), set()
        while todo and not frames:
            nxt = []
            for p in todo:
                if p in seen:
                    continue
                seen.add(p)
                got = chains.get(p)
                if got:
                    frames = got
                    break
                nxt.extend(p.all_input_nodes)
            todo = nxt
    chains[node] = frames
    return frames


def trace_train_step(fn, args: Sequence) -> torch.fx.GraphModule:
    """The aten graph of one whole train step ``fn(*args)`` (loss, its
    backward through ``torch.autograd.grad``, the optimizer update), by
    ``make_fx`` on fake tensors: nothing runs on the device and no kernel
    launch is counted.  ``torch.export`` traces no backward, hence
    ``make_fx``.  The kernels stay single nodes (their custom ops have no
    decomposition), their recompute backward is traced as the aten ops it
    runs, and the remat checkpoints' recompute is traced where the
    backward runs it, so there is one kernel node per forward launch,
    recompute included (``_eager_selective_checkpoint``).  Nodes carry
    their model frames as in ``export_step``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with _recording_model_frames(), _eager_selective_checkpoint():
        return make_fx(fn, tracing_mode="fake")(*args)


@contextlib.contextmanager
def _eager_selective_checkpoint():
    """While open, a selective checkpoint acts under a tracer as it does
    eagerly: it keeps what its policy saves and recomputes the rest in the
    backward, where the trace records the recompute.  Under a tracer torch
    otherwise saves every op of the region and leaves the recompute to a
    compiler's partitioner, so the graph would hold one kernel node per
    layer where the card launches two.  torch decides that in
    ``torch.utils.checkpoint._is_compiling``, which this replaces."""
    import torch.utils.checkpoint as ckpt
    real = ckpt._is_compiling
    ckpt._is_compiling = lambda *args, **kwargs: False
    try:
        yield
    finally:
        ckpt._is_compiling = real


def module_from_export(name: str, exported: torch.export.ExportedProgram
                       ) -> HloModule:
    """The ``HloModule`` of one exported serving step (see the module
    docstring)."""
    constants = {s.arg.name for s in exported.graph_signature.input_specs
                 if s.kind.name in ("CONSTANT_TENSOR", "CUSTOM_OBJ")}
    return module_from_graph(name, exported.graph_module, constants)


def module_from_graph(name: str, gm: torch.fx.GraphModule,
                      constants=frozenset()) -> HloModule:
    """The ``HloModule`` of one traced step: one entry computation
    ``main`` holding an op per graph node, in graph order; placeholders
    named in ``constants`` become ``constant`` ops."""
    frames: Dict[int, StackFrame] = {}
    frame_ids: Dict[tuple, int] = {}
    chains: Dict[torch.fx.Node, tuple] = {}
    ops: Dict[str, HloOp] = {}
    comp = Computation("main", [], is_entry=True)

    def frame_id(chain: tuple) -> int:
        parent = 0
        for i in range(len(chain)):
            key = chain[:i + 1]
            fid = frame_ids.get(key)
            if fid is None:
                fid = frame_ids[key] = len(frame_ids) + 1
                f, line, fn = chain[i]
                frames[fid] = StackFrame(fn, f, line, parent)
            parent = fid
        return parent

    for node in gm.graph.nodes:
        outs = _tensors(node.meta.get("val"))
        out_bytes = sum(_nbytes(t) for t in outs)
        leaf, attrs, flops = node.name, "", 0.0
        chain: tuple = ()
        if node.op == "placeholder":
            opcode = "constant" if node.name in constants else "parameter"
        elif node.op == "get_attr":
            opcode = "constant"
        elif node.op == "output":
            opcode, outs, out_bytes = "tuple", [], 0
        else:
            target = node.target
            chain = _chain(node, chains)
            schema = getattr(getattr(target, "_schema", None), "name", "")
            if schema in KERNEL_NAMES:
                opcode, leaf = "custom-call", KERNEL_NAMES[schema]
                attrs = f'custom_call_target="{schema}"'
            elif getattr(target, "__name__", "") == "getitem":
                opcode, leaf = "get-tuple-element", "getitem"
            else:
                leaf = _aten_name(target)
                opcode = OPCODES.get(leaf)
                if opcode is None:
                    opcode, attrs = "copy", f'unmapped="{target}"'
                if opcode == "dot":
                    flops = _flops(target, node)
        if opcode in _NO_TRAFFIC:
            nbytes, out_bytes = 0.0, 0
        else:
            ins = [t for a in node.all_input_nodes
                   for t in _tensors(a.meta.get("val"))]
            nbytes = float(sum(_nbytes(t) for t in ins) + out_bytes)
        op_name = ""
        if node.op == "call_function":
            op_name = "/".join([name] + [fn for _, _, fn in chain] + [leaf])
        op = HloOp(name=node.name, opcode=opcode, comp="main",
                   type_str=_type_str(outs) if outs else "()",
                   out_elems=sum(t.numel() for t in outs),
                   out_bytes=out_bytes,
                   operands=tuple(a.name for a in node.all_input_nodes),
                   op_name=op_name, frame_id=frame_id(chain), attrs=attrs,
                   index=len(comp.ops), flops=flops, bytes=nbytes)
        comp.ops.append(op)
        ops[op.name] = op
    return HloModule(name=name, computations={"main": comp}, entry="main",
                     frames=frames, ops=ops)


def cost(module: HloModule) -> Dict[str, float]:
    """The module's ``{"flops", "bytes accessed"}``, the counterpart of
    ``compiled.cost_analysis()``: every op's FLOPs plus those of the
    kernel structures bound to its ``custom-call`` ops, and every op's
    bytes."""
    ops = module.all_ops()
    flops = sum(op.flops for op in ops) + sum(
        ks.total_flops for ks in module.kernel_structures().values())
    return {"flops": float(flops),
            "bytes accessed": float(sum(op.bytes for op in ops))}
