"""Approximate GPU calling-context-tree reconstruction (paper §6.3, Fig. 5).

Given flat per-function sample counts and a static call graph, reconstruct
an approximate calling context tree:

1. build the static call graph; initialize call-edge weights with exact
   call-instruction counts or call-instruction sample counts;
2. for sample-based graphs: if a function has samples but no incoming edge
   has non-zero weight, assign each incoming edge weight one; propagate
   through callers until every sampled function is reachable;
3. collapse strongly-connected components (Tarjan) into SCC nodes: external
   calls into the SCC link to the SCC node, intra-SCC edges are removed;
4. split the call graph into a tree Gprof-style: apportion each function's
   samples among its call sites by the ratio of each site's call weight to
   the total.

The algorithm is measurement-source agnostic — HPCToolkit applies it to
CUDA device functions; we apply it to HLO computations (fusion/call/while
edges) and to any explicitly-provided graph (tests use the paper's Fig. 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class CallGraph:
    nodes: List[str]
    edges: Dict[Tuple[str, str], float]          # (caller, callee) -> weight
    samples: Dict[str, float]                    # node -> flat sample count

    def preds(self, n: str) -> List[Tuple[str, float]]:
        return [(a, w) for (a, b), w in self.edges.items() if b == n]

    def succs(self, n: str) -> List[Tuple[str, float]]:
        return [(b, w) for (a, b), w in self.edges.items() if a == n]


@dataclasses.dataclass
class CCTOut:
    """Reconstructed tree node."""
    name: str                 # function or "SCC{...}"
    cost: float
    children: List["CCTOut"]
    members: Tuple[str, ...] = ()   # for SCC nodes

    def total(self) -> float:
        out = 0.0
        stack = [self]
        while stack:
            n = stack.pop()
            out += n.cost
            stack.extend(n.children)
        return out

    def find(self, name: str) -> Optional["CCTOut"]:
        stack = [self]
        while stack:
            n = stack.pop()
            if n.name == name:
                return n
            stack.extend(n.children)
        return None


def _tarjan_scc(nodes: Sequence[str],
                edges: Dict[Tuple[str, str], float]) -> List[List[str]]:
    """Iterative Tarjan SCC (recursion-free for deep graphs)."""
    succ: Dict[str, List[str]] = {n: [] for n in nodes}
    for (a, b) in edges:
        if a in succ and b in succ:
            succ[a].append(b)
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(succ[w])))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


def _propagate_sample_edges(g: CallGraph) -> CallGraph:
    """Step 2: ensure every sampled function has a non-zero inbound path."""
    edges = dict(g.edges)
    changed = True
    rounds = 0
    while changed and rounds <= len(g.nodes) + 1:
        changed = False
        rounds += 1
        # a node "needs support" if it has samples or outgoing weight but
        # no inbound weight (and has at least one potential caller)
        for n in g.nodes:
            has_act = g.samples.get(n, 0) > 0 or any(
                w > 0 for (a, _), w in edges.items() if a == n)
            if not has_act:
                continue
            preds = [(a, b) for (a, b) in edges if b == n]
            if not preds:
                continue
            if all(edges[e] == 0 for e in preds):
                for e in preds:
                    edges[e] = 1.0
                changed = True
    return CallGraph(g.nodes, edges, g.samples)


def reconstruct(g: CallGraph, roots: Optional[Sequence[str]] = None,
                sample_based: bool = True, max_depth: int = 64) -> CCTOut:
    """Run steps 1-4; returns a synthetic root whose children are the
    reconstruction roots (functions with no callers)."""
    if sample_based:
        g = _propagate_sample_edges(g)

    # --- step 3: SCC collapse ---------------------------------------------
    sccs = _tarjan_scc(g.nodes, {e: w for e, w in g.edges.items() if w > 0})
    rep: Dict[str, str] = {}
    members: Dict[str, Tuple[str, ...]] = {}
    for comp in sccs:
        if len(comp) == 1:
            n = comp[0]
            # self-loop -> still an SCC node per the paper's Fig. 5
            if g.edges.get((n, n), 0) > 0:
                name = f"SCC{{{n}}}"
                rep[n] = name
                members[name] = (n,)
            else:
                rep[n] = n
        else:
            name = "SCC{" + ",".join(sorted(comp)) + "}"
            for n in comp:
                rep[n] = name
            members[name] = tuple(sorted(comp))

    cnodes: List[str] = sorted({rep[n] for n in g.nodes})
    cedges: Dict[Tuple[str, str], float] = {}
    csamples: Dict[str, float] = {}
    for n, s in g.samples.items():
        csamples[rep[n]] = csamples.get(rep[n], 0.0) + s
    for (a, b), w in g.edges.items():
        ra, rb = rep[a], rep[b]
        if ra == rb:
            continue  # intra-SCC edge removed
        cedges[(ra, rb)] = cedges.get((ra, rb), 0.0) + w

    # --- step 4: split into a tree with Gprof apportioning ------------------
    if roots is None:
        has_pred = {b for (a, b), w in cedges.items() if w > 0}
        roots = [n for n in cnodes if n not in has_pred] or cnodes[:1]
    roots = [rep.get(r, r) for r in roots]

    # precompute inbound totals and outbound adjacency once
    total_in: Dict[str, float] = {}
    succs: Dict[str, List[Tuple[str, float]]] = {}
    for (a, b), w in cedges.items():
        if w > 0:
            total_in[b] = total_in.get(b, 0.0) + w
            succs.setdefault(a, []).append((b, w))

    def build(start: str) -> CCTOut:
        """Iterative DFS (deep scan chains overflow Python recursion)."""
        root = CCTOut(start, csamples.get(start, 0.0), [],
                      members.get(start, ()))
        stack = [(root, 1.0, 0, frozenset({start}))]
        while stack:
            node, fraction, depth, seen = stack.pop()
            if depth >= max_depth:
                continue
            for b, w in succs.get(node.name, []):
                if b in seen:
                    continue
                frac = fraction * (w / total_in[b])
                child = CCTOut(b, csamples.get(b, 0.0) * frac, [],
                               members.get(b, ()))
                node.children.append(child)
                stack.append((child, frac, depth + 1, seen | {b}))
        return root

    root = CCTOut("<gpu root>", 0.0, [])
    for r in roots:
        root.children.append(build(r))
    return root
