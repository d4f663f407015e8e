"""Streamlining with SIRA (paper §4.1.2): scale/bias aggregation.

Two phases:

  1. **Explicitize quantizers** — rewrite every ``Quant(x, s, z, b)`` into
         Div(s) → Add(z) → Quant(scale=1, zp=0, b) → Sub(z) → Mul(s)
     so that all scales/biases live in explicit elementwise constant ops
     inside affine regions (weight branches are constant-folded down to the
     integer tensor, keeping the trailing Mul(s_w) explicit).  This is the
     generic form of "duplicating shared scales" from the paper's step (1).

  2. **Aggregate** — run SIRA with contribution tracking; for every *target
     tensor* (a scaled-int tensor feeding a non-linear boundary node or a
     graph output), insert a single Mul(aggr_scale)+Add(aggr_bias) and erase
     all contributing constants (1 for scale contributions, 0 for bias
     contributions), then remove identity ops (paper steps 2-5).

Safety: a contributor is only erased if *every* downstream boundary it can
reach is an aggregating target (otherwise its effect would be silently
dropped); targets containing unsafe contributors are skipped, to fixpoint.

This module holds the *graph-rewrite cores* (in-place, change-reporting);
the pipeline entry points are the :class:`~repro_torch.core.passes.Transformation`
classes in ``passes.py`` (the pre-``SiraModel`` function-style shims that
used to live at the bottom of this file are gone — drive the cores through
``passes.Streamline`` / ``flow.build_flow``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .graph import Graph, Node, fresh_name, quant_bounds, round_half_to_even
from .intervals import ScaledIntRange
from .propagate import POISON

# ops that end an affine region (paper: activations form the boundary).
# MaxPool is *not* a boundary: max(s*q+b) = s*max(q)+b for s>0, so scales
# commute past it (classic FINN reordering) and SIRA keeps the structure.
NONLINEAR_OPS = {"Relu", "Sigmoid", "Tanh", "Softcap", "Silu", "Gelu",
                 "Quant", "MultiThreshold", "Softmax", "Clip",
                 "Floor", "Round"}

# elementwise constant ops that SIRA can absorb
ABSORBABLE = {"Mul", "Div", "Add", "Sub"}


# --------------------------------------------------------------------------
# phase 1: explicitize quantizers
# --------------------------------------------------------------------------

def explicitize_quantizers_inplace(g: Graph) -> bool:
    """Rewrite non-trivial Quant nodes in place; returns True if changed."""
    g.toposort()
    new_nodes: List[Node] = []
    changed = False
    for node in g.nodes:
        if node.op_type != "Quant":
            new_nodes.append(node)
            continue
        x, s_name, z_name, b_name = node.inputs
        s = g.initializers[s_name]
        z = g.initializers[z_name]
        bits = g.initializers[b_name]
        out = node.outputs[0]
        trivial = bool(np.all(s == 1.0) and np.all(z == 0.0))
        if trivial:
            new_nodes.append(node)
            continue
        changed = True
        if g.is_constant(x):
            # weight branch: fold the integer part, keep Mul(s) explicit
            signed = bool(node.attrs.get("signed", 1))
            narrow = bool(node.attrs.get("narrow", 0))
            qmin, qmax = quant_bounds(int(bits), signed, narrow)
            w = g.initializers[x]
            q = np.clip(round_half_to_even(w / s + z), qmin, qmax)
            qint_name = g.add_initializer(q - z, name=fresh_name("q_" + x))
            mul = Node("Mul", [qint_name, s_name], [out],
                       name=fresh_name("wscale"))
            new_nodes.append(mul)
            continue
        # dynamic branch: Div → Add(z) → Quant(1,0) → Sub(z) → Mul(s)
        t_div = fresh_name(x + "_divs")
        new_nodes.append(Node("Div", [x, s_name], [t_div]))
        cur = t_div
        if np.any(z != 0):
            t_addz = fresh_name(x + "_addz")
            new_nodes.append(Node("Add", [cur, z_name], [t_addz]))
            cur = t_addz
        one = g.add_initializer(np.ones(()), name=fresh_name("one"))
        zero = g.add_initializer(np.zeros(()), name=fresh_name("zero"))
        t_q = fresh_name(x + "_q")
        new_nodes.append(Node("Quant", [cur, one, zero, b_name], [t_q],
                              dict(node.attrs)))
        cur = t_q
        if np.any(z != 0):
            t_subz = fresh_name(x + "_subz")
            new_nodes.append(Node("Sub", [cur, z_name], [t_subz]))
            cur = t_subz
        new_nodes.append(Node("Mul", [cur, s_name], [out],
                              name=fresh_name("qscale")))
    if changed:
        g.nodes = new_nodes
        g.toposort()
    return changed


def duplicate_shared_constants_inplace(g: Graph) -> bool:
    """Give every (node, input-slot) its own private copy of any constant
    consumed more than once (paper §4.1.2 step 1).  In place."""
    seen: Dict[str, int] = {}
    changed = False
    for node in g.nodes:
        for i, t in enumerate(node.inputs):
            if not g.is_constant(t):
                continue
            if t not in seen:
                seen[t] = 1
                continue
            new_name = g.add_initializer(g.initializers[t],
                                         name=fresh_name(t + "_dup"))
            node.inputs[i] = new_name
            changed = True
    if changed:
        g.touch()
    return changed


# --------------------------------------------------------------------------
# phase 2: aggregation
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AggregationResult:
    graph: Graph
    targets: Dict[str, ScaledIntRange]   # target tensor -> range used
    erased: Set[str]


def _boundary_tensors(g: Graph) -> Set[str]:
    out = set(g.outputs)
    for n in g.nodes:
        if n.op_type in NONLINEAR_OPS:
            out.add(n.inputs[0])
    return out


def _erase_value(node: Node, slot: int) -> Optional[float]:
    if node.op_type in ("Mul", "Div"):
        return 1.0
    if node.op_type in ("Add", "Sub"):
        return 0.0
    if node.op_type in ("Gemm", "Conv") and slot == 2:
        return 0.0
    return None


def _reaches_only_targets(g: Graph, const_name: str,
                          targets: Set[str]) -> bool:
    """BFS downstream from the constant; every path must hit a target
    tensor before any non-target boundary (non-linear input or output)."""
    start_nodes = g.consumers(const_name)
    frontier = [t for n in start_nodes for t in n.outputs]
    visited: Set[str] = set()
    while frontier:
        t = frontier.pop()
        if t in visited:
            continue
        visited.add(t)
        if t in targets:
            continue  # re-added here; stop this branch
        if t in g.outputs:
            return False
        for m in g.consumers(t):
            if m.op_type in NONLINEAR_OPS:
                return False
            frontier.extend(m.outputs)
    return True


def aggregate_with_ranges(g: Graph,
                          ranges: Dict[str, ScaledIntRange]
                          ) -> Tuple[AggregationResult, bool]:
    """Scale/bias aggregation core: mutate ``g`` in place given a range
    analysis of it (with contribution tracking).  The graph must already be
    explicitized and have per-consumer private constants (see the in-place
    helpers above).  Returns (result, changed)."""
    boundaries = _boundary_tensors(g)
    # candidate targets: scaled-int boundary tensors with erasable content
    targets: Dict[str, ScaledIntRange] = {}
    for t in boundaries:
        r = ranges.get(t)
        if r is None or not r.is_scaled_int:
            continue
        contribs = r.scale_src | r.bias_src
        if POISON in contribs or not contribs:
            continue
        if g.producer(t) is None:
            continue  # graph input — nothing upstream to erase
        targets[t] = r

    # Drop a target t2 when a shared contributor's effect is already
    # restored by an *affinely upstream* target t1 (no Quant anchor in
    # between) — re-adding at t2 would double-count.  Residual joins whose
    # branches pass through quantizers are unaffected: contribution sets
    # are anchored (cleared) at every trivial Quant.
    g.toposort()
    topo_idx = {t: i for i, n in enumerate(g.nodes) for t in n.outputs}

    def _affine_ancestor_targets(t: str) -> Set[str]:
        """Targets reachable from t walking producers through affine ops."""
        seen: Set[str] = set()
        stack = [t]
        anc: Set[str] = set()
        while stack:
            cur = stack.pop()
            prod = g.producer(cur)
            if prod is None or prod.op_type in NONLINEAR_OPS:
                continue  # anchor: contributions do not cross
            for ti in prod.inputs:
                if ti in seen:
                    continue
                seen.add(ti)
                if ti in targets and ti != t:
                    anc.add(ti)
                stack.append(ti)
        return anc

    for t in sorted(targets, key=lambda x: topo_idx.get(x, 0)):
        shared = set()
        for a in _affine_ancestor_targets(t):
            if a in targets:
                shared |= (targets[a].scale_src | targets[a].bias_src)
        if (targets[t].scale_src | targets[t].bias_src) & shared:
            del targets[t]

    # fixpoint: drop targets whose contributors also reach non-targets
    while True:
        tset = set(targets)
        erase: Set[str] = set()
        for r in targets.values():
            erase |= (r.scale_src | r.bias_src)
        bad_consts = {c for c in erase
                      if not _reaches_only_targets(g, c, tset)}
        if not bad_consts:
            break
        targets = {t: r for t, r in targets.items()
                   if not ((r.scale_src | r.bias_src) & bad_consts)}
        if not targets:
            break

    erase = set()
    for r in targets.values():
        erase |= (r.scale_src | r.bias_src)

    # insert aggregated Mul/Add at each target
    for t, r in targets.items():
        s_val = np.asarray(r.scale)
        b_val = np.asarray(r.bias)
        consumers = [(n, i) for n in g.consumers(t)
                     for i, ti in enumerate(n.inputs) if ti == t]
        is_out = t in g.outputs
        cur = t
        if not np.all(s_val == 1.0):
            s_name = g.add_initializer(s_val, name=fresh_name("aggr_scale"))
            nt = fresh_name(t + "_scaled")
            g.add_node("Mul", [cur, s_name], [nt], name=fresh_name("aggr"))
            cur = nt
        if not np.all(b_val == 0.0):
            b_name = g.add_initializer(b_val, name=fresh_name("aggr_bias"))
            nt = fresh_name(t + "_biased")
            g.add_node("Add", [cur, b_name], [nt], name=fresh_name("aggr"))
            cur = nt
        if cur != t:
            for n, i in consumers:
                n.inputs[i] = cur
            if is_out:
                g.outputs = [cur if o == t else o for o in g.outputs]
            g.touch()

    # erase contributing constants (value edits → touch below)
    for c in erase:
        for n in g.consumers(c):
            for i, ti in enumerate(n.inputs):
                if ti != c:
                    continue
                v = _erase_value(n, i)
                if v is None:
                    raise RuntimeError(
                        f"cannot erase contributor {c} at {n.op_type}")
                g.initializers[c] = np.full_like(g.initializers[c], v)
    if erase:
        g.touch()

    changed = bool(targets) or bool(erase)
    changed |= remove_identity_ops(g)
    g.toposort()
    g.dead_code_eliminate()
    return AggregationResult(graph=g, targets=targets, erased=erase), changed


def remove_identity_ops(g: Graph) -> bool:
    """Remove Mul(x,1), Div(x,1), Add(x,0), Sub(x,0) (paper step 5).
    In place; returns True if any node was removed."""
    any_changed = False
    changed = True
    while changed:
        changed = False
        for n in list(g.nodes):
            if n.op_type not in ABSORBABLE or len(n.inputs) != 2:
                continue
            c = n.inputs[1]
            if not g.is_constant(c):
                continue
            v = g.initializers[c]
            ident = (np.all(v == 1.0) if n.op_type in ("Mul", "Div")
                     else np.all(v == 0.0))
            if not ident:
                continue
            src, dst = n.inputs[0], n.outputs[0]
            g.remove_node(n)
            g.replace_input(dst, src)
            changed = any_changed = True
    return any_changed
