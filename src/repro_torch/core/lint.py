"""Graph linter: static well-formedness checks over the SIRA IR.

``lint_graph`` runs three layers of checks and returns a
:class:`LintReport` of node-level findings:

  * **structural** — dangling node inputs (no producer, not an initializer
    or graph input), unproduced graph outputs, two producers for one
    tensor, cycles, ops with no registered executor / propagation handler,
    nodes with no path to a graph output (warning);
  * **shape / dtype** — lightweight forward shape inference (seeded from
    initializer shapes and optional declared ``input_shapes``) catching
    MatMul/Gemm contraction mismatches, Conv weight-rank / channel /
    groups inconsistencies, non-broadcastable elementwise operands,
    MultiThreshold threshold tables that are not 2-D with ascending rows,
    Quant parameter inputs that are not constants;
  * **range soundness** — every declared / computed ``ScaledIntRange``
    must pass :meth:`ScaledIntRange.validate` (inverted or NaN bounds,
    non-positive scales — the :class:`InvalidRangeError` invariants), and
    scale/bias contribution sets may only name existing constants or the
    ``POISON`` marker.

The linter never mutates the graph (no ``toposort()``, no index writes
besides the lazily-built producer map the Graph already maintains).
``passes.LintGraph`` wraps it as a pipeline step and ``build_flow`` runs
it as a pre-flow verification hook (``BuildConfig.lint``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, Node
from .intervals import InvalidRangeError, ScaledIntRange
from .ops import EXEC_REGISTRY, PROP_REGISTRY

Shape = Tuple[int, ...]


class LintError(ValueError):
    """Raised by strict lint runs when error-level findings exist."""

    def __init__(self, report: "LintReport"):
        self.report = report
        msgs = "; ".join(str(f) for f in report.errors[:5])
        more = len(report.errors) - 5
        super().__init__(
            f"graph lint failed: {msgs}" +
            (f" (+{more} more)" if more > 0 else ""))


@dataclasses.dataclass(frozen=True)
class LintFinding:
    level: str          # "error" | "warning"
    rule: str           # stable rule id, e.g. "dangling-input"
    node: str           # node name ("" for graph-level findings)
    message: str

    def __str__(self) -> str:
        where = f" @ {self.node}" if self.node else ""
        return f"[{self.rule}{where}] {self.message}"


@dataclasses.dataclass
class LintReport:
    findings: List[LintFinding] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[LintFinding]:
        return [f for f in self.findings if f.level == "error"]

    @property
    def warnings(self) -> List[LintFinding]:
        return [f for f in self.findings if f.level == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        return (f"{len(self.errors)} errors, "
                f"{len(self.warnings)} warnings")

    def __str__(self) -> str:
        if not self.findings:
            return "lint: clean"
        return "\n".join(str(f) for f in self.findings)


class _Linter:
    def __init__(self, graph: Graph):
        self.graph = graph
        self.report = LintReport()

    def error(self, rule: str, node: str, msg: str) -> None:
        self.report.findings.append(LintFinding("error", rule, node, msg))

    def warn(self, rule: str, node: str, msg: str) -> None:
        self.report.findings.append(LintFinding("warning", rule, node, msg))


# --------------------------------------------------------------------------
# structural checks
# --------------------------------------------------------------------------

def _check_structure(lt: _Linter) -> None:
    g = lt.graph
    produced: Dict[str, Node] = {}
    for n in g.nodes:
        for t in n.outputs:
            if t in produced:
                lt.error("duplicate-producer", n.name,
                         f"tensor {t!r} produced by both "
                         f"{produced[t].name!r} and {n.name!r}")
            else:
                produced[t] = n
        if not n.outputs:
            lt.error("no-outputs", n.name, "node declares no outputs")

    known = set(g.inputs) | set(g.initializers)
    for n in g.nodes:
        for t in n.inputs:
            if t not in known and t not in produced:
                lt.error("dangling-input", n.name,
                         f"input tensor {t!r} has no producer and is "
                         f"neither a graph input nor an initializer")
        if t_over := (set(n.outputs) & known):
            lt.error("shadowed-tensor", n.name,
                     f"output(s) {sorted(t_over)} shadow a graph "
                     f"input/initializer")
    for t in g.outputs:
        if t not in known and t not in produced:
            lt.error("dangling-output", "",
                     f"graph output {t!r} is never produced")

    # cycle check: Kahn's algorithm without mutating the graph
    ready = set(known)
    remaining = list(g.nodes)
    progress = True
    while remaining and progress:
        progress = False
        rest = []
        for n in remaining:
            if all(t in ready for t in n.inputs):
                ready.update(n.outputs)
                progress = True
            else:
                rest.append(n)
        remaining = rest
    for n in remaining:
        # only blame nodes whose inputs all *have* producers (pure cycle
        # members) — dangling inputs were already reported above
        if all(t in produced or t in known for t in n.inputs):
            lt.error("cycle", n.name, "node participates in a cycle")

    for n in g.nodes:
        if EXEC_REGISTRY.get(n.op_type) is None:
            lt.warn("no-executor", n.name,
                    f"op {n.op_type!r} has no registered executor")
        if PROP_REGISTRY.get(n.op_type) is None:
            lt.error("no-handler", n.name,
                     f"op {n.op_type!r} has no SIRA propagation handler")

    # reachability: nodes that cannot influence any graph output
    needed = set(g.outputs)
    for n in reversed(_topo_order(g, produced, known)):
        if any(t in needed for t in n.outputs):
            needed.update(n.inputs)
    for n in g.nodes:
        if not any(t in needed for t in n.outputs):
            lt.warn("dead-node", n.name,
                    "node output never reaches a graph output")


def _topo_order(g: Graph, produced: Dict[str, Node], known) -> List[Node]:
    ready = set(known)
    ordered: List[Node] = []
    remaining = list(g.nodes)
    progress = True
    while remaining and progress:
        progress = False
        rest = []
        for n in remaining:
            if all(t in ready for t in n.inputs):
                ready.update(n.outputs)
                ordered.append(n)
                progress = True
            else:
                rest.append(n)
        remaining = rest
    return ordered + remaining      # cycle members appended, order moot


# --------------------------------------------------------------------------
# shape checks (lightweight forward inference; None = unknown)
# --------------------------------------------------------------------------

def _broadcastable(a: Shape, b: Shape) -> bool:
    try:
        np.broadcast_shapes(a, b)
        return True
    except ValueError:
        return False


def _infer_shapes(lt: _Linter,
                  input_shapes: Optional[Dict[str, Shape]]
                  ) -> Dict[str, Optional[Shape]]:
    g = lt.graph
    shapes: Dict[str, Optional[Shape]] = {
        k: tuple(v.shape) for k, v in g.initializers.items()}
    for k, s in (input_shapes or {}).items():
        shapes[k] = tuple(s)

    produced = {t: n for n in g.nodes for t in n.outputs}
    known = set(g.inputs) | set(g.initializers)
    for node in _topo_order(g, produced, known):
        ins = [shapes.get(t) for t in node.inputs]
        out = _check_node_shapes(lt, node, ins)
        for t in node.outputs:
            shapes[t] = out
    return shapes


def infer_shapes(graph: Graph,
                 input_shapes: Optional[Dict[str, Shape]] = None
                 ) -> Dict[str, Optional[Shape]]:
    """Every tensor's shape as the linter infers it (``None`` where
    unknown), from the initializers and the declared ``input_shapes``."""
    return _infer_shapes(_Linter(graph), input_shapes)


def contraction_dim(graph: Graph, node: Node,
                    input_shapes: Optional[Dict[str, Shape]] = None
                    ) -> Optional[int]:
    """The contraction length K of a ``MatMul``/``Gemm`` node: the first
    dim of its 2-D second operand, else the last dim of its first
    operand; ``None`` when shape inference knows neither."""
    shapes = infer_shapes(graph, input_shapes)
    a, b = (shapes.get(t) for t in node.inputs[:2])
    if b is not None and len(b) == 2:
        return int(b[0])
    if a:
        return int(a[-1])
    return None


def _check_node_shapes(lt: _Linter, node: Node,
                       ins: Sequence[Optional[Shape]]
                       ) -> Optional[Shape]:
    op = node.op_type
    g = lt.graph

    if op in ("Add", "Sub", "Mul", "Div"):
        a, b = (ins + [None, None])[:2]
        if a is not None and b is not None:
            if not _broadcastable(a, b):
                lt.error("broadcast-mismatch", node.name,
                         f"{op} operands {a} x {b} do not broadcast")
                return None
            return tuple(np.broadcast_shapes(a, b))
        return None

    if op in ("MatMul", "Gemm"):
        a, b = (ins + [None, None])[:2]
        if a is not None and b is not None and a and b:
            if len(b) != 2:
                lt.error("weight-rank", node.name,
                         f"{op} second operand must be 2-D, got {b}")
                return None
            if a[-1] != b[0]:
                lt.error("contraction-mismatch", node.name,
                         f"{op} contraction K mismatch: x {a} @ W {b}")
                return None
            out = a[:-1] + (b[1],)
            if op == "Gemm" and len(ins) > 2 and ins[2] is not None \
                    and not _broadcastable(out, ins[2]):
                lt.error("broadcast-mismatch", node.name,
                         f"Gemm bias {ins[2]} does not broadcast to {out}")
            return out
        return None

    if op == "Conv":
        w = ins[1] if len(ins) > 1 else None
        groups = int(node.attrs.get("groups", 1))
        if w is not None:
            if len(w) != 4:
                lt.error("weight-rank", node.name,
                         f"Conv weight must be 4-D, got {w}")
                return None
            cout, cin_g = w[0], w[1]
            if cout % groups != 0:
                lt.error("groups-mismatch", node.name,
                         f"Conv groups={groups} does not divide "
                         f"Cout={cout}")
            x = ins[0]
            if x is not None and len(x) == 4 and x[1] != cin_g * groups:
                lt.error("channels-mismatch", node.name,
                         f"Conv input has {x[1]} channels, weight "
                         f"expects {cin_g * groups} "
                         f"(Cin/g={cin_g}, groups={groups})")
            x = ins[0]
            if x is not None and len(x) == 4:
                stride = int(node.attrs.get("stride", 1))
                pad = int(node.attrs.get("pad", 0))
                ho = (x[2] + 2 * pad - w[2]) // stride + 1
                wo = (x[3] + 2 * pad - w[3]) // stride + 1
                if ho <= 0 or wo <= 0:
                    lt.error("empty-output", node.name,
                             f"Conv output spatial dims ({ho}, {wo}) "
                             f"are empty")
                    return None
                return (x[0], cout, ho, wo)
        return None

    if op in ("MaxPool", "AveragePool"):
        x = ins[0]
        if x is not None and len(x) == 4:
            k = int(node.attrs.get("kernel", 2))
            s = int(node.attrs.get("stride", k))
            ho, wo = (x[2] - k) // s + 1, (x[3] - k) // s + 1
            if ho <= 0 or wo <= 0:
                lt.error("empty-output", node.name,
                         f"{op} output spatial dims ({ho}, {wo}) are "
                         f"empty")
                return None
            return (x[0], x[1], ho, wo)
        return None

    if op == "MultiThreshold":
        thr_name = node.inputs[1] if len(node.inputs) > 1 else None
        if thr_name is None or not g.is_constant(thr_name):
            lt.error("const-required", node.name,
                     "MultiThreshold thresholds must be a constant")
            return None
        thr = g.initializers[thr_name]
        if thr.ndim != 2:
            lt.error("threshold-rank", node.name,
                     f"thresholds must be 2-D (C, N), got shape "
                     f"{tuple(thr.shape)}")
            return ins[0]
        if thr.shape[1] > 1 and not np.all(np.diff(thr, axis=1) >= 0):
            lt.error("threshold-order", node.name,
                     "threshold rows must be ascending")
        x = ins[0]
        if x is not None:
            C = thr.shape[0]
            axis = int(node.attrs.get("axis", -1))
            ch = x[1] if axis == 1 and len(x) >= 2 else \
                (x[-1] if x else None)
            if ch is not None and ch != C:
                lt.error("channels-mismatch", node.name,
                         f"input has {ch} channels on axis {axis}, "
                         f"thresholds declare {C}")
        return ins[0]

    if op == "Quant":
        for i, role in ((1, "scale"), (2, "zero-point"), (3, "bits")):
            if len(node.inputs) > i and \
                    not g.is_constant(node.inputs[i]):
                lt.error("const-required", node.name,
                         f"Quant {role} input {node.inputs[i]!r} must "
                         f"be a constant")
        return ins[0]

    if op in ("Identity", "Relu", "Clip", "Sigmoid", "Tanh", "Floor",
              "Round", "Softcap", "Silu", "Gelu", "HardSwish", "Abs"):
        return ins[0]

    return None     # unknown op / data-dependent shape (Reshape, Concat...)


# --------------------------------------------------------------------------
# threshold-conversion certificate checks
# --------------------------------------------------------------------------

def _check_certificates(lt: _Linter) -> None:
    """Threshold conversions must carry a monotonicity certificate
    (paper §4.1.3 exactness only holds for certified-monotone tails), and
    tails the certifier rejected should be visible with their reason code
    — the DSE prices those as elementwise meta-kernels."""
    for n in lt.graph.nodes:
        if n.op_type == "MultiThreshold" and "certificate" not in n.attrs:
            lt.warn("uncertified-threshold", n.name,
                    "MultiThreshold without a monotonicity certificate — "
                    "Eq. 3 exactness is unverified for this conversion")
        reason = n.attrs.get("unconverted_reason")
        if reason is not None:
            lt.warn("unconverted-tail", n.name,
                    f"layer tail left unconverted ({reason}) — will be "
                    f"priced as an elementwise meta-kernel")


# --------------------------------------------------------------------------
# range checks
# --------------------------------------------------------------------------

def _check_ranges(lt: _Linter,
                  ranges: Dict[str, ScaledIntRange]) -> None:
    from .propagate import POISON
    g = lt.graph
    valid_src = set(g.initializers) | {POISON}
    for tensor, r in ranges.items():
        node = g.producer(tensor)
        where = node.name if node is not None else ""
        try:
            r.validate()
        except InvalidRangeError as e:
            lt.error("invalid-range", where,
                     f"range of {tensor!r} is unsound: {e}")
            continue
        for kind, src in (("scale_src", r.scale_src),
                          ("bias_src", r.bias_src)):
            stale = set(src) - valid_src
            if stale:
                lt.error("stale-contribution", where,
                         f"{kind} of {tensor!r} names non-constant "
                         f"tensors {sorted(stale)}")


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def lint_graph(graph: Graph,
               input_ranges: Optional[Dict[str, ScaledIntRange]] = None,
               input_shapes: Optional[Dict[str, Shape]] = None,
               ranges: Optional[Dict[str, ScaledIntRange]] = None
               ) -> LintReport:
    """Lint a graph; returns the report (never raises, never mutates).

    ``ranges`` — pre-computed analysis results to validate (e.g.
    ``model.ranges``); when omitted, only declared ``input_ranges`` are
    range-checked (the linter must stay useful on graphs too malformed to
    analyze).  ``input_shapes`` seeds shape inference for graph inputs.
    """
    lt = _Linter(graph)
    _check_structure(lt)
    _check_certificates(lt)
    _infer_shapes(lt, input_shapes)
    declared = dict(input_ranges or {})
    declared.update(ranges or {})
    if declared:
        _check_ranges(lt, declared)
    return lt.report
