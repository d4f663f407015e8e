"""A lightweight QONNX-like graph IR.

The paper implements SIRA as a shared optimization over QONNX graphs. We
mirror the essentials here: a flat list of nodes over named tensors, a dict
of constant initializers, declared graph inputs/outputs, plus a numpy
executor used by (a) the threshold-conversion subgraph evaluation (§4.1.3),
(b) streamline-equivalence tests and (c) instrumentation-based verification
(§6.1).

Layout conventions (matching ONNX):
  * MatMul:   x (..., K) @ W (K, M)       — channels last
  * Conv:     x (N, C, H, W), W (Cout, Cin/groups, kh, kw)  — channels first
Per-channel parameter arrays use broadcastable shapes, e.g. (M,) for MatMul
outputs and (Cout, 1, 1) for Conv outputs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ops import EXEC_REGISTRY, register_op  # noqa: F401  (re-exported)

Array = np.ndarray


# --------------------------------------------------------------------------
# IR
# --------------------------------------------------------------------------

_counter = itertools.count()


def fresh_name(prefix: str) -> str:
    return f"{prefix}_{next(_counter)}"


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = fresh_name(self.op_type)


class Graph:
    def __init__(self, inputs: Sequence[str] = (), outputs: Sequence[str] = ()):
        self._version = 0
        self._nodes: List[Node] = []
        self.initializers: Dict[str, Array] = {}
        self.inputs: List[str] = list(inputs)
        self.outputs: List[str] = list(outputs)
        # lazily-built producer/consumer maps, keyed on cache_key
        self._idx_version = None
        self._producers: Dict[str, Node] = {}
        self._consumers: Dict[str, List[Node]] = {}

    # ----------------------------------------------------------- versioning
    @property
    def version(self) -> int:
        """Monotonic mutation counter.  ``SiraModel`` keys its cached range
        analysis on this; every structural edit made through the Graph API
        bumps it.  ``nodes`` returns the *live* internal list — code that
        mutates it directly (``g.nodes.append(...)``) or edits
        ``node.inputs`` / initializer values in place must call ``touch()``.
        As a safety net, cache consumers key on ``cache_key`` (version,
        node count), which also catches raw list append/remove."""
        return self._version

    @property
    def cache_key(self) -> Tuple[int, int]:
        return (self._version, len(self._nodes))

    def touch(self) -> None:
        """Mark the graph as mutated (invalidates indexes and any cached
        analysis).  Call after editing ``node.inputs``/``node.outputs`` or
        initializer *values* in place — the editing methods below call it
        automatically."""
        self._version += 1

    @property
    def nodes(self) -> List[Node]:
        return self._nodes

    @nodes.setter
    def nodes(self, value: Sequence[Node]) -> None:
        self._nodes = list(value)
        self.touch()

    # -------------------------------------------------------------- editing
    def add_node(self, op_type: str, inputs: Sequence[str],
                 outputs: Optional[Sequence[str]] = None,
                 attrs: Optional[Dict[str, Any]] = None,
                 name: str = "") -> Node:
        if outputs is None:
            outputs = [fresh_name(op_type.lower() + "_out")]
        node = Node(op_type, list(inputs), list(outputs), dict(attrs or {}),
                    name=name)
        self._nodes.append(node)
        self.touch()
        return node

    def add_initializer(self, value, name: Optional[str] = None) -> str:
        name = name or fresh_name("const")
        self.initializers[name] = np.asarray(value, dtype=np.float64)
        self.touch()
        return name

    def is_constant(self, tensor: str) -> bool:
        return tensor in self.initializers

    def _index(self) -> None:
        if self._idx_version == self.cache_key:
            return
        producers: Dict[str, Node] = {}
        consumers: Dict[str, List[Node]] = {}
        for n in self._nodes:
            for t in n.outputs:
                if t not in producers:
                    producers[t] = n
            for t in set(n.inputs):
                consumers.setdefault(t, []).append(n)
        self._producers = producers
        self._consumers = consumers
        self._idx_version = self.cache_key

    def producer(self, tensor: str) -> Optional[Node]:
        self._index()
        return self._producers.get(tensor)

    def consumers(self, tensor: str) -> List[Node]:
        self._index()
        return list(self._consumers.get(tensor, ()))

    def remove_node(self, node: Node) -> None:
        self._nodes.remove(node)
        self.touch()

    def replace_input(self, old: str, new: str) -> None:
        """Rewire every consumer of ``old`` (and the graph outputs) to read
        ``new`` instead."""
        for n in self.consumers(old):
            n.inputs = [new if t == old else t for t in n.inputs]
        if old in self.outputs:
            self.outputs = [new if o == old else o for o in self.outputs]
        self.touch()

    def toposort(self) -> None:
        """Stable topological sort of self.nodes."""
        produced = set(self.inputs) | set(self.initializers)
        remaining = list(self._nodes)
        ordered: List[Node] = []
        while remaining:
            progress = False
            for n in list(remaining):
                if all(i in produced for i in n.inputs):
                    ordered.append(n)
                    produced.update(n.outputs)
                    remaining.remove(n)
                    progress = True
            if not progress:
                missing = {i for n in remaining for i in n.inputs
                           if i not in produced}
                raise ValueError(f"graph has a cycle or dangling inputs: "
                                 f"{sorted(missing)[:5]}")
        if ordered != self._nodes:     # already sorted → keep version (and
            self.nodes = ordered       # any cached analysis) intact

    def dead_code_eliminate(self) -> None:
        live = set(self.outputs)
        keep: List[Node] = []
        for n in reversed(self._nodes):
            if any(o in live for o in n.outputs):
                keep.append(n)
                live.update(n.inputs)
        keep = list(reversed(keep))
        inits = {k: v for k, v in self.initializers.items() if k in live}
        if keep != self._nodes or len(inits) != len(self.initializers):
            self.nodes = keep
            self.initializers = inits
            self.touch()

    def copy(self) -> "Graph":
        g = Graph(self.inputs, self.outputs)
        g.nodes = [Node(n.op_type, list(n.inputs), list(n.outputs),
                        dict(n.attrs), name=n.name) for n in self.nodes]
        g.initializers = {k: v.copy() for k, v in self.initializers.items()}
        return g

    # ------------------------------------------------------------ execution
    def execute(self, feeds: Dict[str, Array],
                want: Optional[Sequence[str]] = None,
                record_all: bool = False) -> Dict[str, Array]:
        """Numpy forward execution. Returns {tensor: value} for ``want``
        (default: graph outputs), or every intermediate if record_all."""
        env: Dict[str, Array] = {k: np.asarray(v, dtype=np.float64)
                                 for k, v in self.initializers.items()}
        env.update({k: np.asarray(v, dtype=np.float64)
                    for k, v in feeds.items()})
        for node in self.nodes:
            fn = EXEC_REGISTRY.get(node.op_type)
            if fn is None:
                raise NotImplementedError(f"no executor for {node.op_type}")
            args = [env[i] for i in node.inputs]
            outs = fn(node, *args)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for name, val in zip(node.outputs, outs):
                env[name] = np.asarray(val, dtype=np.float64)
        if record_all:
            return env
        want = list(want) if want is not None else self.outputs
        return {k: env[k] for k in want}


# --------------------------------------------------------------------------
# op executors (registered into the unified ops.OP_REGISTRY)
# --------------------------------------------------------------------------

def executor(op_type: str):
    def deco(fn):
        register_op(op_type, execute=fn)
        return fn
    return deco


def quant_bounds(bitwidth: int, signed: bool, narrow: bool) -> Tuple[float, float]:
    b = int(bitwidth)
    if signed:
        qmin = -(2 ** (b - 1)) + (1 if narrow else 0)
        qmax = 2 ** (b - 1) - 1
    else:
        qmin = 0
        qmax = 2 ** b - 1
    return float(qmin), float(qmax)


def round_half_to_even(x: Array) -> Array:
    return np.round(x)  # numpy rounds half to even, matching ONNX Round


@executor("Quant")
def _exec_quant(node, x, scale, zero_point, bitwidth):
    signed = bool(node.attrs.get("signed", 1))
    narrow = bool(node.attrs.get("narrow", 0))
    qmin, qmax = quant_bounds(int(bitwidth), signed, narrow)
    q = np.clip(round_half_to_even(x / scale + zero_point), qmin, qmax)
    return scale * (q - zero_point)


@executor("MultiThreshold")
def _exec_multithreshold(node, x, thresholds, *rest):
    """x: (..., C) if axis=-1 (MatMul style) or (N, C, ...) if axis=1.
    thresholds: (C, N) ascending. out = bias + scale * sum_i(x >= thr_i).
    out_scale/out_bias: scalar, or (C,) per-channel arrays."""
    axis = int(node.attrs.get("axis", -1))
    out_scale = np.asarray(node.attrs.get("out_scale", 1.0), dtype=np.float64)
    out_bias = np.asarray(node.attrs.get("out_bias", 0.0), dtype=np.float64)
    C, N = thresholds.shape
    xm = np.moveaxis(x, axis, -1)  # (..., C)
    cnt = (xm[..., :, None] >= thresholds).sum(axis=-1)  # (..., C)
    out = out_bias + out_scale * cnt
    return np.moveaxis(out.astype(np.float64), -1, axis)


@executor("MatMul")
def _exec_matmul(node, a, b):
    return a @ b


@executor("Gemm")
def _exec_gemm(node, a, b, c=None):
    y = a @ b
    return y + c if c is not None else y


def _im2col(x: Array, kh: int, kw: int, stride: int, pad: int) -> Array:
    n, c, h, w = x.shape
    if pad:
        x = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho = (x.shape[2] - kh) // stride + 1
    wo = (x.shape[3] - kw) // stride + 1
    cols = np.empty((n, c, kh, kw, ho, wo), dtype=x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, i, j] = x[:, :, i:i + stride * ho:stride,
                                 j:j + stride * wo:stride]
    return cols.reshape(n, c * kh * kw, ho * wo), ho, wo


@executor("Conv")
def _exec_conv(node, x, w, b=None):
    stride = int(node.attrs.get("stride", 1))
    pad = int(node.attrs.get("pad", 0))
    groups = int(node.attrs.get("groups", 1))
    cout, cin_g, kh, kw = w.shape
    n, c, _, _ = x.shape
    assert c == cin_g * groups
    outs = []
    for g in range(groups):
        xg = x[:, g * cin_g:(g + 1) * cin_g]
        wg = w[g * (cout // groups):(g + 1) * (cout // groups)]
        cols, ho, wo = _im2col(xg, kh, kw, stride, pad)
        wmat = wg.reshape(cout // groups, cin_g * kh * kw)
        outs.append(np.einsum("ok,nkp->nop", wmat, cols).reshape(
            n, cout // groups, ho, wo))
    y = np.concatenate(outs, axis=1)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


@executor("Add")
def _exec_add(node, a, b):
    return a + b


@executor("Sub")
def _exec_sub(node, a, b):
    return a - b


@executor("Mul")
def _exec_mul(node, a, b):
    return a * b


@executor("Div")
def _exec_div(node, a, b):
    return a / b


@executor("Relu")
def _exec_relu(node, x):
    return np.maximum(x, 0.0)


@executor("Sigmoid")
def _exec_sigmoid(node, x):
    return 1.0 / (1.0 + np.exp(-x))


@executor("Tanh")
def _exec_tanh(node, x):
    return np.tanh(x)


@executor("Softcap")
def _exec_softcap(node, x):
    cap = float(node.attrs["cap"])
    return cap * np.tanh(x / cap)


@executor("Silu")
def _exec_silu(node, x):
    return x / (1.0 + np.exp(-x))


@executor("Gelu")
def _exec_gelu(node, x):
    from scipy.special import erf
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


@executor("HardSwish")
def _exec_hardswish(node, x):
    return x * np.clip(x + 3.0, 0.0, 6.0) / 6.0


@executor("Abs")
def _exec_abs(node, x):
    return np.abs(x)


@executor("Clip")
def _exec_clip(node, x, lo=None, hi=None):
    lo = -np.inf if lo is None else lo
    hi = np.inf if hi is None else hi
    return np.clip(x, lo, hi)


@executor("Floor")
def _exec_floor(node, x):
    return np.floor(x)


@executor("Round")
def _exec_round(node, x):
    return round_half_to_even(x)


@executor("Concat")
def _exec_concat(node, *xs):
    return np.concatenate(xs, axis=int(node.attrs.get("axis", -1)))


@executor("MaxPool")
def _exec_maxpool(node, x):
    k = int(node.attrs.get("kernel", 2))
    s = int(node.attrs.get("stride", k))
    n, c, h, w = x.shape
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    out = np.full((n, c, ho, wo), -np.inf)
    for i in range(k):
        for j in range(k):
            out = np.maximum(out, x[:, :, i:i + s * ho:s, j:j + s * wo:s])
    return out


@executor("AveragePool")
def _exec_avgpool(node, x):
    k = int(node.attrs.get("kernel", 2))
    s = int(node.attrs.get("stride", k))
    n, c, h, w = x.shape
    ho, wo = (h - k) // s + 1, (w - k) // s + 1
    out = np.zeros((n, c, ho, wo))
    for i in range(k):
        for j in range(k):
            out = out + x[:, :, i:i + s * ho:s, j:j + s * wo:s]
    return out / (k * k)


@executor("GlobalAveragePool")
def _exec_gap(node, x):
    return x.mean(axis=(2, 3), keepdims=True)


@executor("Flatten")
def _exec_flatten(node, x):
    return x.reshape(x.shape[0], -1)


@executor("Reshape")
def _exec_reshape(node, x):
    return x.reshape(node.attrs["shape"])


@executor("Transpose")
def _exec_transpose(node, x):
    return np.transpose(x, node.attrs["perm"])


@executor("Identity")
def _exec_identity(node, x):
    return x


@executor("Gather")
def _exec_gather(node, table, idx):
    return table[idx.astype(np.int64)]


@executor("Softmax")
def _exec_softmax(node, x):
    ax = int(node.attrs.get("axis", -1))
    z = x - x.max(axis=ax, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=ax, keepdims=True)
