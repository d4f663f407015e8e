"""The port's own program, counted: FLOPs, HBM bytes, kernel launches and
collectives, per op and per layer, with no card.

Counterpart of ``src/repro/roofline/hlo_cost.py``, which re-derives a
compiled cell's totals from the optimised HLO that XLA produced.  The
port has no compiler to ask.  :func:`analyze_program` runs the program
itself, eagerly, on ``meta`` tensors (shapes and dtypes, no storage, so
nothing is computed or allocated) and counts every ATen op that a
``TorchDispatchMode`` sees, in the forward and in the backward that
autograd runs.  The rules mirror ``hlo_cost``'s:

* **flops**: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``
  2·M·N·K, a convolution 2·outputs·(its kernel's inputs); elementwise
  ops and reductions the size of their result; data movement (copies,
  casts, ``cat``, gathers, scatters, fills) none;
* **bytes**: operand plus result bytes of every op that launches a
  kernel; views, aliases, allocations and metadata ops launch nothing and
  count nothing; a gather counts twice its result; an in-place write into
  part of a buffer (``index_put_``, ``copy_`` into a slice,
  ``index_copy_``, ``scatter_``) twice the part written, not the buffer
  (the reference's ``test_dus_counts_slice_not_stack`` rule); ``copy_``
  its source and its destination, ``fill_`` its destination;
* **launches**: one per op that launches a kernel;
* **the hand-written kernels** (``kernels/*.py``) count like XLA's
  fusions, at the call site: under a count each wrapper stops at its
  launch site, records the work of its kernel's ``work`` function (the
  kernel's own FLOPs and the HBM bytes of its inputs and outputs) as one
  launch, and returns its outputs unlaunched; nothing is built;
* **collectives**: a recording layout (``launch/mesh.py
  make_recording_layout``) records each collective of rank 0's program
  through the same ``CollectiveCounter`` that a gloo or NCCL run fills,
  and here as one launch moving its operand and its result.

Each op is also filed under the innermost ``obs`` span open when it
runs (``obs/trace.py``: during a count the global tracer is one that
keeps the spans' names; ``Model`` opens one per layer, the embedding,
the head and the loss, the train step one for the gradient sums, the
optimizer and the collectives around it).  An op of the backward is
filed under ``"<span>.backward"``, ``<span>`` the one open when autograd
made the node that runs it (nodes by their sequence numbers), so that a
layer's backward (its recomputation under ``remat`` included) is its
own.  Ops outside any span are filed under ``"(top)"``.

Why ``meta`` tensors and not fake CUDA tensors: a build of PyTorch
without CUDA cannot differentiate a tensor whose device is ``cuda``
(autograd asks CUDA's device guard for a stream and the engine asks for
the accelerator; neither exists there), and the dry run and the tests
run on such a build.  Under a count a wrapper takes its card path for a
``meta`` tensor (``kernels/_build.py on_card``), and a ``meta`` tensor
reaching a wrapper outside a count raises.  Data-dependent ops
(``.item()``, ``nonzero``) raise on ``meta`` tensors: a count never skips
one.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import _build
from ..obs import trace as obs
from .analysis import CollectiveStats

#: ops that launch nothing: allocations, metadata, aliases not marked as
#: views in their schema
_NO_LAUNCH = frozenset({
    "_unsafe_view", "_reshape_alias", "empty", "empty_like",
    "empty_strided", "empty_permuted", "new_empty", "new_empty_strided",
    "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
    "lift_fresh", "detach_", "record_stream", "_local_scalar_dense",
})
#: matrix products: FLOPs 2·M·N·K (what ``torch.utils.flop_counter``
#: counts)
_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm",
                       "convolution", "convolution_backward"})
#: data movement: no FLOPs
_MOVES = frozenset({
    "copy_", "_to_copy", "clone", "cat", "stack", "index", "index_select",
    "gather", "embedding", "_unsafe_index", "index_put", "index_put_",
    "_index_put_impl_", "index_copy", "index_copy_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "masked_scatter", "masked_scatter_",
    "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "fill", "fill_", "zero_", "zeros", "ones", "full",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "scalar_tensor", "arange", "repeat", "constant_pad_nd",
    "flip", "roll", "embedding_dense_backward", "_copy_from",
    "_copy_from_and_resize", "contiguous", "tril_indices", "triu_indices",
    "one_hot",
})
#: gathers: twice their result (a window read, its result written)
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "_unsafe_index"})
#: in-place writes into part of a buffer: twice the part written; the
#: argument that holds it
_PART_WRITES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                "index_copy": 3, "index_copy_": 3, "scatter": 3,
                "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
                "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
                "index_add_": 3, "masked_scatter": 2, "masked_scatter_": 2,
                "slice_scatter": 1, "select_scatter": 1,
                "diagonal_scatter": 1, "as_strided_scatter": 1}
#: ops that write their first argument without reading it
_WRITE_ONLY = frozenset({"fill_", "zero_"})

TOP = "(top)"
BACKWARD = ".backward"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> List[torch.Tensor]:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _product_flops(name: str, args, out) -> float:
    if name in ("mm", "_int_mm"):
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "convolution":
        w = args[1]
        y = out if isinstance(out, torch.Tensor) else out[0]
        per = w.numel() // w.shape[0]          # C_in/groups x the kernel
        if args[6]:                            # transposed: per input
            return 2.0 * args[0].numel() * per
        return 2.0 * y.numel() * per
    # convolution_backward: the input's and the weight's gradients, each
    # as many products as the forward
    w = args[2]
    per = w.numel() // w.shape[0]
    y = args[0]                                # grad_output
    mask = args[-1]
    return 2.0 * y.numel() * per * (int(mask[0]) + int(mask[1]))


def launches(func) -> bool:
    """Whether ATen op ``func`` launches a kernel (views, aliases,
    allocations and metadata ops do not)."""
    return func.namespace == "aten" and not func.is_view and \
        func.overloadpacket.__name__ not in _NO_LAUNCH


def op_work(func, args, kwargs, out):
    """(name, FLOPs, bytes) of one ATen op that :func:`launches`."""
    name = func.overloadpacket.__name__
    if isinstance(out, torch.Tensor):
        outs = [out]
    else:
        outs = _tensors(out) if isinstance(out, (list, tuple)) else []
    ins = _tensors(args) + _tensors(kwargs.values())
    if name in _PRODUCTS:
        flops = _product_flops(name, args, out)
    elif name in _MOVES:
        flops = 0.0
    else:
        flops = float(sum(t.numel() for t in outs))
    if name in _GATHERS:
        nbytes = 2 * sum(_nbytes(t) for t in outs)
    elif name in _PART_WRITES:
        i = _PART_WRITES[name]
        part = args[i] if len(args) > i else None
        if isinstance(part, torch.Tensor):
            written = _nbytes(part)
        else:                                   # a scalar: index's size
            idx = args[2] if len(args) > 2 and isinstance(
                args[2], torch.Tensor) else args[0]
            written = idx.numel() * args[0].element_size()
        nbytes = 2 * written
    elif name == "copy_":
        nbytes = _nbytes(args[0]) + _nbytes(args[1])
    elif name in _WRITE_ONLY:
        nbytes = _nbytes(args[0])
    else:
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    return name, flops, float(nbytes)


@dataclasses.dataclass
class Totals:
    """What a counted program does on one device.  The reference's
    fields (``flops``, ``bytes``, ``collective_bytes`` and
    ``collective_counts`` per op, ``cross_pod_bytes``), and:
    ``launches`` per op (ATen op or kernel name); ``by_op`` and
    ``by_scope`` {"flops", "bytes", "launches"} per op and per scope;
    ``kernels``: launches per hand-written kernel; ``routes``: launches
    per "<kernel>:<route>" of the kernels that have routes;
    ``collectives``: the layout counter's
    :class:`~repro_torch.roofline.analysis.CollectiveStats` (operand,
    wire and inter-node bytes: the counterpart of the reference's
    ``analysis.parse_collectives``)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    cross_pod_bytes: float = 0.0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    by_scope: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    routes: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: Optional[CollectiveStats] = None

    @property
    def total_launches(self) -> int:
        return sum(self.launches.values())

    def flops_of(self, names) -> float:
        """FLOPs of the ops named (e.g. :data:`PRODUCT_OPS`)."""
        return sum(v["flops"] for k, v in self.by_op.items() if k in names)

    def kernel_launches(self) -> Dict[str, int]:
        """The hand-written kernels' launches as ``kernels/_build.py``'s
        ``LAUNCH_COUNTS`` keeps them: per kernel and per
        "<kernel>:<route>"."""
        return {**self.kernels, **self.routes}


#: the product ops
PRODUCT_OPS = _PRODUCTS


class _Count:
    """The running count: per op and per scope rows of [flops, bytes,
    launches], the stack of open spans, and the scope at each change of
    it by autograd's sequence number then (``seqs``, ``names``)."""

    def __init__(self):
        self.by_op: Dict[str, List[float]] = {}
        self.by_scope: Dict[str, List[float]] = {}
        self.kernels: Dict[str, int] = {}
        self.routes: Dict[str, int] = {}
        self.stack: List[str] = []
        self.seqs: List[int] = []
        self.names: List[str] = []
        self.mark()

    def mark(self) -> None:
        """The stack changed: autograd nodes made from now on belong to
        its innermost span."""
        self.seqs.append(torch._C._autograd._get_sequence_nr())
        self.names.append(self.stack[-1] if self.stack else TOP)

    def where(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:               # the backward of that node
            i = bisect.bisect_right(self.seqs, node._sequence_nr()) - 1
            return self.names[max(i, 0)] + BACKWARD
        return self.stack[-1] if self.stack else TOP

    def record(self, name: str, flops: float, nbytes: float,
               launches: int = 1) -> None:
        for table, key in ((self.by_op, name), (self.by_scope,
                                                self.where())):
            row = table.get(key)
            if row is None:
                table[key] = [flops, nbytes, launches]
            else:
                row[0] += flops
                row[1] += nbytes
                row[2] += launches

    def totals(self) -> Totals:
        t = Totals(kernels=dict(self.kernels), routes=dict(self.routes))
        for name, (f, b, n) in self.by_op.items():
            t.flops += f
            t.bytes += b
            t.launches[name] = int(n)
            t.by_op[name] = dict(flops=f, bytes=b, launches=int(n))
        t.by_scope = {k: dict(flops=f, bytes=b, launches=int(n))
                      for k, (f, b, n) in self.by_scope.items()}
        return t


_ACTIVE: Optional[_Count] = None
_COMPOSITE: Dict[Any, bool] = {}


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel."""
    hit = _COMPOSITE.get(func)
    if hit is None:
        hit = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        _COMPOSITE[func] = hit
    return hit


def _key(x):
    """A hashable stand-in for an op's argument: a tensor by its shape,
    strides and dtype (all a ``meta`` op's result depends on)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return x


def _like(spec):
    if spec is None:
        return None
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _spec(t):
    return (t.shape, t.stride(), t.dtype) if isinstance(
        t, torch.Tensor) else None


class _OpCounter(TorchDispatchMode):
    """Counts each op.  The results and the work of ops that make new
    tensors are remembered by their arguments' shapes, so that the layers
    and the microbatches a program repeats skip the ``meta`` kernels
    (many are Python) and only allocate their results."""

    #: op → (decomposes, makes new tensors, launches): what its schema
    #: says, the same for every count
    _kind: Dict[Any, Any] = {}

    def __init__(self, count: _Count):
        super().__init__()
        self.count = count
        #: (op, arguments' key) → (results' shapes, strides and dtypes,
        #: whether a tuple, the op's work)
        self._results: Dict[Any, Any] = {}

    @classmethod
    def kind(cls, func):
        k = cls._kind.get(func)
        if k is None:
            aten = func.namespace == "aten"
            schema = func._schema
            fresh = aten and not schema.is_mutable and not func.is_view \
                and all(r.alias_info is None for r in schema.returns)
            k = cls._kind[func] = (aten and _composite(func),
                                   fresh and launches(func), launches(func))
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite, fresh, counted = self.kind(func)
        if composite:
            # an op that the dispatcher would break up (matmul, reshape,
            # square ...): count its constituents, as the card runs them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if not counted:
            return func(*args, **kwargs)
        if fresh:
            try:
                key = (func, _key(args), _key(kwargs))
                hit = self._results.get(key)
            except TypeError:                # an unhashable argument
                key = hit = None
            if hit is not None:
                spec, many, work = hit
                self.count.record(*work)
                return tuple(_like(s) for s in spec) if many else \
                    _like(spec)
            out = func(*args, **kwargs)
            work = op_work(func, args, kwargs, out)
            self.count.record(*work)
            if key is not None:
                many = not isinstance(out, torch.Tensor)
                outs = out if many else (out,)
                if all(o is None or (isinstance(o, torch.Tensor)
                                     and o.is_meta) for o in outs):
                    self._results[key] = (
                        tuple(_spec(o) for o in outs) if many
                        else _spec(out), many, work)
            return out
        out = func(*args, **kwargs)
        self.count.record(*op_work(func, args, kwargs, out))
        return out


def _running() -> _Count:
    if _ACTIVE is None:
        raise RuntimeError("no count is running (roofline/op_cost.py "
                           "analyze_program)")
    return _ACTIVE


def record_kernel(name: str, flops: float, nbytes: float, *,
                  route: Optional[str] = None, launches: int = 1,
                  call: bool = True) -> None:
    """A hand-written kernel's launch, from its wrapper's launch site.
    ``call=False``: a further kernel of the same wrapper call, which
    ``kernels/_build.py``'s ``LAUNCH_COUNTS`` does not count apart (nor
    does :attr:`Totals.kernels`)."""
    count = _running()
    count.record(name, float(flops), float(nbytes), launches)
    if not call:
        return
    count.kernels[name] = count.kernels.get(name, 0) + launches
    if route is not None:
        key = f"{name}:{route}"
        count.routes[key] = count.routes.get(key, 0) + launches


def record_collective(op: str, operand_bytes: int, result_bytes: int
                      ) -> None:
    """A collective of a recording layout: one launch moving its operand
    and its result."""
    _running().record(op, 0.0, float(operand_bytes + result_bytes))


class _Span:
    """A span of :class:`_ScopeTracer`: it opens a scope of the count."""
    __slots__ = ("name", "count")
    dur_s = None

    def __init__(self, name: str, count: _Count):
        self.name, self.count = name, count

    def __enter__(self):
        self.count.stack.append(self.name)
        self.count.mark()
        return self

    def __exit__(self, *exc):
        self.count.stack.pop()
        self.count.mark()

    def set_attr(self, key: str, value: Any) -> None:
        return None


class _ScopeTracer(obs.Tracer):
    """The global tracer during a count: its spans are the count's
    scopes; it records nothing of its own."""

    def __init__(self, count: _Count):
        super().__init__(enabled=True)
        self._count = count

    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(name, self._count)

    def count(self, name: str, n=1, **attrs: Any) -> None:
        return None


def analyze_program(fn: Callable, *args, layout=None, **kwargs) -> Totals:
    """Run ``fn(*args, **kwargs)`` once on ``meta`` tensors and count it.
    ``layout``: the recording layout (``launch/mesh.py
    make_recording_layout``) whose collectives the program makes; its
    counter is reset first and read after.  Nothing is built, launched
    or allocated.  While it runs, the global ``obs`` tracer is one whose
    spans are the count's scopes (an enabled tracer records nothing of
    the count), and ``kernels/_build.py``'s ``recorder`` records the
    wrappers' launches."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("analyze_program: a count is already running")
    if layout is not None:
        if not getattr(layout, "recording", False):
            raise ValueError("analyze_program: the layout must be a "
                             "recording one (launch/mesh.py "
                             "make_recording_layout)")
        layout.stats.reset()
    count = _Count()
    _ACTIVE = count
    tracer = obs.get_tracer()
    obs.set_tracer(_ScopeTracer(count))
    _build.recorder = record_kernel
    try:
        with _OpCounter(count):
            fn(*args, **kwargs)
    finally:
        _ACTIVE = None
        _build.recorder = None
        obs.set_tracer(tracer)
    totals = count.totals()
    if layout is not None:
        stats = layout.stats.stats()
        totals.collectives = stats
        totals.collective_bytes = {k: float(v) for k, v in
                                   stats.operand_bytes.items()}
        totals.collective_counts = {k: float(v) for k, v in
                                    stats.counts.items()}
        totals.cross_pod_bytes = float(stats.cross_pod_bytes)
    return totals
