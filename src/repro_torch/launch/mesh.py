"""The layout: how the ranks of a ``torch.distributed`` job are laid out
over the axes ``data``, ``model`` and (optionally) ``pod``.

Counterpart of ``src/repro/launch/mesh.py``, whose production meshes are
TPU-shaped: (16, 16) = 256 chips on ("data", "model") and (2, 16, 16) =
512 chips on ("pod", "data", "model").  Here the production shapes are an
H100 cluster's: the ``model`` axis stays inside one 8-GPU NVLink node, so
(32, 8) for 256 GPUs and (2, 32, 8) for 512 (``pod`` is pure data
parallelism whose gradient all-reduce leaves the node).

A :class:`Layout` holds the axis sizes, this process's rank and, once it
is bound to an initialised process group, one ``torch.distributed``
group per axis.  Its collectives (``all_reduce``, ``all_gather``, ``max``,
and ``reduce_scatter`` as an ``all_reduce`` and a slice: gloo has no
``reduce_scatter`` and no ``all_gather_into_tensor`` for CUDA tensors)
count themselves: op, operand bytes and ring-model wire bytes, the rule
of the reference's ``roofline/analysis.py parse_collectives`` (all-reduce
2(g-1)/g of the operand, all-gather (g-1)/g; the emulated reduce-scatter
moves what its all-reduce moves).  ``all_reduce``, ``copy`` and
``all_gather`` carry gradients as Megatron's conjugate pair does (sum
forward and identity backward; identity forward and sum backward; the
gather's backward takes the rank's slice), and count their backward
collectives like the forward ones; ``max`` carries none.  Those counts fill
:class:`~repro_torch.roofline.analysis.CollectiveStats`, where the
reference parses XLA's HLO, with the operand bytes of collectives whose
group spans more than one 8-GPU node kept apart
(:meth:`Layout.crosses_nodes`): those cross at the inter-node rate.  A
collective over an axis of size 1 moves nothing and counts nothing.

The backend is explicit (:func:`pick_backend`): NCCL when each rank has
a card of its own, gloo when ranks share one card (NCCL refuses two
ranks on one device) or hold CPU tensors.  gloo takes CUDA tensors in
``all_reduce`` and in the list form of ``all_gather`` and stages them
through the host: between two processes on one card that staging is the
transport.

A recording layout (:func:`make_recording_layout`) has a shape of any
size and no process group: its collectives record through the same
counter and return results of the right shape without sending anything,
so that ``roofline/op_cost.py analyze_program`` counts rank 0's program
on ``meta`` tensors (the dry run's cells), collectives included.

Nothing here runs at import: layouts are made by functions, and
``torch.distributed`` is touched only by :func:`init_ranks` and
:func:`bind`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, \
    Union

import torch
import torch.distributed as dist

from ..core.lower import resolve_device
from ..roofline import op_cost
from ..roofline.analysis import GPUS_PER_NODE, CollectiveStats

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
#: what a collective's ``axis`` may be: a layout axis name, or a process
#: group of the caller's own
Axis = Union[str, Any]
#: an axis name or a tuple of them (a collective over each in turn)
Axes = Union[str, Tuple[str, ...]]


@dataclasses.dataclass
class CollectiveCounter:
    """Collectives counted as they run: per op (``all-reduce``,
    ``all-gather``, the names the reference's HLO parser uses), the calls,
    the operand bytes (what this rank hands in) and the ring model's bytes
    on the wire; ``cross_pod_bytes``: operand bytes over the ``pod`` axis;
    ``internode_bytes``: operand bytes of collectives whose group spans
    nodes."""
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    operand_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    wire_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    cross_pod_bytes: int = 0
    internode_bytes: int = 0

    def record(self, op: str, nbytes: int, group_size: int,
               axis: Optional[str] = None, internode: bool = False
               ) -> None:
        g = group_size if group_size > 2 else 2
        twice = op in ("all-reduce", "reduce-scatter")
        wire = int((2 if twice else 1) * (g - 1) / g * nbytes)
        self.counts[op] = self.counts.get(op, 0) + 1
        self.operand_bytes[op] = self.operand_bytes.get(op, 0) + nbytes
        self.wire_bytes[op] = self.wire_bytes.get(op, 0) + wire
        if axis == "pod":
            self.cross_pod_bytes += nbytes
        if internode:
            self.internode_bytes += nbytes

    def reset(self) -> None:
        self.counts.clear()
        self.operand_bytes.clear()
        self.wire_bytes.clear()
        self.cross_pod_bytes = 0
        self.internode_bytes = 0

    def stats(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.counts),
                               operand_bytes=dict(self.operand_bytes),
                               wire_bytes=dict(self.wire_bytes),
                               cross_pod_bytes=self.cross_pod_bytes,
                               internode_bytes=self.internode_bytes)


#: counts of collectives over a caller's own process group while no
#: layout is active
GROUP_STATS = CollectiveCounter()


@dataclasses.dataclass(eq=False)
class Layout:
    """Axis sizes, this process's rank, the backend, and a process group
    per axis of size > 1 once bound.  Ranks are laid out row-major over
    ``axis_names`` (``model`` fastest), as ``jax.make_mesh`` orders
    devices.  An unbound layout (``bound=False``) has shapes only: the
    dry run costs it, and its collectives raise, unless it is a recording
    one (``recording=True``, :func:`make_recording_layout`): its
    collectives take ``meta`` tensors, record and return results of the
    right shape."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int = 0
    backend: Optional[str] = None
    bound: bool = False
    recording: bool = False
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stats: CollectiveCounter = dataclasses.field(
        default_factory=CollectiveCounter)

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")
        if any(n < 1 for n in self.shape):
            raise ValueError(f"layout shape {self.shape}: sizes must be "
                             f">= 1")

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)

    def size(self, axis: Union[str, Sequence[str], None]) -> int:
        """The ranks along ``axis`` (a name or a tuple of names; 1 for an
        axis the layout does not have)."""
        if axis is None:
            return 1
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes.get(a, 1) for a in names)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """``rank``'s (default: this process's) index on every axis."""
        r = self.rank if rank is None else rank
        out: Dict[str, int] = {}
        for name, n in reversed(list(zip(self.axis_names, self.shape))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, axis: str) -> int:
        """This process's index on ``axis`` (0 for an absent axis)."""
        return self.coords().get(axis, 0)

    def crosses_nodes(self, axis: Union[str, Sequence[str]]) -> bool:
        """Whether a group along ``axis`` (a name or a tuple of names)
        spans more than one node of ``GPUS_PER_NODE`` consecutive ranks:
        its collectives then cross at the inter-node rate."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return _spans_nodes(self.shape, self.axis_names,
                            tuple(a for a in names if a in self.axis_names))

    # ------------------------------------------------------ collectives
    def _group(self, axis: str):
        if self.recording:
            return _RECORDING
        if not self.bound:
            raise RuntimeError(
                f"layout {self.name} has shapes only: bind it to a process "
                f"group (make_layout after init_ranks) to communicate")
        return self.groups[axis]

    def all_reduce(self, x: torch.Tensor, axis: Axes = "model"
                   ) -> torch.Tensor:
        """Sum of ``x`` over ``axis`` (a name or a tuple of names), every
        rank the same bits.  Differentiable as Megatron's *reduce from
        the model region*: the backward is the identity, which is right
        where every rank goes on with the sum alike (the residual
        stream after ``wo`` or ``w_down``)."""
        if self.size(axis) > 1 and _differentiable(x):
            return _Reduce.apply(x, self, _names(axis))
        return _over(self, "all-reduce", x, axis)

    def copy(self, x: torch.Tensor, axis: Axes = "model") -> torch.Tensor:
        """Megatron's *copy to the model region*: ``x`` itself, whose
        gradient is summed over ``axis`` in the backward.  It goes where a
        replicated tensor enters work split over the axis (before every
        column-split product): each rank's gradient is then a part of the
        whole one."""
        if self.size(axis) > 1 and _differentiable(x):
            return _Copy.apply(x, self, _names(axis))
        return x

    def max(self, x: torch.Tensor, axis: Axes = "model") -> torch.Tensor:
        """Elementwise max of ``x`` over ``axis``; no gradient (every
        scale is computed from detached values, as in the reference)."""
        return _over(self, "max", x, axis)

    def all_gather(self, x: torch.Tensor, axis: str = "model",
                   dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` along ``axis``, joined on ``dim`` in rank
        order.  Differentiable: the backward takes this rank's slice."""
        if self.size(axis) > 1 and _differentiable(x):
            return _Gather.apply(x, self, axis, dim)
        return _collective("all-gather", x, axis, self, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str = "data",
                       dim: int = 0) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``x`` over
        ``axis`` (ZeRO's gradient reduction).  gloo has no reduce-scatter
        for CUDA tensors: an ``all_reduce`` and a slice, counted as a
        "reduce-scatter" that moves what the all-reduce moved."""
        g = self.size(axis)
        if g == 1:
            return x
        out = _collective("all-reduce", x, axis, self, op_name=(
            "reduce-scatter"))
        step = out.shape[dim] // g           # a copy: the sum is freed
        return out.narrow(dim, self.index(axis) * step, step).clone()


# ------------------------------------------------------------- making

def pick_backend(device: Union[str, torch.device], world_size: int) -> str:
    """NCCL when each of ``world_size`` ranks has a card of its own; gloo
    when they share one card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size > 1:
        return "nccl"
    return "gloo"


def rank_device(device: Union[str, torch.device], rank: int,
                backend: str) -> torch.device:
    """The card a rank computes on: its own (``cuda:<rank>``) under NCCL,
    else ``device``'s (gloo: every rank on the same card, ``cuda:0`` when
    none is named)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank if backend == "nccl"
                            else dev.index or 0)
    return dev


def init_ranks(rank: int, world_size: int, init_method: str,
               device: Union[str, torch.device, None] = None,
               backend: Optional[str] = None,
               timeout_s: float = 60.0) -> str:
    """``torch.distributed.init_process_group`` for this rank on
    ``device`` (``None``: the card, raising without one; ``"cpu"`` for
    the plain versions): the backend :func:`pick_backend` gives unless
    one is named, a ``file://`` or ``tcp://localhost:<port>`` rendezvous,
    and a timeout after which a collective that waits for a lost rank
    raises.  Returns the backend."""
    device = resolve_device(device)
    backend = backend or pick_backend(device, world_size)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_layout(shape: Sequence[int],
                axis_names: Optional[Sequence[str]] = None) -> Layout:
    """A layout of ``shape`` over ``axis_names`` (default ("data",
    "model"), or ("pod", "data", "model") for three sizes).  Bound when
    this process is one of the job's ranks: the process group's world
    equals the layout's size (every rank must then call this, in the same
    order: it creates the axes' groups), or there is no process group and
    the layout has one device.  Otherwise it has shapes only."""
    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names) if axis_names is not None else \
        (AXES if len(shape) == 2 else POD_AXES)
    layout = Layout(axis_names=names, shape=shape)
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() == layout.n_devices:
            bind(layout)
    elif layout.n_devices == 1:
        layout.bound = True
    return layout


def bind(layout: Layout) -> Layout:
    """Attach ``layout`` to the initialised process group: this process's
    rank, the backend, and one group per axis of size > 1 (every rank
    creates every group, in the same order, as ``new_group`` requires)."""
    world = dist.get_world_size()
    if world != layout.n_devices:
        raise ValueError(f"layout {layout.name} needs {layout.n_devices} "
                         f"ranks; the process group has {world}")
    layout.rank = dist.get_rank()
    layout.backend = dist.get_backend()
    for axis in layout.axis_names:
        if layout.size(axis) == 1:
            continue
        for members in _axis_groups(layout, axis):
            group = dist.new_group(ranks=members)
            if layout.rank in members:
                layout.groups[axis] = group
    layout.bound = True
    return layout


def _axis_groups(layout: Layout, axis: Union[str, Tuple[str, ...]]
                 ) -> List[List[int]]:
    """The rank lists along ``axis`` (a name or a tuple of names): ranks
    that agree on every other axis, in rank order."""
    names = (axis,) if isinstance(axis, str) else axis
    by_rest: Dict[Tuple, List[int]] = {}
    for r in range(layout.n_devices):
        c = layout.coords(r)
        rest = tuple(v for a, v in c.items() if a not in names)
        by_rest.setdefault(rest, []).append(r)
    return [by_rest[k] for k in sorted(by_rest)]


@functools.lru_cache(maxsize=None)
def _spans_nodes(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 axes: Tuple[str, ...]) -> bool:
    layout = Layout(axis_names=axis_names, shape=shape)
    if not axes or layout.size(axes) == 1:
        return False
    return any(len({r // GPUS_PER_NODE for r in members}) > 1
               for members in _axis_groups(layout, axes))


def make_recording_layout(shape: Sequence[int],
                          axis_names: Optional[Sequence[str]] = None,
                          rank: int = 0) -> Layout:
    """A layout of ``shape`` (axes as :func:`make_layout` names them) for
    rank ``rank``'s program traced on ``meta`` tensors: no process group;
    each collective records through :attr:`Layout.stats`, as a real run
    does, and returns a result of the right shape."""
    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names) if axis_names is not None else \
        (AXES if len(shape) == 2 else POD_AXES)
    return Layout(axis_names=names, shape=shape, rank=rank, recording=True)


def make_debug_layout(n_devices: int = 1) -> Layout:
    """A small layout over the job's ranks (tests, the CPU, one card):
    ``model`` 2 when the count is even, else 1; the rest ``data``.  Every
    rank of the process group takes part (1 without one)."""
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    n = min(n_devices, world)
    if n != world:
        raise ValueError(f"a layout spans every rank of the job: asked for "
                         f"{n_devices} of {world}")
    model = 2 if n % 2 == 0 else 1
    return make_layout((n // model, model))


def make_production_layout(*, multi_pod: bool = False) -> Layout:
    """(32, 8) on ("data", "model"), or (2, 32, 8) on ("pod", "data",
    "model"): the ``model`` axis inside one 8-GPU NVLink node.  Bound when
    the job has 256 (512) ranks, shapes only otherwise (the dry run)."""
    if multi_pod:
        return make_layout((2, 32, 8), POD_AXES)
    return make_layout((32, 8), AXES)


# ------------------------------------------------------- active layout

_ACTIVE: List[Layout] = []


@contextlib.contextmanager
def use_layout(layout: Layout) -> Iterator[Layout]:
    """Make ``layout`` the one collectives named by axis resolve against
    (``jax.set_mesh``'s role)."""
    _ACTIVE.append(layout)
    try:
        yield layout
    finally:
        _ACTIVE.pop()


def current_layout() -> Optional[Layout]:
    return _ACTIVE[-1] if _ACTIVE else None


# --------------------------------------------------------- collectives

#: the "process group" of a recording layout's axes
_RECORDING = object()


def _resolve(axis: Axis, layout: Optional[Layout]):
    """(process group or None when the axis has one rank, its size, the
    counter, the axis name, whether it spans nodes) for an axis name or a
    process group (a caller's own group is taken to stay in its node)."""
    if isinstance(axis, str):
        layout = layout or current_layout()
        if layout is None:
            raise RuntimeError(f"axis {axis!r} names no layout: pass one, "
                               f"or activate one with use_layout")
        g = layout.size(axis)
        return (None if g == 1 else layout._group(axis)), g, \
            layout.stats, axis, layout.crosses_nodes(axis)
    active = layout or current_layout()
    counter = active.stats if active is not None else GROUP_STATS
    g = dist.get_world_size(axis)
    return (None if g == 1 else axis), g, counter, None, False


def _collective(op: str, x: torch.Tensor, axis: Axis,
                layout: Optional[Layout] = None, dim: int = -1,
                op_name: Optional[str] = None) -> torch.Tensor:
    group, g, counter, name, internode = _resolve(axis, layout)
    if group is None:
        return x
    recording = group is _RECORDING
    if recording and not x.is_meta:
        raise RuntimeError("a recording layout's collectives take the meta "
                           "tensors of a counted program "
                           "(roofline/op_cost.py analyze_program)")
    nbytes = x.numel() * x.element_size()
    if op == "all-gather":
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(g)]
        if recording:
            op_cost.record_collective("all-gather", nbytes, g * nbytes)
        else:
            dist.all_gather(parts, x, group=group)
        counter.record("all-gather", nbytes, g, name, internode)
        return torch.cat(parts, dim=dim)
    out = (x.detach() if op == "max" else x).contiguous().clone()
    if recording:
        op_cost.record_collective(op_name or "all-reduce", nbytes, nbytes)
    else:
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    counter.record(op_name or "all-reduce", nbytes, g, name, internode)
    return out


def _names(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _over(layout: Layout, op: str, x: torch.Tensor, axis: Axes
          ) -> torch.Tensor:
    """``op`` ("all-reduce" or "max") over each named axis in turn."""
    for a in _names(axis):
        x = _collective(op, x, a, layout)
    return x


def _differentiable(x) -> bool:
    return isinstance(x, torch.Tensor) and torch.is_grad_enabled() and \
        x.requires_grad


class _Reduce(torch.autograd.Function):
    """Sum over the axes forward, identity backward."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        return _over(layout, "all-reduce", x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    """Identity forward, sum over the axes backward."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        ctx.layout, ctx.axes = layout, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _over(ctx.layout, "all-reduce", g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather on ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, layout, axis, dim):
        ctx.rank, ctx.width = layout.index(axis), x.shape[dim]
        ctx.dim = dim
        return _collective("all-gather", x, axis, layout, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, \
            None, None


def all_reduce(x: torch.Tensor, axis: Axis = "model",
               layout: Optional[Layout] = None) -> torch.Tensor:
    """Sum over ``axis`` (a layout axis name, resolved against ``layout``
    or the active one, or a process group)."""
    return _collective("all-reduce", x, axis, layout)


def all_gather(x: torch.Tensor, axis: Axis = "model",
               layout: Optional[Layout] = None, dim: int = -1
               ) -> torch.Tensor:
    return _collective("all-gather", x, axis, layout, dim=dim)


def max(x: torch.Tensor, axis: Axis = "model",  # noqa: A001
        layout: Optional[Layout] = None) -> torch.Tensor:
    return _collective("max", x, axis, layout)
