"""Monotonicity certification for layer tails (abstract interpretation).

Threshold conversion (paper §4.1.3, Eq. 3) is only *exact* when the
elementwise layer tail is monotone over the SIRA-proven input range.  The
paper's workloads satisfy that trivially (ReLU tails), but the repo's
``TAIL_ELEMENTWISE`` set admits Silu / Gelu / hard-swish, which dip around
a stationary point — converting such a tail blindly miscompiles.

This module certifies, per channel, whether a tail is monotone (and in
which direction) *before* any thresholds are extracted:

1. **Transfer composition** — every op carries a monotonicity transfer
   function registered via ``register_op(..., monotone=fn)``.  Each
   transfer maps a per-channel input interval to an output interval plus a
   direction factor in {-1, 0, +1} (NaN = unknown); factors compose by
   sign multiplication, so a negative ``Mul`` flips the chain's direction
   and a saturated ``Clip`` collapses it to constant.  Ops with a known
   stationary point (Silu, Gelu, hard-swish, Abs) certify whenever the
   incoming interval lies entirely on one side of it.
2. **On-grid finite differences** — when transfer composition cannot
   decide (range straddles a stationary point), the *quantized* tail
   output is evaluated over the full proven integer grid.  A real-valued
   dip smaller than one quantization step still yields a monotone
   staircase, which is all Eq. 3 needs.

The resulting :class:`MonotoneCertificate` gates the extraction strategy
in ``core.thresholds`` (bisection vs direction-aware enumeration) and, for
uncertifiable tails, carries a machine-readable reason code that the
dataflow DSE uses to price the elementwise meta-kernel instead.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, Optional

import numpy as np

from .graph import Graph, Node
from .intervals import ScaledIntRange
from .ops import MONOTONE_REGISTRY, register_op

if TYPE_CHECKING:  # circular at runtime: thresholds imports this module
    from .thresholds import LayerTail

__all__ = [
    "MonotoneStep", "MonotoneCertificate", "certify_tail",
    "compose_direction", "MONOTONE_REGISTRY",
]


@dataclasses.dataclass(frozen=True)
class MonotoneStep:
    """One op's effect on a per-channel interval: output bounds plus a
    direction factor per channel (-1 reverses, 0 collapses to constant,
    +1 preserves, NaN = unknown)."""
    lo: np.ndarray
    hi: np.ndarray
    factor: np.ndarray


@dataclasses.dataclass(frozen=True)
class MonotoneCertificate:
    """Per-channel monotonicity verdict for one layer tail.

    status:
      * ``"monotone"``      — every channel monotone, uniform direction
      * ``"representable"`` — every channel monotone, mixed directions
        (still exactly convertible with per-channel signed out_scale)
      * ``"uncertified"``   — some channel could not be certified;
        ``reason`` carries a machine-readable code
    method: ``"transfer"`` (composition alone), ``"grid"`` (finite
    differences of the quantized output decided >=1 channel), ``""`` when
    uncertified.
    direction: (C,) ints in {-1, 0, +1}; zeros when uncertified.
    """
    status: str
    method: str
    direction: np.ndarray
    reason: str = ""
    detail: str = ""

    @property
    def certified(self) -> bool:
        return self.status != "uncertified"

    @property
    def summary(self) -> str:
        """Compact string form stored on converted MultiThreshold nodes."""
        return f"{self.status}:{self.method}" if self.certified \
            else f"uncertified:{self.reason}"


def compose_direction(direction: np.ndarray,
                      factor: np.ndarray) -> np.ndarray:
    """Compose per-channel direction with an op's factor.  A zero factor
    makes the output constant regardless of what came before (including
    unknown), hence the explicit branch instead of plain NaN-propagating
    multiplication."""
    return np.where(factor == 0.0, 0.0, direction * factor)


# --------------------------------------------------------------------------
# per-op transfer functions
# --------------------------------------------------------------------------

TransferFn = Callable[[Node, Graph, np.ndarray, np.ndarray],
                      Optional[MonotoneStep]]


def _const_operand(g: Graph, node: Node, C: int) -> Optional[np.ndarray]:
    """Second operand as a (C,) array, or None when dynamic / mismatched."""
    if len(node.inputs) < 2 or not g.is_constant(node.inputs[1]):
        return None
    v = np.asarray(g.initializers[node.inputs[1]], np.float64).reshape(-1)
    if v.size == 1:
        return np.full(C, v[0])
    if v.size == C:
        return v.copy()
    return None


def _mono_add(node: Node, g: Graph, lo: np.ndarray,
              hi: np.ndarray) -> Optional[MonotoneStep]:
    c = _const_operand(g, node, lo.size)
    if c is None:
        return None
    sign = -1.0 if node.op_type == "Sub" else 1.0
    return MonotoneStep(lo + sign * c, hi + sign * c, np.ones_like(lo))


def _mono_mul(node: Node, g: Graph, lo: np.ndarray,
              hi: np.ndarray) -> Optional[MonotoneStep]:
    c = _const_operand(g, node, lo.size)
    if c is None:
        return None
    if node.op_type == "Div":
        if np.any(c == 0.0):
            return None
        c = 1.0 / c
    a, b = lo * c, hi * c
    return MonotoneStep(np.minimum(a, b), np.maximum(a, b), np.sign(c))


def _mono_increasing(fn: Callable[[np.ndarray], np.ndarray]) -> TransferFn:
    """Elementwise nondecreasing function: direction is preserved."""
    def step(node: Node, g: Graph, lo: np.ndarray,
             hi: np.ndarray) -> Optional[MonotoneStep]:
        return MonotoneStep(fn(lo), fn(hi), np.ones_like(lo))
    return step


def _mono_softcap(node: Node, g: Graph, lo: np.ndarray,
                  hi: np.ndarray) -> Optional[MonotoneStep]:
    cap = float(node.attrs.get("cap", 0.0))
    if cap <= 0.0:
        return None
    fn = lambda x: cap * np.tanh(x / cap)
    return MonotoneStep(fn(lo), fn(hi), np.ones_like(lo))


def _mono_clip(node: Node, g: Graph, lo: np.ndarray,
               hi: np.ndarray) -> Optional[MonotoneStep]:
    def bound(idx: int, default: float) -> Optional[np.ndarray]:
        if len(node.inputs) <= idx:
            return np.full(lo.size, default)
        if not g.is_constant(node.inputs[idx]):
            return None
        v = np.asarray(g.initializers[node.inputs[idx]],
                       np.float64).reshape(-1)
        if v.size == 1:
            return np.full(lo.size, v[0])
        return v.copy() if v.size == lo.size else None

    clip_lo = bound(1, -np.inf)
    clip_hi = bound(2, np.inf)
    if clip_lo is None or clip_hi is None:
        return None
    out_lo = np.clip(lo, clip_lo, clip_hi)
    out_hi = np.clip(hi, clip_lo, clip_hi)
    # interval entirely inside a saturation plateau → constant output
    flat = (hi <= clip_lo) | (lo >= clip_hi)
    return MonotoneStep(out_lo, out_hi, np.where(flat, 0.0, 1.0))


def _mono_stationary(fn: Callable[[np.ndarray], np.ndarray],
                     x_star: float) -> TransferFn:
    """Unimodal function with a single interior minimum at ``x_star``:
    decreasing before it, nondecreasing after.  An interval entirely on
    one side certifies; a straddling interval stays unknown (NaN) and
    falls through to the on-grid check."""
    def step(node: Node, g: Graph, lo: np.ndarray,
             hi: np.ndarray) -> Optional[MonotoneStep]:
        f_lo, f_hi = fn(lo), fn(hi)
        out_lo = np.minimum(f_lo, f_hi)
        out_hi = np.maximum(f_lo, f_hi)
        inside = (lo < x_star) & (x_star < hi)
        out_lo = np.where(inside, fn(np.asarray(x_star)), out_lo)
        factor = np.where(hi <= x_star, -1.0,
                          np.where(lo >= x_star, 1.0, np.nan))
        return MonotoneStep(out_lo, out_hi, factor)
    return step


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def _gelu(x: np.ndarray) -> np.ndarray:
    from scipy.special import erf
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def _hardswish(x: np.ndarray) -> np.ndarray:
    return x * np.clip(x + 3.0, 0.0, 6.0) / 6.0


register_op("Add", monotone=_mono_add)
register_op("Sub", monotone=_mono_add)
register_op("Mul", monotone=_mono_mul)
register_op("Div", monotone=_mono_mul)
register_op("Identity", monotone=_mono_increasing(lambda x: x))
register_op("Relu", monotone=_mono_increasing(
    lambda x: np.maximum(x, 0.0)))
register_op("Sigmoid", monotone=_mono_increasing(
    lambda x: 1.0 / (1.0 + np.exp(-x))))
register_op("Tanh", monotone=_mono_increasing(np.tanh))
register_op("Softcap", monotone=_mono_softcap)
register_op("Clip", monotone=_mono_clip)
# stationary points match the unimodal range handlers in core.propagate
register_op("Silu", monotone=_mono_stationary(_silu, -1.2784645))
register_op("Gelu", monotone=_mono_stationary(_gelu, -0.75179))
register_op("HardSwish", monotone=_mono_stationary(_hardswish, -1.5))
register_op("Abs", monotone=_mono_stationary(np.abs, 0.0))


# --------------------------------------------------------------------------
# certification
# --------------------------------------------------------------------------

def _per_channel_bounds(r: ScaledIntRange,
                        C: int) -> "tuple[np.ndarray, np.ndarray]":
    """Per-channel value bounds of the tail input; falls back to the
    channel hull when the range granularity does not match (sound: a
    wider interval can only *fail* to certify, never lie)."""
    lo = np.asarray(r.lo, np.float64).reshape(-1)
    hi = np.asarray(r.hi, np.float64).reshape(-1)
    if lo.size == C and hi.size == C:
        return lo.copy(), hi.copy()
    return (np.full(C, float(np.min(lo))), np.full(C, float(np.max(hi))))


def _verdict(direction: np.ndarray, method: str,
             detail: str) -> MonotoneCertificate:
    d = np.sign(direction).astype(np.int64)
    uniform = bool(np.all(d >= 0) or np.all(d <= 0))
    status = "monotone" if uniform else "representable"
    return MonotoneCertificate(status=status, method=method, direction=d,
                               detail=detail)


def certify_tail(g: Graph, tail: "LayerTail",
                 ranges: Dict[str, ScaledIntRange],
                 max_grid: Optional[int] = None) -> MonotoneCertificate:
    """Certify per-channel monotonicity of ``tail`` over its proven range.

    Runs transfer composition first; channels it cannot decide fall back
    to finite differences of the quantized output over the full integer
    grid (bounded by ``max_grid``, default ``EDGE_DETECT_MAX_RANGE``)."""
    from .thresholds import (EDGE_DETECT_MAX_RANGE, ThresholdConversionError,
                             _entry_int_bounds, _tail_params_channels,
                             tail_evaluator)
    if max_grid is None:
        max_grid = EDGE_DETECT_MAX_RANGE
    r_in = ranges[tail.input_tensor]
    C = _tail_params_channels(g, tail)
    int_lo, int_hi = _entry_int_bounds(r_in, C)
    lo0, hi0 = int(int_lo.min()), int(int_hi.max())
    lo, hi = _per_channel_bounds(r_in, C)

    direction = np.ones(C, np.float64)
    detail = ""
    for node in tail.nodes[:-1]:  # the final node is the quantizer
        fn = MONOTONE_REGISTRY.get(node.op_type)
        step = fn(node, g, lo, hi) if fn is not None else None
        if step is None:
            direction[:] = np.nan
            detail = (f"no-monotone-rule:{node.op_type}" if fn is None
                      else f"monotone-rule-failed:{node.op_type}")
            break
        direction = compose_direction(direction, step.factor)
        lo, hi = step.lo, step.hi
    # the terminating quantizer (scale > 0, round, saturate) is
    # nondecreasing — it never changes the direction

    unknown = np.isnan(direction)
    if not unknown.any():
        return _verdict(direction, "transfer", detail)

    # on-grid fallback: finite differences of the *quantized* output over
    # the full proven integer grid; certifies even when the real-valued
    # tail dips within one quantization step
    R = hi0 - lo0 + 1
    if R > max_grid:
        return MonotoneCertificate(
            status="uncertified", method="", direction=np.zeros(C, np.int64),
            reason=f"grid-too-large:{R}", detail=detail)
    try:
        ev = tail_evaluator(g, tail, ranges)
    except ThresholdConversionError as e:
        return MonotoneCertificate(
            status="uncertified", method="", direction=np.zeros(C, np.int64),
            reason=e.reason, detail=str(e))
    xs = np.arange(lo0, hi0 + 1, dtype=np.int64)
    try:
        levels = ev.f_int(xs)                  # (R, C)
    except NotImplementedError:
        # an op the transfer layer rejected may be unexecutable too
        return MonotoneCertificate(
            status="uncertified", method="", direction=np.zeros(C, np.int64),
            reason=detail or "evaluation-failed", detail=detail)
    # restrict each channel's finite differences to its *own* proven
    # integer range — outside it the certificate makes no claim, and the
    # extractors never place thresholds there either
    up = np.empty(C, bool)
    down = np.empty(C, bool)
    for c in range(C):
        i0, i1 = int(int_lo[c] - lo0), int(int_hi[c] - lo0)
        dseg = np.diff(levels[i0:i1 + 1, c])
        up[c] = bool(np.all(dseg >= 0))
        down[c] = bool(np.all(dseg <= 0))
    grid_dir = np.where(up & down, 0.0,
                        np.where(up, 1.0, np.where(down, -1.0, np.nan)))
    direction = np.where(unknown, grid_dir, direction)
    if np.isnan(direction).any():
        return MonotoneCertificate(
            status="uncertified", method="", direction=np.zeros(C, np.int64),
            reason="nonmonotone-on-grid", detail=detail)
    return _verdict(direction, "grid", detail)
