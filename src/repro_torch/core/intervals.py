"""Scaled-integer ranges and interval arithmetic primitives (paper §2.4, §3).

A ``ScaledIntRange`` tracks, for one tensor ``v``:

  * the full-precision value interval  ``[lo, hi]``  (elementwise arrays),
  * optionally an underlying integer interval ``[int_lo, int_hi]`` together
    with constant ``scale`` and ``bias`` arrays such that

        [lo, hi] = scale * [int_lo, int_hi] + bias        (scale > 0)

  * the set of graph tensors that *contributed* to scale/bias (used by the
    streamlining transform to erase the originals, paper §4.1.2 step 4).

All members are kept as numpy arrays broadcastable to the tensor shape.
Scale and bias must be constants (paper §3: allowing interval-valued scales
explodes the analysis).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Optional, Tuple

import numpy as np

Array = np.ndarray


class InvalidRangeError(ValueError):
    """A range violates a soundness invariant (inverted interval, NaN
    bound, non-positive scale, missing integer component).

    Raised instead of a bare ``assert`` so the checks survive
    ``python -O``; the graph linter (:mod:`repro_torch.core.lint`) reuses it via
    :meth:`ScaledIntRange.validate`.
    """


def _as_arr(x) -> Array:
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ScaledIntRange:
    lo: Array
    hi: Array
    int_lo: Optional[Array] = None
    int_hi: Optional[Array] = None
    scale: Optional[Array] = None
    bias: Optional[Array] = None
    # names of graph initializers contributing to scale / bias
    scale_src: FrozenSet[str] = frozenset()
    bias_src: FrozenSet[str] = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "lo", _as_arr(self.lo))
        object.__setattr__(self, "hi", _as_arr(self.hi))
        if self.int_lo is not None:
            object.__setattr__(self, "int_lo", _as_arr(self.int_lo))
            object.__setattr__(self, "int_hi", _as_arr(self.int_hi))
        if self.scale is not None:
            object.__setattr__(self, "scale", _as_arr(self.scale))
        if self.bias is not None:
            object.__setattr__(self, "bias", _as_arr(self.bias))
        self.validate()

    def validate(self) -> None:
        """Re-check the soundness invariants, raising
        :class:`InvalidRangeError` on violation.  Runs at construction;
        the graph linter calls it again on declared ranges (which may
        have been mutated or built by bypassing ``__init__``)."""
        if np.any(np.isnan(self.lo)) or np.any(np.isnan(self.hi)):
            raise InvalidRangeError("NaN range bound")
        if not np.all(self.lo <= self.hi + 1e-12):
            raise InvalidRangeError("inverted interval: lo > hi")
        if self.int_lo is not None:
            if self.int_hi is None or self.scale is None:
                raise InvalidRangeError(
                    "integer interval requires int_lo, int_hi and scale")
            if not np.all(self.int_lo <= self.int_hi + 1e-12):
                raise InvalidRangeError("inverted integer interval")
        if self.scale is not None and not np.all(self.scale > 0):
            raise InvalidRangeError("scales must be positive")

    # ------------------------------------------------------------------ api
    @property
    def is_scaled_int(self) -> bool:
        return self.int_lo is not None

    @property
    def is_point(self) -> bool:
        """Constant (point) interval — e.g. weights."""
        return bool(np.all(self.lo == self.hi))

    def width(self) -> Array:
        return self.hi - self.lo

    @staticmethod
    def point(value) -> "ScaledIntRange":
        v = _as_arr(value)
        r = ScaledIntRange(lo=v, hi=v)
        # A constant integer tensor is trivially scaled-integer (s=1, b=0).
        if np.all(np.floor(v) == v):
            r = ScaledIntRange(lo=v, hi=v, int_lo=v, int_hi=v,
                               scale=np.ones(()), bias=np.zeros(()))
        return r

    @staticmethod
    def from_scaled_int(int_lo, int_hi, scale, bias=0.0,
                        scale_src=frozenset(), bias_src=frozenset()
                        ) -> "ScaledIntRange":
        int_lo, int_hi = _as_arr(int_lo), _as_arr(int_hi)
        scale, bias = _as_arr(scale), _as_arr(bias)
        if not np.all(scale > 0):
            raise InvalidRangeError("scales must be positive")
        lo = scale * int_lo + bias
        hi = scale * int_hi + bias
        return ScaledIntRange(lo=lo, hi=hi, int_lo=int_lo, int_hi=int_hi,
                              scale=scale, bias=bias,
                              scale_src=frozenset(scale_src),
                              bias_src=frozenset(bias_src))

    def drop_scaled_int(self) -> "ScaledIntRange":
        return ScaledIntRange(lo=self.lo, hi=self.hi)

    def contains(self, x, atol: float = 1e-6) -> bool:
        x = _as_arr(x)
        return bool(np.all(x >= self.lo - atol) and np.all(x <= self.hi + atol))

    def required_signed_bits(self) -> int:
        """Two's-complement bits for the *integer* interval (paper §4.2):

            P = ceil(log2(max(|z_lo|, |z_hi| + 1))) + 1
        """
        if not self.is_scaled_int:
            raise InvalidRangeError("no integer component")
        zmin = float(np.min(self.int_lo))
        zmax = float(np.max(self.int_hi))
        m = max(abs(zmin), abs(zmax) + 1.0)
        if m <= 1.0:
            return 1
        return int(np.ceil(np.log2(m))) + 1

    def required_unsigned_bits(self) -> int:
        if not self.is_scaled_int or np.min(self.int_lo) < 0:
            raise InvalidRangeError(
                "no unsigned integer component (missing or negative)")
        zmax = float(np.max(self.int_hi))
        if zmax <= 0:
            return 1
        return max(1, int(np.ceil(np.log2(zmax + 1.0))))


# --------------------------------------------------------------------------
# plain interval arithmetic (used when scaled-int structure is lost)
# --------------------------------------------------------------------------

def add_intervals(a_lo, a_hi, b_lo, b_hi) -> Tuple[Array, Array]:
    return a_lo + b_lo, a_hi + b_hi


def mul_intervals(a_lo, a_hi, b_lo, b_hi) -> Tuple[Array, Array]:
    cands = np.stack(np.broadcast_arrays(
        a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi))
    return cands.min(axis=0), cands.max(axis=0)


def monotonic_fn_interval(fn, lo, hi) -> Tuple[Array, Array]:
    """Elementwise-monotonic function (paper §2.4.1): extrema at corners."""
    a, b = fn(lo), fn(hi)
    return np.minimum(a, b), np.maximum(a, b)


def dot_interval(w: Array, x_lo: Array, x_hi: Array) -> Tuple[Array, Array]:
    """Constant-weighted dot product (paper §2.4.2, Gowal et al. simplified).

    ``w``: (K, M) constant weights; ``x``: (..., K) interval.
    miv/mav construction via the midpoint/radius identity:
        y_c = x_c @ w ;  y_r = x_r @ |w|  →  [y_c - y_r, y_c + y_r]
    which is exactly the min/max over minimizing/maximizing input vectors.
    """
    x_c = (x_hi + x_lo) * 0.5
    x_r = (x_hi - x_lo) * 0.5
    y_c = x_c @ w
    y_r = x_r @ np.abs(w)
    return y_c - y_r, y_c + y_r


def dyn_dot_interval(a_lo, a_hi, b_lo, b_hi, k_axis_a=-1, k_axis_b=-2
                     ) -> Tuple[Array, Array]:
    """Dynamic x dynamic matmul interval (beyond-paper handler, conservative).

    Elementwise product hull summed over the contraction axis. Shapes must be
    plain matmul-compatible: a (..., M, K), b (..., K, N).
    """
    a_lo = np.expand_dims(a_lo, -1)   # (..., M, K, 1)
    a_hi = np.expand_dims(a_hi, -1)
    b_lo = np.expand_dims(b_lo, -3)   # (..., 1, K, N)
    b_hi = np.expand_dims(b_hi, -3)
    p_lo, p_hi = mul_intervals(a_lo, a_hi, b_lo, b_hi)
    return p_lo.sum(axis=-2), p_hi.sum(axis=-2)
