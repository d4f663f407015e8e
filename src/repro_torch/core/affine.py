"""Affine-form (zonotope) abstract domain layered on ``ScaledIntRange``.

The plain interval domain in :mod:`repro_torch.core.propagate` forgets every
correlation between tensors: ``x - x`` analyzes to a symmetric interval of
twice the input width, residual adds compound both branch widths, and
per-channel structure is collapsed to a global hull at several handlers.
This module adds a second, still-sound domain where each tensor carries an
**affine form**

    x  =  center  +  sum_s  coeff_s * eps_s,        eps_s in [-1, 1]

with named noise symbols ``s``.  Linear ops combine coefficients symbol by
symbol, so correlated terms *cancel* instead of compounding.

Noise-symbol convention
-----------------------
The analysis is shape-polymorphic (range arrays are broadcastable to the
tensor shape, never the concrete shape itself), so a noise symbol here
names an **elementwise-independent noise array** of its anchor tensor's
shape: two tensors referring to the same symbol see the *same* noise
values elementwise, and coefficient arrays broadcast against each other.
Consequences:

* elementwise linear ops (Add/Sub/Mul-by-const/Div-by-const) are exact;
  ``x - x`` has zero width;
* ops that **mix elements** (MatMul/Conv contractions, pooling, shape
  moves with non-scalar coefficients) cannot keep the symbol: the result
  is re-anchored with a fresh symbol whose per-element radius is the
  exact box hull of the mixed term — sound and elementwise-exact, but the
  cross-element correlation is dropped (the documented degeneration to
  interval precision);
* nonlinear elementwise ops (ReLU, MultiThreshold, Quant, dynamic Mul)
  use a sound linearization: scaled input terms plus a fresh symbol
  covering the linearization error.

Integration: :class:`repro_torch.core.propagate.SIRA` runs this domain as a
*reduced product* with the interval domain (``domain="affine"``) — every
interval handler sees affine-tightened inputs, every output range is
intersected with the affine concretization (:func:`tighten_range`), so
affine results are contained in interval results **by construction**.
Ops without an affine rule in ``AFFINE_REGISTRY`` fall back to a fresh
form over their (tightened) interval output.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, Node
from .intervals import Array, InvalidRangeError, ScaledIntRange
from .ops import AFFINE_REGISTRY, register_op

_sym_counter = itertools.count()


def fresh_symbol(prefix: str = "eps") -> str:
    return f"{prefix}#{next(_sym_counter)}"


class AffineForm:
    """``center + sum_s coeff_s * eps_s`` with numpy-array coefficients."""

    __slots__ = ("center", "terms")

    def __init__(self, center, terms: Optional[Dict[str, Array]] = None):
        self.center: Array = np.asarray(center, dtype=np.float64)
        self.terms: Dict[str, Array] = {}
        for s, c in (terms or {}).items():
            c = np.asarray(c, dtype=np.float64)
            if np.any(c != 0.0):
                self.terms[s] = c

    # -------------------------------------------------------- construction
    @staticmethod
    def point(value) -> "AffineForm":
        return AffineForm(value)

    @staticmethod
    def from_interval(lo, hi, symbol: Optional[str] = None) -> "AffineForm":
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        center = (lo + hi) * 0.5
        rad = (hi - lo) * 0.5
        if np.all(rad == 0.0):
            return AffineForm(center)
        return AffineForm(center, {symbol or fresh_symbol(): rad})

    @staticmethod
    def from_range(r: ScaledIntRange,
                   symbol: Optional[str] = None) -> "AffineForm":
        return AffineForm.from_interval(r.lo, r.hi, symbol)

    # ------------------------------------------------------ concretization
    def radius(self) -> Array:
        rad: Array = np.zeros(())
        for c in self.terms.values():
            rad = rad + np.abs(c)
        return rad

    def concretize(self) -> Tuple[Array, Array]:
        rad = self.radius()
        return self.center - rad, self.center + rad

    @property
    def is_point(self) -> bool:
        return not self.terms

    # ------------------------------------------------------ linear algebra
    def __add__(self, other) -> "AffineForm":
        if not isinstance(other, AffineForm):
            return AffineForm(self.center + np.asarray(other, np.float64),
                              self.terms)
        terms = dict(self.terms)
        for s, c in other.terms.items():
            terms[s] = terms[s] + c if s in terms else c
        return AffineForm(self.center + other.center, terms)

    def __sub__(self, other) -> "AffineForm":
        if not isinstance(other, AffineForm):
            return AffineForm(self.center - np.asarray(other, np.float64),
                              self.terms)
        return self + other.scale_by(-1.0)

    def scale_by(self, c) -> "AffineForm":
        """Multiply by a constant (array) — exact for any sign."""
        c = np.asarray(c, dtype=np.float64)
        return AffineForm(self.center * c,
                          {s: a * c for s, a in self.terms.items()})

    def affine_map(self, scale, offset, err_radius=None,
                   symbol: Optional[str] = None) -> "AffineForm":
        """``scale * self + offset (+- err_radius)`` — the generic sound
        linearization: scaled input terms plus a fresh error symbol."""
        out = self.scale_by(scale) + np.asarray(offset, np.float64)
        if err_radius is not None and np.any(
                np.asarray(err_radius) != 0.0):
            out.terms[symbol or fresh_symbol()] = np.abs(
                np.asarray(err_radius, np.float64))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"AffineForm(center~{np.ravel(self.center)[:3]}, "
                f"{len(self.terms)} terms)")


# --------------------------------------------------------------------------
# interval-range tightening (the domain reduction)
# --------------------------------------------------------------------------

def _combine_bounds(kind: str, a: Array, b: Array) -> Optional[Array]:
    """max/min of two broadcastable bound arrays; ``None`` when the
    broadcast result would not align elementwise with either operand
    (e.g. a (C,) matmul-layout array against a (C,1,1) conv-layout one —
    numpy *would* broadcast them, but to a semantically wrong (C,1,C))."""
    fn = np.maximum if kind == "lo" else np.minimum
    try:
        shape = np.broadcast_shapes(np.shape(a), np.shape(b))
    except ValueError:
        return None
    if shape != np.shape(a) and shape != np.shape(b):
        return None
    return fn(a, b)


def tighten_range(r: ScaledIntRange, a_lo: Array, a_hi: Array
                  ) -> ScaledIntRange:
    """Intersect an interval-domain range with an affine concretization.

    Sound: both are over-approximations of the same value set, so the
    intersection still contains every reachable value.  The scaled-integer
    structure (scale/bias/contribution sets) is preserved; tightening goes
    through the integer grid so ``lo = scale*int_lo + bias`` keeps holding
    exactly.  When bound-array shapes don't align elementwise (different
    broadcast layouts), the affine bounds are clamped against the interval
    *global hull* instead — still sound, since the hull bounds every
    element."""
    a_lo = np.asarray(a_lo, dtype=np.float64)
    a_hi = np.asarray(a_hi, dtype=np.float64)
    if np.any(np.isnan(a_lo)) or np.any(np.isnan(a_hi)):
        return r

    if not r.is_scaled_int:
        lo = _combine_bounds("lo", r.lo, a_lo)
        hi = _combine_bounds("hi", r.hi, a_hi)
        if lo is None or hi is None:
            lo = np.maximum(a_lo, np.min(r.lo))
            hi = np.minimum(a_hi, np.max(r.hi))
        hi = np.maximum(hi, lo)          # guard fp slack at zero width
        return ScaledIntRange(lo=lo, hi=hi)

    # scaled-int: snap the affine bounds outward onto the integer grid
    try:
        q_a_lo = np.ceil((a_lo - r.bias) / r.scale - 1e-9)
        q_a_hi = np.floor((a_hi - r.bias) / r.scale + 1e-9)
    except ValueError:                   # scale/bias don't broadcast
        return r
    int_lo = _combine_bounds("lo", r.int_lo, q_a_lo)
    int_hi = _combine_bounds("hi", r.int_hi, q_a_hi)
    if int_lo is None or int_hi is None:
        int_lo = np.maximum(q_a_lo, np.min(r.int_lo))
        int_hi = np.minimum(q_a_hi, np.max(r.int_hi))
    int_hi = np.maximum(int_hi, int_lo)
    # scale/bias must broadcast INTO the (possibly re-layouted) integer
    # bounds — e.g. a (C,) scale against (C,1,1) tightened bounds would
    # silently mis-broadcast lo to (C,1,C); keep the interval result then
    int_shape = np.shape(int_lo)
    for p in (r.scale, r.bias):
        if p is None:
            continue
        try:
            if np.broadcast_shapes(np.shape(p), int_shape) != int_shape:
                return r
        except ValueError:
            return r
    try:
        return ScaledIntRange.from_scaled_int(
            int_lo, int_hi, r.scale, r.bias,
            scale_src=r.scale_src, bias_src=r.bias_src)
    except (InvalidRangeError, ValueError):
        return r                         # shape mismatch vs scale — keep


# --------------------------------------------------------------------------
# transfer-function registry
# --------------------------------------------------------------------------

def affine_handler(*op_types: str):
    def deco(fn):
        for op in op_types:
            register_op(op, affine=fn)
        return fn
    return deco


def _const_form(r: ScaledIntRange) -> Optional[Array]:
    return r.lo if r.is_point else None


# Add / Sub — exact -------------------------------------------------------

@affine_handler("Add")
def _aff_add(node: Node, graph: Graph, forms: List[AffineForm],
             rs: List[ScaledIntRange]) -> AffineForm:
    return forms[0] + forms[1]


@affine_handler("Sub")
def _aff_sub(node: Node, graph: Graph, forms: List[AffineForm],
             rs: List[ScaledIntRange]) -> AffineForm:
    return forms[0] - forms[1]


# Mul / Div — exact by a constant, linearized otherwise -------------------

@affine_handler("Mul")
def _aff_mul(node: Node, graph: Graph, forms: List[AffineForm],
             rs: List[ScaledIntRange]) -> AffineForm:
    f0, f1 = forms
    c0, c1 = _const_form(rs[0]), _const_form(rs[1])
    if c1 is not None:
        return f0.scale_by(c1)
    if c0 is not None:
        return f1.scale_by(c0)
    # dynamic x dynamic:  x*y = cx*cy + cy*dx + cx*dy + dx*dy,
    # |dx*dy| <= rad(x)*rad(y)  — sound bilinear linearization
    out = f0.scale_by(f1.center) + f1.scale_by(f0.center)
    out = out - f0.center * f1.center
    err = f0.radius() * f1.radius()
    return out.affine_map(1.0, 0.0, err_radius=err,
                          symbol=fresh_symbol(f"mul:{node.name}"))


@affine_handler("Div")
def _aff_div(node: Node, graph: Graph, forms: List[AffineForm],
             rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    c1 = _const_form(rs[1])
    if c1 is None or np.any(c1 == 0.0):
        return None                      # interval fallback
    return forms[0].scale_by(1.0 / c1)


# MatMul / Gemm — constant-weight contraction -----------------------------

def _matmul_form(f: AffineForm, W: Array) -> AffineForm:
    """``x @ W`` with constant W (K, M).  The contraction mixes the K
    elementwise-independent noise entries of every symbol, so the result
    is re-anchored: exact elementwise radius ``|coeff|^T |W|`` under a
    fresh symbol (cross-element correlation is dropped, bounds are the
    exact box hull — identical to ``dot_interval``)."""
    K = W.shape[0]

    def bcast(a: Array) -> Array:
        a = np.asarray(a, dtype=np.float64)
        return np.broadcast_to(a, (K,)) if a.shape != (K,) else a

    center = bcast(f.center) @ W
    rad = np.zeros(W.shape[1])
    for c in f.terms.values():
        rad = rad + np.abs(bcast(c)) @ np.abs(W)
    if np.all(rad == 0.0):
        return AffineForm(center)
    return AffineForm(center, {fresh_symbol("mm"): rad})


@affine_handler("MatMul")
def _aff_matmul(node: Node, graph: Graph, forms: List[AffineForm],
                rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    W1 = _const_form(rs[1])
    if W1 is not None and _const_form(rs[0]) is None:
        return _matmul_form(forms[0], W1)
    W0 = _const_form(rs[0])
    if W0 is not None and _const_form(rs[1]) is None:
        return _matmul_form(forms[1], W0.T)
    return None                          # const@const or dyn@dyn: fallback


@affine_handler("Gemm")
def _aff_gemm(node: Node, graph: Graph, forms: List[AffineForm],
              rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    y = _aff_matmul(node, graph, forms[:2], rs[:2])
    if y is None:
        return None
    if len(forms) == 3:
        y = y + forms[2]
    return y


# ReLU / Clip — min-area linearization keeping scaled input terms ---------

@affine_handler("Relu")
def _aff_relu(node: Node, graph: Graph, forms: List[AffineForm],
              rs: List[ScaledIntRange]) -> AffineForm:
    f = forms[0]
    lo, hi = f.concretize()
    lo = np.minimum(lo, hi)
    # three regimes, handled with elementwise masks:
    #   hi <= 0: output 0;  lo >= 0: identity;  else: y = lam*x + mu +- mu
    # with lam = hi/(hi-lo), mu = -lam*lo/2 (min-area zonotope for ReLU)
    width = hi - lo
    safe = np.where(width > 0, width, 1.0)
    lam = np.where(hi <= 0, 0.0, np.where(lo >= 0, 1.0, hi / safe))
    mu = np.where((hi > 0) & (lo < 0), -lam * lo * 0.5, 0.0)
    # saturated regimes come out exact: lam = mu = 0 zeroes everything
    return f.affine_map(lam, mu, err_radius=mu,
                        symbol=fresh_symbol(f"relu:{node.name}"))


# MultiThreshold — per-channel staircase counting -------------------------

def _per_channel(a: Array, C: int, axis: int, reduce: str) -> Array:
    """Reduce a broadcastable bound array to per-channel ``(C,)`` values.
    ``axis=1`` is the conv layout (channel axis -3 in broadcastable
    terms, e.g. (C,1,1)); anything else is channels-last ((C,))."""
    a = np.asarray(a, dtype=np.float64)
    fn = np.min if reduce == "lo" else np.max
    if axis == 1:
        if a.ndim >= 3 and a.shape[-3] == C:
            red = tuple(i for i in range(a.ndim) if i != a.ndim - 3)
            return fn(a, axis=red) if red else a.reshape(C)
    else:
        if a.ndim >= 1 and a.shape[-1] == C:
            red = tuple(range(a.ndim - 1))
            return fn(a, axis=red) if red else a
    return np.full((C,), float(fn(a)))


@affine_handler("MultiThreshold")
def _aff_multithreshold(node: Node, graph: Graph, forms: List[AffineForm],
                        rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    """Fresh-symbol staircase transfer that, unlike the interval handler,
    keeps **per-channel** structure for conv-layout inputs — counting is
    elementwise-monotone, so per-channel input hulls give exact
    per-channel count bounds."""
    thr = _const_form(rs[1])
    if thr is None or np.asarray(thr).ndim != 2:
        return None
    C = thr.shape[0]
    axis = int(node.attrs.get("axis", -1))
    f_lo, f_hi = forms[0].concretize()
    lo_c = _per_channel(f_lo, C, axis, "lo")
    hi_c = _per_channel(np.maximum(f_lo, f_hi), C, axis, "hi")
    cnt_lo = (lo_c[:, None] >= thr).sum(axis=-1).astype(np.float64)
    cnt_hi = (hi_c[:, None] >= thr).sum(axis=-1).astype(np.float64)
    out_scale = np.asarray(node.attrs.get("out_scale", 1.0), np.float64)
    out_bias = np.asarray(node.attrs.get("out_bias", 0.0), np.float64)
    out_scale = out_scale.reshape(()) if out_scale.size == 1 \
        else out_scale.reshape(-1)
    out_bias = out_bias.reshape(()) if out_bias.size == 1 \
        else out_bias.reshape(-1)
    v_a = out_bias + out_scale * cnt_lo
    v_b = out_bias + out_scale * cnt_hi
    v_lo, v_hi = np.minimum(v_a, v_b), np.maximum(v_a, v_b)
    if axis == 1:                        # conv layout: (C,) -> (C,1,1)
        v_lo = v_lo.reshape(C, 1, 1)
        v_hi = v_hi.reshape(C, 1, 1)
    return AffineForm.from_interval(
        v_lo, v_hi, fresh_symbol(f"thr:{node.name}"))


# Quant — fresh anchor at the (tightened) interval output -----------------
# Registered as an explicit rule (not the generic fallback) so the fresh
# symbol is named after the node: rounding breaks elementwise linearity,
# so the correlation with the input is dropped by design.

@affine_handler("Quant")
def _aff_quant(node: Node, graph: Graph, forms: List[AffineForm],
               rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    return None                          # fresh form over interval output


# wire ops — exact for position-independent (scalar) coefficients ---------

def _aff_wire(node: Node, graph: Graph, forms: List[AffineForm],
              rs: List[ScaledIntRange]) -> Optional[AffineForm]:
    f = forms[0]
    if node.op_type == "Identity":
        return f
    scalars = np.size(f.center) == 1 and all(
        np.size(c) == 1 for c in f.terms.values())
    return f if scalars else None        # element moves: fallback to hull


for _op in ("Identity", "Reshape", "Flatten", "Transpose", "Pad"):
    register_op(_op, affine=_aff_wire)


# --------------------------------------------------------------------------
# the reduced-product step (called from propagate.SIRA)
# --------------------------------------------------------------------------

def affine_step(node: Node, graph: Graph,
                forms: Dict[str, AffineForm],
                in_ranges: List[ScaledIntRange],
                out_ranges: Sequence[ScaledIntRange]
                ) -> List[ScaledIntRange]:
    """One node of the reduced product: run the affine transfer (if any),
    intersect with the interval outputs, and record output forms.
    Returns the tightened ranges, positionally matching ``node.outputs``."""
    fn = AFFINE_REGISTRY.get(node.op_type)
    in_forms = [forms[t] for t in node.inputs]
    a_outs: Optional[Tuple] = None
    if fn is not None:
        res = fn(node, graph, in_forms, in_ranges)
        if res is not None:
            a_outs = res if isinstance(res, tuple) else (res,)
    tightened: List[ScaledIntRange] = []
    for i, (name, r) in enumerate(zip(node.outputs, out_ranges)):
        form = a_outs[i] if a_outs is not None and i < len(a_outs) \
            and a_outs[i] is not None else None
        if form is None:
            tightened.append(r)
            forms[name] = AffineForm.from_range(r, fresh_symbol(name))
            continue
        a_lo, a_hi = form.concretize()
        r2 = tighten_range(r, a_lo, a_hi)
        tightened.append(r2)
        forms[name] = form
    return tightened


def seed_forms(graph: Graph,
               input_ranges: Dict[str, ScaledIntRange]
               ) -> Dict[str, AffineForm]:
    forms: Dict[str, AffineForm] = {}
    for name, val in graph.initializers.items():
        forms[name] = AffineForm.point(np.asarray(val, np.float64))
    for name, r in input_ranges.items():
        forms[name] = AffineForm.from_range(r, f"in:{name}")
    return forms
