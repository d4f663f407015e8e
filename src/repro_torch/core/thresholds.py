"""Converting quantized layer tails to thresholds (paper §4.1.3, Fig 11).

The multi-threshold function

    f_T(x) = out_bias + out_scale * sum_i (x >= T_i)

replaces an entire *layer tail*: the chain of elementwise ops (aggregated
scale/bias, activation) terminating in a uniform quantizer.  We implement
the paper's extraction — evaluate the tail subgraph end-to-end over the
SIRA-provided integer input range and pick up the steps with an
edge-detection convolution — plus a beyond-paper *bisection* extractor that
finds each threshold by binary search (O(N log R) instead of O(R) subgraph
evaluations), used automatically for wide accumulator ranges.

Exactness contract (Eq. 3): for integer inputs within the SIRA range, the
MultiThreshold output equals the original tail output exactly.  That only
holds when the (quantized) tail is monotone per channel, so every
extraction is gated on a :class:`~repro_torch.core.monotone.MonotoneCertificate`:

  * certified ``monotone`` / ``representable`` tails convert — increasing
    channels exactly as before, decreasing channels via direction-aware
    enumeration / descending bisection with a negated per-channel
    ``out_scale`` (out = b - s * count of thresholds passed);
  * ``uncertified`` tails are left in place, annotated with the
    certificate's machine-readable reason code so the dataflow DSE prices
    the elementwise meta-kernel instead.

Tail entry points may be *scaled* integer tensors (``x = s·q + b`` with
``s > 0`` per SIRA's scaled-int invariant), not just raw accumulators:
non-homogeneous activations (Silu, Tanh, hard-swish) block the
streamliner from pushing quantizer scales past the next matmul, so their
tails begin at a scaled tensor.  Thresholds are then extracted on the
integer grid ``q`` and emitted in real units at grid *midpoints*
(``s·(T - ½) + b``), which keeps the integer comparison exact under
floating-point accumulation noise.

Note on Eq. 2: the paper's sign-bias expression has an off-by-one typo; we
use ``out_bias = qmin`` (the count runs over N = qmax - qmin thresholds),
which is exact for signed/unsigned and narrow/wide ranges alike.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .graph import Graph, Node, fresh_name, quant_bounds
from .intervals import ScaledIntRange
from .propagate import analyze
from . import monotone as _monotone

# elementwise ops allowed inside a layer tail (dynamic input at slot 0,
# other inputs constant)
TAIL_ELEMENTWISE = {"Mul", "Add", "Sub", "Div", "Relu", "Sigmoid", "Tanh",
                    "Softcap", "Silu", "Gelu", "HardSwish", "Abs", "Clip",
                    "Identity"}

# enumeration cutoff: above this range size, use bisection extraction
EDGE_DETECT_MAX_RANGE = 1 << 16


class ThresholdConversionError(ValueError):
    """A layer tail cannot be exactly converted to thresholds.

    ``reason`` is a machine-readable code (``nonmonotone-on-grid``,
    ``grid-too-large:<R>``, ``no-monotone-rule:<Op>``,
    ``quantizer-granularity``, ``entry-granularity``,
    ``nonmonotone-evaluation``, ...) that ends up on the unconverted
    nodes for the dataflow DSE to consume."""

    def __init__(self, reason: str, message: Optional[str] = None):
        super().__init__(message or reason)
        self.reason = reason


@dataclasses.dataclass
class LayerTail:
    quant_node: Node
    nodes: List[Node]          # tail nodes, topo order, quant included
    input_tensor: str          # (scaled-)integer tensor entering the tail
    channel_axis: int


def _is_unit_entry(r: Optional[ScaledIntRange]) -> bool:
    return (r is not None and r.is_scaled_int and
            bool(np.all(r.scale == 1.0)) and bool(np.all(r.bias == 0.0)))


def find_layer_tails(g: Graph,
                     ranges: Dict[str, ScaledIntRange]) -> List[LayerTail]:
    """Anchor at each final Quant and walk upwards through elementwise
    ops.  The preferred entry point is a raw integer (scale-1, bias-0
    scaled-int) tensor; when the walk gets stuck before reaching one
    (e.g. the producing matmul consumed a *scaled* input because a
    non-homogeneous activation blocked scale aggregation), the deepest
    scaled-int tensor seen becomes the entry — extraction handles the
    affine input grid."""
    g.toposort()
    tails: List[LayerTail] = []
    claimed: set = set()
    for node in reversed(g.nodes):
        if node.op_type != "Quant" or node.name in claimed:
            continue
        chain: List[Node] = [node]
        cur = node.inputs[0]
        ok = True
        # (tensor, chain length) of scaled-int tensors passed on the way
        fallback: Optional[Tuple[str, int]] = None
        while True:
            r = ranges.get(cur)
            if _is_unit_entry(r):
                break  # integer entry point found
            if r is not None and r.is_scaled_int:
                fallback = (cur, len(chain))
            prod = g.producer(cur)
            if prod is None or prod.op_type not in TAIL_ELEMENTWISE:
                ok = False
                break
            if len(g.consumers(cur)) != 1:
                ok = False  # branching inside the tail — unsupported
                break
            if any(not g.is_constant(t) for t in prod.inputs[1:]):
                ok = False
                break
            chain.append(prod)
            cur = prod.inputs[0]
        if not ok and fallback is not None:
            cur, depth = fallback
            chain = chain[:depth]
            ok = True
        if not ok or len(chain) < 1:
            continue
        r = ranges.get(cur)
        if r is None or not r.is_scaled_int:
            continue
        prod = g.producer(cur)
        axis = -1
        if prod is not None and prod.op_type == "Conv":
            axis = 1
        elif any(g.is_constant(t) and
                 np.asarray(g.initializers[t]).ndim == 3
                 for n in chain for t in n.inputs[1:]):
            axis = 1   # (C,1,1)-shaped params ⇒ channels-first layout
        for n in chain:
            claimed.add(n.name)
        tails.append(LayerTail(quant_node=node,
                               nodes=list(reversed(chain)),
                               input_tensor=cur, channel_axis=axis))
    return tails


# --------------------------------------------------------------------------
# tail evaluation
# --------------------------------------------------------------------------

def _tail_subgraph(g: Graph, tail: LayerTail) -> Graph:
    sub = Graph(inputs=[tail.input_tensor],
                outputs=[tail.quant_node.outputs[0]])
    sub.nodes = [Node(n.op_type, list(n.inputs), list(n.outputs),
                      dict(n.attrs), name=n.name) for n in tail.nodes]
    for n in sub.nodes:
        for t in n.inputs:
            if g.is_constant(t):
                sub.initializers[t] = g.initializers[t]
    return sub


def _tail_params_channels(g: Graph, tail: LayerTail) -> int:
    """Number of channels = finest granularity among tail parameters
    (paper: 'the finest granularity of any of the fused operators')."""
    C = 1
    for n in tail.nodes:
        for t in n.inputs[1:]:
            if g.is_constant(t):
                C = max(C, int(np.size(g.initializers[t])))
    return C


def _eval_tail(sub: Graph, xs: np.ndarray, C: int, axis: int,
               in_scale: Optional[np.ndarray] = None,
               in_bias: Optional[np.ndarray] = None) -> np.ndarray:
    """Evaluate the tail for a column of integer inputs per channel.

    xs: (R,) integer inputs; returns (R, C) outputs.  ``in_scale`` /
    ``in_bias`` map the integer grid to the entry tensor's real values
    (``x = s·q + b``) for scaled entry points."""
    s = np.ones(C) if in_scale is None else in_scale
    b = np.zeros(C) if in_bias is None else in_bias
    if axis == -1:
        x = xs[:, None] * s[None, :] + b[None, :]           # (R, C)
        y = sub.execute({sub.inputs[0]: x})[sub.outputs[0]]
        return y.reshape(xs.size, C)
    # channels-first (Conv): shape (1, C, R, 1) then move back
    x = (xs[None, None, :, None] * s[None, :, None, None]
         + b[None, :, None, None])
    y = sub.execute({sub.inputs[0]: x})[sub.outputs[0]]
    return np.moveaxis(y.reshape(C, xs.size), 0, 1)


def _entry_affine(r_in: ScaledIntRange,
                  C: int) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Per-channel (scale, bias) of the entry tensor's integer grid, plus
    whether the entry is a raw integer tensor (scale 1, bias 0)."""
    s = np.asarray(r_in.scale, np.float64).reshape(-1)
    b = np.asarray(r_in.bias, np.float64).reshape(-1)
    if s.size not in (1, C) or b.size not in (1, C):
        raise ThresholdConversionError(
            "entry-granularity",
            f"entry scale/bias granularity ({s.size}/{b.size}) does not "
            f"match tail channels {C}")
    unit = bool(np.all(s == 1.0) and np.all(b == 0.0))
    s_c = np.full(C, s[0]) if s.size == 1 else s.copy()
    b_c = np.full(C, b[0]) if b.size == 1 else b.copy()
    return s_c, b_c, unit


def _entry_int_bounds(r_in: ScaledIntRange,
                      C: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel integer bounds of the entry tensor ((C,) int64);
    channel hull when the granularity does not match."""
    il = np.asarray(r_in.int_lo, np.float64).reshape(-1)
    ih = np.asarray(r_in.int_hi, np.float64).reshape(-1)
    if il.size == C and ih.size == C:
        return (np.floor(il).astype(np.int64),
                np.ceil(ih).astype(np.int64))
    lo = int(np.floor(np.min(il)))
    hi = int(np.ceil(np.max(ih)))
    return np.full(C, lo, np.int64), np.full(C, hi, np.int64)


@dataclasses.dataclass
class TailEvaluator:
    """Quantized end-to-end evaluation of one layer tail.

    ``f_int(xs)`` maps (R,) integer grid points to the (R, C) integer
    output *levels* (count + qmin) the terminating quantizer would emit;
    ``in_scale`` / ``in_bias`` map grid points to entry-tensor values."""
    f_int: Callable[[np.ndarray], np.ndarray]
    C: int
    qmin: int
    qmax: int
    n_steps: int
    s_q: np.ndarray            # quantizer scale, raw granularity (1 or C)
    z_q: np.ndarray            # quantizer zero point, raw granularity
    in_scale: np.ndarray       # (C,) entry grid scale
    in_bias: np.ndarray        # (C,) entry grid bias
    unit_entry: bool = True


def tail_evaluator(g: Graph, tail: LayerTail,
                   ranges: Optional[Dict[str, ScaledIntRange]] = None
                   ) -> TailEvaluator:
    qn = tail.quant_node
    bits = int(g.initializers[qn.inputs[3]])
    signed = bool(qn.attrs.get("signed", 1))
    narrow = bool(qn.attrs.get("narrow", 0))
    qmin, qmax = quant_bounds(bits, signed, narrow)

    sub = _tail_subgraph(g, tail)
    C = _tail_params_channels(g, tail)
    if ranges is not None:
        r_in = ranges[tail.input_tensor]
        if not r_in.is_scaled_int:
            raise ThresholdConversionError(
                "entry-not-integer",
                f"tail entry {tail.input_tensor!r} has no integer grid")
        in_scale, in_bias, unit = _entry_affine(r_in, C)
    else:
        in_scale, in_bias, unit = np.ones(C), np.zeros(C), True

    # Per-channel quantizer parameters: (C,) arrays broadcast over the
    # per-channel tail evaluation below.  A granularity that matches
    # neither per-tensor nor the tail's channel count cannot be expressed
    # as one threshold row per channel — reject instead of miscompiling
    # (the old code silently collapsed the arrays to element 0).
    s_q = np.asarray(g.initializers[qn.inputs[1]],
                     dtype=np.float64).reshape(-1)
    z_q = np.asarray(g.initializers[qn.inputs[2]],
                     dtype=np.float64).reshape(-1)
    for name, arr in (("scale", s_q), ("zero_point", z_q)):
        if arr.size not in (1, C):
            raise ThresholdConversionError(
                "quantizer-granularity",
                f"quantizer {name} granularity {arr.size} does not match "
                f"tail channels {C} — cannot threshold")

    def f_int(xs: np.ndarray) -> np.ndarray:
        """Integer output level (count + qmin) for integer grid points."""
        y = _eval_tail(sub, xs.astype(np.float64), C, tail.channel_axis,
                       in_scale, in_bias)
        lev = np.round(y / s_q + z_q)       # (R, C) / (C,) broadcast
        return np.clip(lev, qmin, qmax)     # the quantizer saturates

    return TailEvaluator(f_int=f_int, C=C, qmin=int(qmin), qmax=int(qmax),
                         n_steps=int(qmax - qmin), s_q=s_q, z_q=z_q,
                         in_scale=in_scale, in_bias=in_bias,
                         unit_entry=unit)


@dataclasses.dataclass
class ThresholdSpec:
    thresholds: np.ndarray     # (C, N) ascending, in entry-tensor units
    out_scale: Union[float, np.ndarray]   # scalar, or (C,) per-channel
    out_bias: Union[float, np.ndarray]
    n_steps: int
    method: str = "edge"       # extraction path actually taken
    direction: Optional[np.ndarray] = None           # (C,) in {-1, 0, +1}
    certificate: Optional[_monotone.MonotoneCertificate] = None


@dataclasses.dataclass
class TailReport:
    """Per-tail conversion outcome (attached to SiraModel metadata)."""
    anchor: str                # terminating Quant node name
    input_tensor: str
    n_ops: int                 # tail length including the quantizer
    converted: bool
    status: str                # certificate status
    method: str = ""           # extraction method when converted
    reason: str = ""           # machine-readable code when unconverted


def _extract_edge(f_int: Callable[[np.ndarray], np.ndarray],
                  lo_c: np.ndarray, hi_c: np.ndarray, qmin: int, N: int,
                  d: np.ndarray, C: int) -> np.ndarray:
    """Direction-aware enumeration (edge detection) over the full grid,
    restricted to each channel's own proven integer range.  Returns
    integer-grid thresholds (±inf proxies: lo_c / hi_c + 1)."""
    lo, hi = int(lo_c.min()), int(hi_c.max())
    xs = np.arange(lo, hi + 1, dtype=np.int64)
    levels = f_int(xs)                        # (R, C)
    thr = np.empty((C, N), np.float64)
    for c in range(C):
        i0, i1 = int(lo_c[c] - lo), int(hi_c[c] - lo)
        seg = levels[i0:i1 + 1, c]
        steps = np.diff(seg)                  # edge detection kernel [-1,1]
        sx = xs[i0 + 1:i1 + 1]
        thr[c, :] = float(hi_c[c] + 1)        # +inf proxy (right pad)
        stc = np.rint(steps * (1.0 if d[c] >= 0 else -1.0)).astype(
            np.int64)
        if np.any(stc < 0):
            # the evaluation contradicts the certificate — refuse rather
            # than emit thresholds violating the exactness contract
            raise ThresholdConversionError(
                "nonmonotone-evaluation",
                f"channel {c} steps contradict certified direction")
        t_list = np.repeat(sx, stc)           # threshold at each unit step
        if d[c] >= 0:
            # left-pad: f(lo) above qmin ⇒ thresholds below the range
            # (−inf proxy: any value ≤ all in-range inputs)
            n_left = int(round(seg[0] - qmin))
            t_full = np.concatenate(
                [np.full(n_left, float(lo_c[c])), t_list])
        else:
            # decreasing: count starts at 0 ⇒ out_bias carries f(lo); the
            # thresholds mark each unit *drop*, no left pad
            t_full = t_list.astype(np.float64)
        t_full = t_full[:N]
        thr[c, :t_full.size] = t_full
    return thr


def _extract_bisect(f_int: Callable[[np.ndarray], np.ndarray],
                    lo_c: np.ndarray, hi_c: np.ndarray, qmin: int, N: int,
                    d: np.ndarray, C: int) -> np.ndarray:
    """Direction-aware bisection: O(N log R) point evaluations.  Sound
    only under a monotonicity certificate — the certificate replaces the
    old (unsound) coarse probe-grid check."""
    thr = np.empty((C, N), np.float64)
    for c in range(C):
        lo, hi = int(lo_c[c]), int(hi_c[c])
        thr[c, :] = float(hi + 1)
        lev_lo = float(f_int(np.array([lo]))[0, c])
        lev_hi = float(f_int(np.array([hi]))[0, c])
        if d[c] >= 0:
            for j in range(N):
                level = qmin + j + 1           # first x with f(x) >= level
                if lev_hi < level:
                    break                      # +inf proxy stays
                if lev_lo >= level:
                    thr[c, j] = float(lo)      # −inf proxy
                    continue
                a, b = lo, hi                  # f(a) < level <= f(b)
                while a + 1 < b:
                    m = (a + b) // 2
                    if f_int(np.array([m]))[0, c] >= level:
                        b = m
                    else:
                        a = m
                thr[c, j] = float(b)
        else:
            drops = int(round(lev_lo - lev_hi))
            for j in range(min(drops, N)):
                target = lev_lo - (j + 1)      # first x with f(x) <= target
                a, b = lo, hi                  # f(a) > target >= f(b)
                while a + 1 < b:
                    m = (a + b) // 2
                    if f_int(np.array([m]))[0, c] <= target:
                        b = m
                    else:
                        a = m
                thr[c, j] = float(b)
    return thr


def extract_thresholds(
        g: Graph, tail: LayerTail,
        ranges: Dict[str, ScaledIntRange],
        method: str = "auto",
        certificate: Optional[_monotone.MonotoneCertificate] = None,
) -> ThresholdSpec:
    r_in = ranges[tail.input_tensor]
    ev = tail_evaluator(g, tail, ranges)
    C, qmin, N = ev.C, ev.qmin, ev.n_steps
    lo_c, hi_c = _entry_int_bounds(r_in, C)
    lo, hi = int(lo_c.min()), int(hi_c.max())

    if certificate is None:
        certificate = _monotone.certify_tail(g, tail, ranges)
    if not certificate.certified:
        raise ThresholdConversionError(
            certificate.reason,
            f"tail at {tail.quant_node.name!r} not certified monotone "
            f"({certificate.reason})")
    d = np.asarray(certificate.direction, np.int64).reshape(-1)
    if d.size == 1 and C > 1:
        d = np.full(C, d[0])
    if d.size != C:
        raise ThresholdConversionError(
            "certificate-channels",
            f"certificate covers {d.size} channels, tail has {C}")

    if method == "auto":
        method = "edge" if (hi - lo) <= EDGE_DETECT_MAX_RANGE else "bisect"
    if method == "edge":
        thr = _extract_edge(ev.f_int, lo_c, hi_c, qmin, N, d, C)
    else:
        thr = _extract_bisect(ev.f_int, lo_c, hi_c, qmin, N, d, C)
    if not ev.unit_entry:
        # scaled entry: emit real-unit thresholds at grid *midpoints* so
        # floating-point noise on the entry tensor (≪ half a grid step)
        # cannot flip a comparison; s > 0 keeps rows ascending
        thr = ev.in_scale[:, None] * (thr - 0.5) + ev.in_bias[:, None]
    # thresholds must be ascending per channel
    thr = np.sort(thr, axis=1)

    s_q, z_q = ev.s_q, ev.z_q
    if np.all(d >= 0):
        out_scale: Union[float, np.ndarray] = \
            s_q if s_q.size > 1 else float(s_q[0])
        ob = np.asarray(s_q * (qmin - z_q), dtype=np.float64).reshape(-1)
        out_bias: Union[float, np.ndarray] = \
            ob if ob.size > 1 else float(ob[0])
    else:
        # decreasing channels: out = bias - s * count, with the bias
        # carrying the (dequantized) level at the range's low end
        s_c = np.broadcast_to(s_q, (C,)).astype(np.float64)
        z_c = np.broadcast_to(z_q, (C,)).astype(np.float64)
        lev_lo = np.array([float(ev.f_int(np.array([lo_c[c]]))[0, c])
                           for c in range(C)])
        sign = np.where(d < 0, -1.0, 1.0)
        out_scale = sign * s_c
        out_bias = np.where(d < 0, s_c * (lev_lo - z_c),
                            s_c * (qmin - z_c))
    return ThresholdSpec(thresholds=thr, out_scale=out_scale,
                         out_bias=out_bias, n_steps=N, method=method,
                         direction=d, certificate=certificate)


def convert_tails(
        g: Graph, ranges: Dict[str, ScaledIntRange],
        method: str = "auto",
) -> Tuple[List[ThresholdSpec], List[TailReport]]:
    """Threshold-conversion core: replace every *certified* layer tail
    with a MultiThreshold node, **in place**, given a range analysis of
    ``g``.  Uncertifiable tails are left as elementwise chains, annotated
    with the certificate's reason code (``unconverted_reason`` on the
    quantizer, ``meta_kernel_reason`` on the chain ops) for the dataflow
    DSE and the linter."""
    tails = find_layer_tails(g, ranges)
    specs: List[ThresholdSpec] = []
    reports: List[TailReport] = []
    for tail in tails:
        cert = _monotone.certify_tail(g, tail, ranges)
        reason: Optional[str] = None
        spec: Optional[ThresholdSpec] = None
        try:
            spec = extract_thresholds(g, tail, ranges, method=method,
                                      certificate=cert)
        except ThresholdConversionError as e:
            reason = e.reason
        except ValueError:
            reason = "extraction-failed"
        if spec is None:
            tail.quant_node.attrs["unconverted_reason"] = reason
            for n in tail.nodes[:-1]:
                n.attrs["meta_kernel_reason"] = reason
            reports.append(TailReport(
                anchor=tail.quant_node.name,
                input_tensor=tail.input_tensor, n_ops=len(tail.nodes),
                converted=False, status=cert.status, reason=reason or ""))
            continue
        out_t = tail.quant_node.outputs[0]
        thr_name = g.add_initializer(spec.thresholds,
                                     name=fresh_name("thresholds"))
        for n in tail.nodes:
            g.remove_node(n)
        g.add_node("MultiThreshold", [tail.input_tensor, thr_name], [out_t],
                   attrs=dict(axis=tail.channel_axis,
                              out_scale=spec.out_scale,
                              out_bias=spec.out_bias,
                              certificate=cert.summary))
        specs.append(spec)
        reports.append(TailReport(
            anchor=tail.quant_node.name, input_tensor=tail.input_tensor,
            n_ops=len(tail.nodes), converted=True, status=cert.status,
            method=spec.method))
    g.toposort()
    g.dead_code_eliminate()
    return specs, reports


def convert_tails_with_ranges(
        g: Graph, ranges: Dict[str, ScaledIntRange],
        method: str = "auto") -> List[ThresholdSpec]:
    """Back-compat wrapper around :func:`convert_tails` returning only the
    extracted specs."""
    specs, _ = convert_tails(g, ranges, method=method)
    return specs


def convert_tails_to_thresholds(
        g: Graph, input_ranges: Dict[str, ScaledIntRange],
        method: str = "auto") -> Tuple[Graph, List[ThresholdSpec]]:
    """Deprecated shim — prefer ``passes.ConvertTailsToThresholds`` on a
    ``SiraModel`` (which reuses the model's cached analysis)."""
    g = g.copy()
    ranges = analyze(g, input_ranges)
    specs = convert_tails_with_ranges(g, ranges, method=method)
    return g, specs
