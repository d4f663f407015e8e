"""SIRA: node-by-node scaled-integer range propagation (paper §3, Listing 1).

For every tensor in a Graph we compute a :class:`ScaledIntRange`. Handlers
implement the paper's propagation rules:

  * Quant anchors scaled-integer ranges (§3.2.1).
  * Add propagates when one input is constant, or both are scaled-int with an
    integer scale ratio (§3.2.2).
  * Mul propagates when one input is constant (§3.2.3).
  * MatMul/Conv propagate with per-channel weight scales, zero weight bias,
    per-tensor (per-channel for depthwise) input scales (§3.2.4).
  * Elementwise monotonic ops propagate plain ranges (§2.4.1); value-preserving
    ops (MaxPool, Concat, transpositions) keep the scaled-int structure.
  * Dynamic x dynamic matmuls propagate plain interval hulls (beyond-paper,
    conservative; needed for attention score/PV matmuls in LM blocks).

Contribution tracking (scale_src / bias_src) feeds the streamlining
transform; POISON marks ranges whose scale cannot be erased exactly
(e.g. scaled-int Add with ratio k != 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .graph import Graph, Node, quant_bounds, round_half_to_even
from .intervals import (Array, ScaledIntRange, add_intervals, dot_interval,
                        monotonic_fn_interval, mul_intervals)
from .ops import PROP_REGISTRY, register_op  # noqa: F401  (re-exported)
from ..obs.explain import RangeProvenance
from ..obs.trace import get_tracer

POISON = "!unerasable"

# Full-analysis call counter.  ``SiraModel`` caches analysis results keyed
# on the graph version; this counter lets tests (and build_flow step
# reports) assert how many *full* range propagations actually ran.
ANALYSIS_CALLS = 0


def analysis_calls() -> int:
    return ANALYSIS_CALLS


def handler(*op_types: str):
    def deco(fn):
        for op in op_types:
            register_op(op, propagate=fn)
        return fn
    return deco


DOMAINS = ("interval", "affine")


class SIRA:
    """Scaled-integer range analysis over a Graph (paper Listing 1).

    ``domain="interval"`` (default) runs the paper's propagation.
    ``domain="affine"`` runs a *reduced product* with the zonotope domain
    of :mod:`repro_torch.core.affine`: the interval handlers see affine-tightened
    inputs and every output is intersected with the affine concretization,
    so affine results are contained in interval results by construction.
    """

    def __init__(self, graph: Graph, domain: str = "interval"):
        if domain not in DOMAINS:
            raise ValueError(f"unknown domain {domain!r}; "
                             f"expected one of {DOMAINS}")
        self.graph = graph
        self.domain = domain

    def run(self, input_ranges: Dict[str, ScaledIntRange],
            record: Optional[Dict[str, RangeProvenance]] = None
            ) -> Dict[str, ScaledIntRange]:
        global ANALYSIS_CALLS
        ANALYSIS_CALLS += 1
        with get_tracer().span("analysis:propagate", domain=self.domain,
                               nodes=len(self.graph.nodes),
                               provenance=record is not None):
            return self._run(input_ranges, record)

    def _run(self, input_ranges: Dict[str, ScaledIntRange],
             record: Optional[Dict[str, RangeProvenance]]
             ) -> Dict[str, ScaledIntRange]:
        if self.domain == "affine":
            raise NotImplementedError(
                "domain='affine' is not ported yet, see ROADMAP A")
        ranges: Dict[str, ScaledIntRange] = {}
        for name, val in self.graph.initializers.items():
            ranges[name] = ScaledIntRange.point(val)
            if record is not None:
                record[name] = _seed_record(name, "const", ranges[name],
                                            self.domain)
        for name, r in input_ranges.items():
            ranges[name] = r
            if record is not None:
                record[name] = _seed_record(name, "input", r, self.domain)
        missing = [i for i in self.graph.inputs if i not in ranges]
        if missing:
            raise ValueError(f"missing input ranges for {missing}")
        self.graph.toposort()
        for node in self.graph.nodes:
            fn = PROP_REGISTRY.get(node.op_type)
            if fn is None:
                raise NotImplementedError(
                    f"no SIRA handler for op {node.op_type}")
            in_ranges = [ranges[i] for i in node.inputs]
            outs = fn(node, self.graph, in_ranges)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for name, r in zip(node.outputs, outs):
                ranges[name] = r
                if record is not None:
                    record[name] = _node_record(
                        name, node, self.graph, fn, in_ranges, r,
                        self.domain, False)
        return ranges


def analyze(graph: Graph, input_ranges: Dict[str, ScaledIntRange],
            domain: str = "interval",
            record: Optional[Dict[str, RangeProvenance]] = None
            ) -> Dict[str, ScaledIntRange]:
    return SIRA(graph, domain=domain).run(input_ranges, record=record)


# --------------------------------------------------------------------------
# provenance recording (repro_torch.obs.explain)
# --------------------------------------------------------------------------

def _width(r: ScaledIntRange) -> float:
    if r.is_point:
        return 0.0
    return float(np.max(np.asarray(r.hi) - np.asarray(r.lo)))


def _range_str(r: ScaledIntRange) -> str:
    lo, hi = float(np.min(r.lo)), float(np.max(r.hi))
    return f"[{lo:g}, {hi:g}]"


def _bits(r: ScaledIntRange) -> Optional[int]:
    return int(r.required_signed_bits()) if r.is_scaled_int else None


def _seed_record(name: str, kind: str, r: ScaledIntRange,
                 domain: str) -> RangeProvenance:
    return RangeProvenance(
        tensor=name, node_name="", op_type=kind, handler=kind,
        domain=domain, affine_tightened=False, inputs=(), culprit=None,
        width=_width(r), in_widths={}, bits=_bits(r),
        range_str=_range_str(r))


def _node_record(name: str, node: Node, graph: Graph, fn,
                 in_ranges: List[ScaledIntRange], r: ScaledIntRange,
                 domain: str, tightened: bool) -> RangeProvenance:
    in_widths: Dict[str, float] = {}
    for t, ir in zip(node.inputs, in_ranges):
        if not graph.is_constant(t):
            in_widths[t] = _width(ir)
    culprit = max(in_widths, key=in_widths.__getitem__, default=None) \
        if in_widths else None
    return RangeProvenance(
        tensor=name, node_name=node.name, op_type=node.op_type,
        handler=getattr(fn, "__name__", str(fn)), domain=domain,
        affine_tightened=tightened, inputs=tuple(in_widths),
        culprit=culprit, width=_width(r), in_widths=in_widths,
        bits=_bits(r), range_str=_range_str(r))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _const_val(r: ScaledIntRange) -> Array:
    return r.lo


def _is_scalar(a: Optional[Array]) -> bool:
    return a is not None and np.size(a) == 1


def _contrib_name(graph: Graph, node: Node, idx: int) -> frozenset:
    """Contribution id of a node input: its initializer name if constant."""
    t = node.inputs[idx]
    return frozenset({t}) if graph.is_constant(t) else frozenset({POISON})


# --------------------------------------------------------------------------
# Quant (§3.2.1)
# --------------------------------------------------------------------------

@handler("Quant")
def _prop_quant(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    rx, rs_scale, rs_zp, rs_bits = rs
    s = _const_val(rs_scale)
    z = _const_val(rs_zp)
    b = int(_const_val(rs_bits))
    signed = bool(node.attrs.get("signed", 1))
    narrow = bool(node.attrs.get("narrow", 0))
    qmin, qmax = quant_bounds(b, signed, narrow)
    q_lo = np.clip(round_half_to_even(rx.lo / s + z), qmin, qmax)
    q_hi = np.clip(round_half_to_even(rx.hi / s + z), qmin, qmax)
    # output = s * (q - z) = s * q + (-s * z).  A trivial quantizer
    # (s=1, z=0) anchors a fresh integer range with no contributors; a
    # non-trivial one cannot be erased by constant substitution (the
    # streamliner explicitizes it first), so mark POISON.
    if np.all(s == 1.0) and np.all(z == 0.0):
        scale_src = bias_src = frozenset()
    else:
        scale_src = frozenset({POISON})
        bias_src = frozenset({POISON}) if np.any(z != 0) else frozenset()
    return ScaledIntRange.from_scaled_int(
        q_lo, q_hi, s, -s * z, scale_src=scale_src, bias_src=bias_src)


@handler("MultiThreshold")
def _prop_multithreshold(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    rx, rthr = rs
    thr = _const_val(rthr)  # (C, N)
    axis = int(node.attrs.get("axis", -1))
    # scalar attrs stay 0-d (downstream consumers call float(r.scale));
    # per-channel arrays become (C,)
    out_scale = np.asarray(node.attrs.get("out_scale", 1.0), np.float64)
    out_bias = np.asarray(node.attrs.get("out_bias", 0.0), np.float64)
    out_scale = out_scale.reshape(()) if out_scale.size == 1 \
        else out_scale.reshape(-1)
    out_bias = out_bias.reshape(()) if out_bias.size == 1 \
        else out_bias.reshape(-1)
    C, N = thr.shape
    # reduce range to per-channel: take channel-hull of lo/hi
    lo_c = np.full((C,), float(np.min(rx.lo)))
    hi_c = np.full((C,), float(np.max(rx.hi)))
    if rx.lo.shape == (C,):
        lo_c, hi_c = rx.lo, rx.hi
    cnt_lo = (lo_c[:, None] >= thr).sum(axis=-1).astype(np.float64)
    cnt_hi = (hi_c[:, None] >= thr).sum(axis=-1).astype(np.float64)
    # certified-decreasing channels carry a negative out_scale; fold the
    # sign into the integer component (out = b + |s| * (sign(s) * cnt)) so
    # the scaled-int invariant (scale > 0) holds
    scale = np.asarray(out_scale, np.float64)
    if np.any(scale <= 0):
        if np.any(scale == 0):
            lo = out_bias + np.minimum(scale * cnt_lo, scale * cnt_hi)
            hi = out_bias + np.maximum(scale * cnt_lo, scale * cnt_hi)
            return ScaledIntRange(lo=lo, hi=hi)
        neg = scale < 0
        cnt_lo, cnt_hi = (np.where(neg, -cnt_hi, cnt_lo),
                          np.where(neg, -cnt_lo, cnt_hi))
        scale = np.abs(scale)
    return ScaledIntRange.from_scaled_int(
        cnt_lo, cnt_hi, scale, np.asarray(out_bias))


# --------------------------------------------------------------------------
# Add / Sub (§3.2.2) and Mul / Div (§3.2.3)
# --------------------------------------------------------------------------

def _prop_add_like(node, graph, r0, r1, sign1, src1):
    """out = r0 + sign1 * r1."""
    lo1, hi1 = (sign1 * r1.hi, sign1 * r1.lo) if sign1 < 0 else (
        sign1 * r1.lo, sign1 * r1.hi)
    lo, hi = add_intervals(r0.lo, r0.hi, lo1, hi1)
    # case 1: r0 scaled-int, r1 constant → absorb into bias
    if r0.is_scaled_int and r1.is_point:
        return ScaledIntRange.from_scaled_int(
            np.broadcast_to(r0.int_lo, np.broadcast(r0.int_lo, lo1).shape),
            np.broadcast_to(r0.int_hi, np.broadcast(r0.int_hi, hi1).shape),
            r0.scale, r0.bias + sign1 * _const_val(r1),
            scale_src=r0.scale_src, bias_src=r0.bias_src | src1)
    # case 2: both scaled-int with integer scale ratio (Add direction only)
    if sign1 > 0 and r0.is_scaled_int and r1.is_scaled_int and \
            _is_scalar(r0.scale) and _is_scalar(r1.scale):
        k = float(r1.scale) / float(r0.scale)
        if abs(k - round(k)) < 1e-9 and round(k) != 0:
            k = round(k)
            q_lo = r0.int_lo + k * r1.int_lo
            q_hi = r0.int_hi + k * r1.int_hi
            poison = frozenset() if k == 1 else frozenset({POISON})
            return ScaledIntRange.from_scaled_int(
                q_lo, q_hi, r0.scale, r0.bias + r1.bias,
                scale_src=r0.scale_src | r1.scale_src | poison,
                bias_src=r0.bias_src | r1.bias_src | poison)
    return ScaledIntRange(lo=lo, hi=hi)


@handler("Add")
def _prop_add(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r0, r1 = rs
    if r0.is_point and not r1.is_point:
        r0, r1 = r1, r0
        src1 = _contrib_name(graph, node, 0)
    else:
        src1 = _contrib_name(graph, node, 1)
    return _prop_add_like(node, graph, r0, r1, +1, src1)


@handler("Sub")
def _prop_sub(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r0, r1 = rs
    if r1.is_point:
        return _prop_add_like(node, graph, r0, r1, -1,
                              _contrib_name(graph, node, 1))
    lo, hi = add_intervals(r0.lo, r0.hi, -r1.hi, -r1.lo)
    return ScaledIntRange(lo=lo, hi=hi)


def _prop_mul_like(node, graph, r0, r1, invert, src1):
    c = _const_val(r1) if r1.is_point else None
    if invert and c is not None:
        c = 1.0 / c
    # scaled-int survives multiplication by a strictly positive constant
    # (paper §3.2.3; the constant need not be an integer).  Negative or
    # mixed-sign constants fall back to a plain interval.
    if c is not None and r0.is_scaled_int and np.all(c > 0):
        return ScaledIntRange.from_scaled_int(
            r0.int_lo, r0.int_hi, r0.scale * c, r0.bias * c,
            scale_src=r0.scale_src | src1,
            bias_src=(r0.bias_src | src1) if np.any(r0.bias != 0)
            else r0.bias_src)
    if c is not None:
        lo, hi = mul_intervals(r0.lo, r0.hi, c, c)
        return ScaledIntRange(lo=lo, hi=hi)
    lo, hi = mul_intervals(r0.lo, r0.hi, r1.lo, r1.hi)
    return ScaledIntRange(lo=lo, hi=hi)


@handler("Mul")
def _prop_mul(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r0, r1 = rs
    if r0.is_point and not r1.is_point:
        r0, r1 = r1, r0
        src1 = _contrib_name(graph, node, 0)
    else:
        src1 = _contrib_name(graph, node, 1)
    return _prop_mul_like(node, graph, r0, r1, False, src1)


@handler("Div")
def _prop_div(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r0, r1 = rs
    if not r1.is_point:
        raise NotImplementedError("Div by dynamic tensor not supported")
    return _prop_mul_like(node, graph, r0, r1, True,
                          _contrib_name(graph, node, 1))


# --------------------------------------------------------------------------
# MatMul / Gemm / Conv (§3.2.4)
# --------------------------------------------------------------------------

def _matmul_ranges(rw: ScaledIntRange, rx: ScaledIntRange, K: int):
    """Y = X @ W with W (K, M) constant. Returns ScaledIntRange for Y."""
    W = _const_val(rw)
    x_lo = np.broadcast_to(rx.lo, (K,)) if rx.lo.shape != (K,) else rx.lo
    x_hi = np.broadcast_to(rx.hi, (K,)) if rx.hi.shape != (K,) else rx.hi
    lo, hi = dot_interval(W, x_lo, x_hi)

    can_si = (
        rx.is_scaled_int and rw.is_scaled_int
        and _is_scalar(rx.scale)                       # per-tensor input scale
        and np.all(rw.bias == 0)                       # zero weight bias
        and (np.size(rw.scale) == 1 or
             bool(np.all(np.broadcast_to(rw.scale, W.shape) ==
                         np.broadcast_to(rw.scale, W.shape)[0])))
        # weight scale at most per-output-channel (constant down each column)
    )
    if not can_si:
        return ScaledIntRange(lo=lo, hi=hi)

    qW = rw.int_lo  # point
    qx_lo = np.broadcast_to(rx.int_lo, (K,)) if rx.int_lo.shape != (K,) \
        else rx.int_lo
    qx_hi = np.broadcast_to(rx.int_hi, (K,)) if rx.int_hi.shape != (K,) \
        else rx.int_hi
    q_lo, q_hi = dot_interval(qW, qx_lo, qx_hi)
    sW = np.broadcast_to(rw.scale, W.shape)[0]          # (M,)
    s_Y = float(rx.scale) * sW
    b_x = np.broadcast_to(rx.bias, (K,))
    b_Y = b_x @ W                                        # (M,)
    return ScaledIntRange.from_scaled_int(
        q_lo, q_hi, s_Y, b_Y,
        scale_src=rx.scale_src | rw.scale_src,
        bias_src=rx.bias_src | rw.scale_src,  # b_Y = W·b_x includes s_W
    )


@handler("MatMul")
def _prop_matmul(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    rx, rw = rs
    if rw.is_point and not rx.is_point:
        K = _const_val(rw).shape[0]
        return _matmul_ranges(rw, rx, K)
    if rx.is_point and not rw.is_point:
        # constant @ dynamic: transpose the problem
        W = _const_val(rx)            # (M, K)
        K = W.shape[-1]
        x_lo = np.broadcast_to(rw.lo, (K,)) if rw.lo.shape != (K,) else rw.lo
        x_hi = np.broadcast_to(rw.hi, (K,)) if rw.hi.shape != (K,) else rw.hi
        lo, hi = dot_interval(W.T, x_lo, x_hi)
        return ScaledIntRange(lo=lo, hi=hi)
    # dynamic x dynamic (attention): conservative hull, per-tensor
    lo0, hi0 = float(np.min(rs[0].lo)), float(np.max(rs[0].hi))
    lo1, hi1 = float(np.min(rs[1].lo)), float(np.max(rs[1].hi))
    K = int(node.attrs.get("contract_dim", 1))
    p_lo, p_hi = mul_intervals(np.asarray(lo0), np.asarray(hi0),
                               np.asarray(lo1), np.asarray(hi1))
    return ScaledIntRange(lo=K * p_lo, hi=K * p_hi)


@handler("Gemm")
def _prop_gemm(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    y = _prop_matmul(node, graph, rs[:2])
    if len(rs) == 3:
        return _prop_add_like(node, graph, y, rs[2], +1,
                              _contrib_name(graph, node, 2))
    return y


@handler("Conv")
def _prop_conv(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    rx, rw = rs[0], rs[1]
    rb = rs[2] if len(rs) > 2 else None
    W = _const_val(rw)                       # (Cout, Cin_g, kh, kw)
    cout, cin_g, kh, kw = W.shape
    groups = int(node.attrs.get("groups", 1))
    pad = int(node.attrs.get("pad", 0))
    cin = cin_g * groups
    depthwise = (groups == cin and cin_g == 1)

    def chan(a, n_ch):
        """reduce a broadcastable range array to per-channel (C,) values"""
        a = np.asarray(a, dtype=np.float64)
        if a.ndim >= 3 and a.shape[-3] == n_ch:
            return a.reshape(-1, n_ch, *a.shape[-2:]).max(axis=(0, 2, 3)) \
                if False else a.mean(axis=tuple(
                    i for i in range(a.ndim) if i != a.ndim - 3)) * 0 + \
                a.max(axis=tuple(i for i in range(a.ndim) if i != a.ndim - 3))
        return np.full((n_ch,), float(np.max(a)))

    # per-input-channel bounds (hull over spatial dims).  Zero-padding
    # feeds literal zeros into border taps, so padded convs must widen the
    # input interval to include 0 — otherwise a channel whose range sits
    # strictly above (or below) zero gets an unsound output bound.
    x_lo_c = -chan(-rx.lo, cin)
    x_hi_c = chan(rx.hi, cin)
    if pad:
        x_lo_c = np.minimum(x_lo_c, 0.0)
        x_hi_c = np.maximum(x_hi_c, 0.0)

    Wmat = W.reshape(cout, cin_g * kh * kw)
    if depthwise:
        wv = W.reshape(cout, kh * kw)
        y_c = ((x_hi_c + x_lo_c) * 0.5)[:, None] * wv
        y_r = ((x_hi_c - x_lo_c) * 0.5)[:, None] * np.abs(wv)
        lo = (y_c - y_r).sum(-1).reshape(cout, 1, 1)
        hi = (y_c + y_r).sum(-1).reshape(cout, 1, 1)
    else:
        outs_lo, outs_hi = [], []
        for g in range(groups):
            xg_lo = np.repeat(x_lo_c[g * cin_g:(g + 1) * cin_g], kh * kw)
            xg_hi = np.repeat(x_hi_c[g * cin_g:(g + 1) * cin_g], kh * kw)
            Wg = Wmat[g * (cout // groups):(g + 1) * (cout // groups)]
            l, h = dot_interval(Wg.T, xg_lo, xg_hi)
            outs_lo.append(l)
            outs_hi.append(h)
        lo = np.concatenate(outs_lo).reshape(cout, 1, 1)
        hi = np.concatenate(outs_hi).reshape(cout, 1, 1)

    # scaled-int propagation conditions (§3.2.4)
    sx_scalar = _is_scalar(rx.scale)
    sx_chan = (rx.is_scaled_int and rx.scale is not None and
               np.size(rx.scale) == cin)
    sw_ok = rw.is_scaled_int and np.all(rw.bias == 0)
    # padded zeros map to integer 0 only when the input bias is zero
    # (x = s*q + b, pad value x=0 ⇒ q=0 iff b=0)
    pad_ok = (pad == 0) or bool(np.all(np.asarray(rx.bias) == 0))
    can_si = rx.is_scaled_int and sw_ok and pad_ok and (
        sx_scalar or (depthwise and sx_chan))
    out = None
    if can_si:
        qW = rw.int_lo
        qx_lo_c = -chan(-rx.int_lo, cin)
        qx_hi_c = chan(rx.int_hi, cin)
        if pad:
            qx_lo_c = np.minimum(qx_lo_c, 0.0)
            qx_hi_c = np.maximum(qx_hi_c, 0.0)
        sW = np.broadcast_to(rw.scale, W.shape).reshape(cout, -1)[:, 0]
        if depthwise:
            wv = qW.reshape(cout, kh * kw)
            y_c = ((qx_hi_c + qx_lo_c) * 0.5)[:, None] * wv
            y_r = ((qx_hi_c - qx_lo_c) * 0.5)[:, None] * np.abs(wv)
            q_lo = (y_c - y_r).sum(-1).reshape(cout, 1, 1)
            q_hi = (y_c + y_r).sum(-1).reshape(cout, 1, 1)
            sx = np.broadcast_to(
                np.asarray(rx.scale).reshape(-1, 1, 1) if sx_chan
                else rx.scale, (cin, 1, 1)).reshape(cin)
            s_Y = (sx * sW).reshape(cout, 1, 1)
        else:
            ql, qh = [], []
            qWmat = qW.reshape(cout, cin_g * kh * kw)
            for g in range(groups):
                xg_lo = np.repeat(qx_lo_c[g * cin_g:(g + 1) * cin_g], kh * kw)
                xg_hi = np.repeat(qx_hi_c[g * cin_g:(g + 1) * cin_g], kh * kw)
                Wg = qWmat[g * (cout // groups):(g + 1) * (cout // groups)]
                l, h = dot_interval(Wg.T, xg_lo, xg_hi)
                ql.append(l)
                qh.append(h)
            q_lo = np.concatenate(ql).reshape(cout, 1, 1)
            q_hi = np.concatenate(qh).reshape(cout, 1, 1)
            s_Y = (float(rx.scale) * sW).reshape(cout, 1, 1)
        b_x_c = np.broadcast_to(rx.bias, (cin,)) if np.size(rx.bias) <= cin \
            else chan(rx.bias, cin)
        b_Y = (Wmat * np.repeat(b_x_c.reshape(groups, cin_g), kh * kw
                                ).reshape(groups, -1).repeat(
            cout // groups, axis=0).reshape(cout, -1)).sum(-1) \
            if groups > 1 else (Wmat @ np.repeat(b_x_c, kh * kw))
        b_Y = np.asarray(b_Y).reshape(cout, 1, 1)
        out = ScaledIntRange.from_scaled_int(
            q_lo, q_hi, s_Y, b_Y,
            scale_src=rx.scale_src | rw.scale_src,
            bias_src=rx.bias_src | rw.scale_src)
    if out is None:
        out = ScaledIntRange(lo=lo, hi=hi)
    if rb is not None:
        out = _prop_add_like(node, graph, out,
                             ScaledIntRange.point(
                                 _const_val(rb).reshape(cout, 1, 1)),
                             +1, _contrib_name(graph, node, 2))
    return out


# --------------------------------------------------------------------------
# elementwise monotonic / unimodal / value-preserving (§2.4.1)
# --------------------------------------------------------------------------

def _mono(fn):
    def prop(node, graph, rs):
        lo, hi = monotonic_fn_interval(fn, rs[0].lo, rs[0].hi)
        return ScaledIntRange(lo=lo, hi=hi)
    return prop


PROP_REGISTRY["Sigmoid"] = _mono(lambda x: 1.0 / (1.0 + np.exp(-x)))
PROP_REGISTRY["Tanh"] = _mono(np.tanh)
PROP_REGISTRY["Floor"] = _mono(np.floor)
PROP_REGISTRY["Round"] = _mono(round_half_to_even)


@handler("Softcap")
def _prop_softcap(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    cap = float(node.attrs["cap"])
    lo, hi = monotonic_fn_interval(lambda x: cap * np.tanh(x / cap),
                                   rs[0].lo, rs[0].hi)
    return ScaledIntRange(lo=lo, hi=hi)


@handler("Relu")
def _prop_relu(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    return ScaledIntRange(lo=np.maximum(rs[0].lo, 0.0),
                          hi=np.maximum(rs[0].hi, 0.0))


def _unimodal(fn, x_star: float):
    """Elementwise function decreasing before x_star, increasing after."""
    def prop(node, graph, rs):
        lo, hi = rs[0].lo, rs[0].hi
        f_lo, f_hi = fn(lo), fn(hi)
        out_hi = np.maximum(f_lo, f_hi)
        out_lo = np.minimum(f_lo, f_hi)
        inside = (lo <= x_star) & (x_star <= hi)
        out_lo = np.where(inside, fn(np.asarray(x_star)), out_lo)
        return ScaledIntRange(lo=out_lo, hi=out_hi)
    return prop


def _gelu(x):
    from scipy.special import erf
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def _hardswish(x):
    return x * np.clip(x + 3.0, 0.0, 6.0) / 6.0


PROP_REGISTRY["Silu"] = _unimodal(lambda x: x / (1.0 + np.exp(-x)),
                                  -1.2784645)
PROP_REGISTRY["Gelu"] = _unimodal(_gelu, -0.75179)
PROP_REGISTRY["HardSwish"] = _unimodal(_hardswish, -1.5)
PROP_REGISTRY["Abs"] = _unimodal(np.abs, 0.0)


@handler("Clip")
def _prop_clip(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    lo_c = _const_val(rs[1]) if len(rs) > 1 else -np.inf
    hi_c = _const_val(rs[2]) if len(rs) > 2 else np.inf
    return ScaledIntRange(lo=np.clip(rs[0].lo, lo_c, hi_c),
                          hi=np.clip(rs[0].hi, lo_c, hi_c))


def _value_preserving(node, graph, rs):
    """Ops whose outputs are a subset/permutation of input values — range
    and scaled-int structure survive.  Per-tensor (scalar) scale/bias pass
    through exactly; per-channel structure is reduced to its hull because
    the channel axis may move."""
    r = rs[0]
    if r.is_scaled_int and _is_scalar(r.scale) and _is_scalar(r.bias):
        return ScaledIntRange.from_scaled_int(
            np.min(r.int_lo), np.max(r.int_hi), r.scale, r.bias,
            scale_src=r.scale_src, bias_src=r.bias_src)
    return ScaledIntRange(lo=np.min(r.lo), hi=np.max(r.hi))


for op in ["Identity", "Reshape", "Transpose", "Flatten", "Pad"]:
    PROP_REGISTRY[op] = _value_preserving


@handler("MaxPool")
def _prop_maxpool(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    return rs[0]  # value-preserving per channel


@handler("AveragePool")
def _prop_avgpool(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r = rs[0]
    k = int(node.attrs.get("kernel", 2))
    n = k * k
    if r.is_scaled_int:
        return ScaledIntRange.from_scaled_int(
            r.int_lo * n, r.int_hi * n, r.scale / n, r.bias,
            scale_src=r.scale_src | frozenset({POISON}),
            bias_src=r.bias_src)
    return ScaledIntRange(lo=r.lo, hi=r.hi)


@handler("GlobalAveragePool")
def _prop_gap(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    r = rs[0]
    n = int(node.attrs.get("window", 1))
    if r.is_scaled_int and n > 1:
        return ScaledIntRange.from_scaled_int(
            r.int_lo * n, r.int_hi * n, r.scale / n, r.bias,
            scale_src=r.scale_src | frozenset({POISON}),
            bias_src=r.bias_src)
    return r


@handler("Concat")
def _prop_concat(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    lo = np.min([np.min(r.lo) for r in rs])
    hi = np.max([np.max(r.hi) for r in rs])
    all_si = all(r.is_scaled_int and _is_scalar(r.scale) and
                 _is_scalar(r.bias) for r in rs)
    if all_si:
        s0, b0 = float(rs[0].scale), float(rs[0].bias)
        if all(abs(float(r.scale) - s0) < 1e-12 and
               abs(float(r.bias) - b0) < 1e-12 for r in rs):
            return ScaledIntRange.from_scaled_int(
                np.min([np.min(r.int_lo) for r in rs]),
                np.max([np.max(r.int_hi) for r in rs]), s0, b0,
                scale_src=frozenset().union(*[r.scale_src for r in rs]),
                bias_src=frozenset().union(*[r.bias_src for r in rs]))
    return ScaledIntRange(lo=lo, hi=hi)


@handler("Gather")
def _prop_gather(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    table = rs[0]
    if table.is_point:
        v = _const_val(table)
        if table.is_scaled_int and _is_scalar(table.scale) and \
                _is_scalar(table.bias):
            q = table.int_lo
            return ScaledIntRange.from_scaled_int(
                np.min(q), np.max(q), table.scale, table.bias,
                scale_src=table.scale_src, bias_src=table.bias_src)
        return ScaledIntRange(lo=np.min(v), hi=np.max(v))
    return ScaledIntRange(lo=np.min(table.lo), hi=np.max(table.hi))


@handler("Softmax")
def _prop_softmax(node: Node, graph: Graph, rs: List[ScaledIntRange]):
    return ScaledIntRange(lo=np.zeros(()), hi=np.ones(()))
