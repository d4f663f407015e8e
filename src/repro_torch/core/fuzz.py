"""Soundness fuzzing: differential testing of the two abstract domains.

For a graph under test the harness checks, on sampled concrete
executions, the two properties the analyses promise:

  * **soundness** — every observed tensor value lies inside the proven
    range, for the interval domain *and* for the affine reduced product;
  * **domain order** — the affine result is contained in the interval
    result for every tensor (the reduced product guarantees this
    structurally; the fuzzer re-checks it empirically so a regression in
    the intersection logic cannot hide).

Inputs come from three sources: randomly generated small graphs
(:func:`random_graph` — elementwise chains, constant matmuls, residual
forks, thresholds), the four paper QNN workloads as-imported, and the
same workloads after the full streamlining flow.  ``run_fuzz`` drives
all of them and returns a :class:`FuzzReport`; ``tests/test_torch_affine.py``
gates on zero violations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph
from .intervals import ScaledIntRange
from .propagate import analyze

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FuzzViolation:
    graph: str
    tensor: str
    kind: str         # "interval" | "affine" | "domain-order"
    detail: str

    def __str__(self) -> str:
        return f"{self.graph}/{self.tensor} [{self.kind}]: {self.detail}"


@dataclasses.dataclass
class FuzzReport:
    graphs: int = 0
    tensors_checked: int = 0
    samples: int = 0
    violations: List[FuzzViolation] = dataclasses.field(
        default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def merge(self, other: "FuzzReport") -> None:
        self.graphs += other.graphs
        self.tensors_checked += other.tensors_checked
        self.samples += other.samples
        self.violations.extend(other.violations)

    def summary(self) -> str:
        return (f"{self.graphs} graphs, {self.tensors_checked} tensor "
                f"checks over {self.samples} samples, "
                f"{len(self.violations)} violations")


# --------------------------------------------------------------------------
# random graph generation
# --------------------------------------------------------------------------

def random_graph(rng: np.random.Generator, n_nodes: int = 6,
                 dim: int = 4) -> Tuple[Graph, Dict[str, ScaledIntRange],
                                        Shape]:
    """A random well-formed graph over (dim,)-shaped tensors.

    Draws from elementwise arithmetic (constant and dynamic operands),
    ReLU, constant-weight MatMul, MultiThreshold and residual forks —
    the op mix SIRA's transfer functions disagree on most.  Returns
    ``(graph, input_ranges, input_shape)``.
    """
    g = Graph(inputs=["x"], outputs=[])
    lo = float(rng.uniform(-4.0, 0.0))
    hi = lo + float(rng.uniform(0.5, 6.0))
    input_ranges = {"x": ScaledIntRange(lo=np.asarray(lo),
                                        hi=np.asarray(hi))}
    # live: tensors usable as dynamic operands, with their current width
    live: List[Tuple[str, int]] = [("x", dim)]

    def pick() -> Tuple[str, int]:
        return live[int(rng.integers(len(live)))]

    for i in range(n_nodes):
        op = str(rng.choice(
            ["Add", "Sub", "Mul", "Div", "Relu", "MatMul",
             "AddDyn", "SubDyn", "MultiThreshold"]))
        t, d = pick()
        out = f"t{i}"
        if op in ("Add", "Sub", "Mul", "Div"):
            c = rng.uniform(-2.0, 2.0, size=(d,))
            if op == "Div":
                c = np.sign(c) * np.maximum(np.abs(c), 0.25)
            cname = g.add_initializer(c, name=f"c{i}")
            g.add_node(op, [t, cname], [out])
        elif op in ("AddDyn", "SubDyn"):
            t2, d2 = pick()
            if d2 != d:
                continue
            g.add_node(op[:3], [t, t2], [out])
        elif op == "Relu":
            g.add_node("Relu", [t], [out])
        elif op == "MatMul":
            m = int(rng.integers(2, 6))
            W = rng.uniform(-1.5, 1.5, size=(d, m))
            wname = g.add_initializer(W, name=f"w{i}")
            g.add_node("MatMul", [t, wname], [out])
            d = m
        else:  # MultiThreshold
            n_thr = int(rng.integers(2, 6))
            thr = np.sort(rng.uniform(-6.0, 6.0, size=(d, n_thr)), axis=1)
            tname = g.add_initializer(thr, name=f"thr{i}")
            g.add_node("MultiThreshold", [t, tname], [out],
                       attrs=dict(axis=-1, out_scale=1.0, out_bias=0.0))
        live.append((out, d))
    g.outputs = [live[-1][0]]
    return g, input_ranges, (dim,)


# --------------------------------------------------------------------------
# differential containment check
# --------------------------------------------------------------------------

def _hull(a) -> Tuple[float, float]:
    return float(np.min(a)), float(np.max(a))


def _contained(r: ScaledIntRange, val: np.ndarray, atol: float) -> bool:
    """Elementwise containment when the bound arrays match the value
    shape exactly (or are scalar); global-hull containment otherwise —
    range arrays use *broadcastable* layouts ((C,) / (C,1,1)) that do
    not always align with the concrete value shape (same convention as
    :func:`repro_torch.core.verify.verify_ranges`)."""
    lo, hi = np.asarray(r.lo), np.asarray(r.hi)
    if lo.shape == val.shape or lo.size == 1:
        return bool(np.all(val >= lo - atol) and
                    np.all(val <= hi + atol))
    return (float(np.min(val)) >= float(np.min(lo)) - atol and
            float(np.max(val)) <= float(np.max(hi)) + atol)


def check_containment(graph: Graph,
                      input_ranges: Dict[str, ScaledIntRange],
                      input_shape: Shape,
                      n_samples: int = 8,
                      rng: Optional[np.random.Generator] = None,
                      atol: float = 1e-6,
                      name: str = "graph") -> FuzzReport:
    """Differentially test both domains on one graph."""
    rng = np.random.default_rng(0) if rng is None else rng
    rep = FuzzReport(graphs=1)
    r_int = analyze(graph, input_ranges, domain="interval")
    r_aff = analyze(graph, input_ranges, domain="affine")

    # domain order: affine hull inside interval hull, every tensor
    for tensor, ri in r_int.items():
        ra = r_aff.get(tensor)
        if ra is None:
            continue
        rep.tensors_checked += 1
        (il, ih), (al, ah) = _hull_pair(ri), _hull_pair(ra)
        if al < il - atol or ah > ih + atol:
            rep.violations.append(FuzzViolation(
                name, tensor, "domain-order",
                f"affine [{al:.6g}, {ah:.6g}] not inside "
                f"interval [{il:.6g}, {ih:.6g}]"))

    # sampled executions inside both proven bounds
    (inp,) = graph.inputs
    r_in = input_ranges[inp]
    lo = np.broadcast_to(np.asarray(r_in.lo, np.float64), input_shape)
    hi = np.broadcast_to(np.asarray(r_in.hi, np.float64), input_shape)
    for _ in range(n_samples):
        rep.samples += 1
        feeds = {inp: rng.uniform(lo, hi, size=input_shape)}
        env = graph.execute(feeds, record_all=True)
        for tensor, val in env.items():
            if graph.is_constant(tensor):
                continue
            for kind, ranges in (("interval", r_int), ("affine", r_aff)):
                r = ranges.get(tensor)
                if r is None:
                    continue
                rep.tensors_checked += 1
                if not _contained(r, val, atol):
                    v_lo, v_hi = _hull(val)
                    b_lo, b_hi = _hull_pair(r)
                    rep.violations.append(FuzzViolation(
                        name, tensor, kind,
                        f"observed [{v_lo:.6g}, {v_hi:.6g}] escapes "
                        f"proven [{b_lo:.6g}, {b_hi:.6g}]"))
    return rep


def _hull_pair(r: ScaledIntRange) -> Tuple[float, float]:
    return float(np.min(r.lo)), float(np.max(r.hi))


# --------------------------------------------------------------------------
# differential tail-conversion fuzzing
# --------------------------------------------------------------------------

_TAIL_ACTS = ["Silu", "Gelu", "Relu", "Tanh", "Sigmoid", "HardSwish",
              "Abs"]


def random_tail_graph(rng: np.random.Generator
                      ) -> Tuple[Graph, Dict[str, ScaledIntRange], int]:
    """A random elementwise chain (incl. Silu/Gelu/Clip, negative and
    per-channel scales) terminated in a Quant — the exact shape
    threshold conversion consumes.  Returns ``(graph, input_ranges, C)``
    with an integer (scale-1, bias-0) input range."""
    C = int(rng.integers(1, 5))
    lo = int(rng.integers(-200, 1))
    hi = lo + int(rng.integers(32, 320))
    g = Graph(inputs=["x"], outputs=["y"])
    cur = "x"
    idx = 0

    def emit(op: str, const: Optional[np.ndarray] = None,
             extra: Optional[List[str]] = None) -> None:
        nonlocal cur, idx
        ins = [cur]
        if const is not None:
            ins.append(g.add_initializer(np.asarray(const, np.float64),
                                         name=f"c{idx}"))
        ins.extend(extra or [])
        out = f"t{idx}"
        idx += 1
        g.add_node(op, ins, [out])
        cur = out

    # scale the integer range into activation-relevant territory;
    # sometimes negative (direction reversal), sometimes per-channel
    s0 = rng.uniform(0.01, 0.08, size=(C,)) * np.where(
        rng.random(C) < 0.25, -1.0, 1.0)
    if rng.random() < 0.5:
        s0 = np.full(C, s0[0])
    emit("Mul", s0)
    for _ in range(int(rng.integers(0, 3))):
        op = str(rng.choice(["Add", "Sub", "Mul", "Div", "Clip"]
                            + _TAIL_ACTS))
        if op in ("Add", "Sub"):
            emit(op, rng.uniform(-2.0, 2.0, size=(C,)))
        elif op == "Mul":
            emit(op, rng.uniform(-1.5, 1.5, size=(C,)))
        elif op == "Div":
            c = rng.uniform(-2.0, 2.0, size=(C,))
            emit(op, np.sign(c) * np.maximum(np.abs(c), 0.5))
        elif op == "Clip":
            a = float(rng.uniform(-2.0, 0.0))
            b = a + float(rng.uniform(0.5, 3.0))
            nlo = g.add_initializer(np.asarray(a), name=f"cl{idx}")
            nhi = g.add_initializer(np.asarray(b), name=f"ch{idx}")
            emit("Clip", None, [nlo, nhi])
        else:
            emit(op)
    if rng.random() < 0.7:
        emit(str(rng.choice(_TAIL_ACTS)))
    bits = int(rng.integers(2, 6))
    signed = int(rng.random() < 0.7)
    for nm, v in (("qs", float(rng.uniform(0.05, 0.5))),
                  ("qz", 0.0), ("qb", float(bits))):
        g.initializers[nm] = np.asarray(v, np.float64)
    g.add_node("Quant", [cur, "qs", "qz", "qb"], ["y"],
               attrs=dict(signed=signed, narrow=0))
    input_ranges = {"x": ScaledIntRange.from_scaled_int(
        np.full(C, float(lo)), np.full(C, float(hi)), 1.0, 0.0)}
    return g, input_ranges, C


def check_tail_exactness(
        g: Graph, ranges: Dict[str, ScaledIntRange],
        method: str = "auto", name: str = "graph",
        certifier: Optional[Callable] = None,
        max_exhaustive: int = 1 << 16) -> FuzzReport:
    """Differential oracle for threshold conversion (Eq. 3 exactness).

    For every layer tail that converts, re-evaluates the *original* tail
    subgraph over the proven integer grid (exhaustively up to
    ``max_exhaustive`` points, endpoint-anchored sampling beyond) and
    compares against the emitted MultiThreshold function.  The oracle
    never consults the certificate for the comparison itself, so a lying
    certifier (``certifier=...`` seeds one) that tricks the extractor
    into bad thresholds is caught here."""
    from . import monotone as _monotone
    from .thresholds import (ThresholdConversionError, _entry_int_bounds,
                             extract_thresholds, find_layer_tails,
                             tail_evaluator)
    rep = FuzzReport(graphs=1)
    for tail in find_layer_tails(g, ranges):
        cert = (certifier or _monotone.certify_tail)(g, tail, ranges)
        try:
            spec = extract_thresholds(g, tail, ranges, method=method,
                                      certificate=cert)
        except ThresholdConversionError:
            continue    # left as an elementwise chain — safe
        except ValueError:
            continue
        ev = tail_evaluator(g, tail, ranges)
        r_in = ranges[tail.input_tensor]
        lo_c, hi_c = _entry_int_bounds(r_in, ev.C)
        lo, hi = int(lo_c.min()), int(hi_c.max())
        if hi - lo + 1 <= max_exhaustive:
            xs = np.arange(lo, hi + 1, dtype=np.int64)
        else:
            xs = np.unique(np.concatenate(
                [np.array([lo, hi], np.int64),
                 np.linspace(lo, hi, 4097).astype(np.int64)]))
        ob = np.asarray(spec.out_bias, np.float64)
        osc = np.asarray(spec.out_scale, np.float64)
        rep.tensors_checked += 1
        for start in range(0, xs.size, 8192):
            blk = xs[start:start + 8192]
            rep.samples += blk.size
            ref = ev.s_q * (ev.f_int(blk) - ev.z_q)         # (R, C)
            # entry-tensor values the MultiThreshold actually compares
            x_real = (blk[:, None].astype(np.float64) * ev.in_scale
                      + ev.in_bias)                         # (R, C)
            cnt = (x_real[:, :, None]
                   >= spec.thresholds[None]).sum(axis=-1)   # (R, C)
            out = ob + osc * cnt
            # the contract only covers each channel's own proven range
            ok = (np.isclose(out, ref, rtol=1e-9, atol=1e-9)
                  | (blk[:, None] < lo_c) | (blk[:, None] > hi_c))
            if not ok.all():
                bad = np.argwhere(~ok)
                i, c = int(bad[0][0]), int(bad[0][1])
                rep.violations.append(FuzzViolation(
                    name, tail.quant_node.outputs[0], "tail-exact",
                    f"x={int(blk[i])} ch={c}: thresholds give "
                    f"{out[i, c]:.6g}, tail gives {ref[i, c]:.6g} "
                    f"(certificate {cert.summary})"))
                break
    return rep


def run_tail_fuzz(n_random: int = 40, seed: int = 0,
                  method: str = "auto",
                  certifier: Optional[Callable] = None) -> FuzzReport:
    """Fuzz threshold conversion on random quantized tails: per-tail
    differential exactness (:func:`check_tail_exactness`) plus a
    whole-graph check that the converted graph matches the original over
    the full integer grid."""
    from .thresholds import convert_tails
    rng = np.random.default_rng(seed)
    total = FuzzReport()
    for i in range(n_random):
        g, in_ranges, C = random_tail_graph(rng)
        ranges = analyze(g, in_ranges)
        name = f"tail{i}"
        total.merge(check_tail_exactness(g, ranges, method=method,
                                         name=name, certifier=certifier))
        # whole-graph differential: conversion must preserve execution
        g2 = g.copy()
        specs, _reports = convert_tails(g2, analyze(g2, in_ranges),
                                        method=method)
        if not specs:
            continue
        r_in = in_ranges["x"]
        lo = int(np.floor(np.min(r_in.int_lo)))
        hi = int(np.ceil(np.max(r_in.int_hi)))
        xs = np.arange(lo, hi + 1, dtype=np.float64)
        X = np.ascontiguousarray(
            np.broadcast_to(xs[:, None], (xs.size, C)))
        y0 = g.execute({"x": X})["y"]
        y1 = g2.execute({"x": X})["y"]
        total.samples += xs.size
        total.tensors_checked += 1
        if not np.allclose(y0, y1, rtol=1e-9, atol=1e-9):
            bad = np.argwhere(~np.isclose(y0, y1, rtol=1e-9, atol=1e-9))
            i0, c0 = int(bad[0][0]), int(bad[0][1])
            total.violations.append(FuzzViolation(
                name, "y", "tail-exact",
                f"converted graph diverges at x={xs[i0]:.0f} ch={c0}: "
                f"{y1[i0, c0]:.6g} != {y0[i0, c0]:.6g}"))
    return total


# --------------------------------------------------------------------------
# the suite
# --------------------------------------------------------------------------

def run_fuzz(n_random: int = 20, n_samples: int = 8, seed: int = 0,
             workloads: bool = True,
             optimized: bool = True) -> FuzzReport:
    """Fuzz random graphs and (optionally) the four paper workloads, raw
    and after the full streamlining flow."""
    rng = np.random.default_rng(seed)
    total = FuzzReport()
    for i in range(n_random):
        g, in_ranges, shape = random_graph(
            rng, n_nodes=int(rng.integers(3, 10)))
        total.merge(check_containment(
            g, in_ranges, shape, n_samples=n_samples, rng=rng,
            name=f"random{i}"))
    if workloads:
        from .workloads import WORKLOADS
        for wname, factory in WORKLOADS.items():
            wl = factory()
            total.merge(check_containment(
                wl.graph, wl.input_range, wl.input_shape,
                n_samples=max(2, n_samples // 4), rng=rng, name=wname))
            if optimized:
                from .flow import build_flow
                res = build_flow(wl)
                total.merge(check_containment(
                    res.graph, res.model.input_ranges, wl.input_shape,
                    n_samples=max(2, n_samples // 4), rng=rng,
                    name=f"{wname}+flow"))
    return total
