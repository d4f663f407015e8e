"""Accumulator minimization with SIRA (paper §4.2).

Two bounds for the accumulator width of an integer MatMul/Conv:

  * **Datatype bound** (Colbert et al., reproduced): for a K-dim dot product
    of N-bit unsigned inputs with M-bit signed weights,

        P = ceil(alpha + phi(alpha) + 1),
        alpha = log2(K) + N + M - 1,  phi(a) = log2(1 + 2^-a)

  * **SIRA bound**: from the interval-arithmetic output range [z_lo, z_hi]
    of the integer kernel,

        P = ceil(log2(max(|z_lo|, |z_hi| + 1))) + 1

The SIRA bound exploits the *actual trained weights* and is provably
lossless; on the paper's workloads it is on average 22% below the datatype
bound (validated in benchmarks/f22_accumulators.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .graph import Graph
from .intervals import InvalidRangeError, ScaledIntRange
from .propagate import analyze


def datatype_bound_bits(K: int, input_bits: int, weight_bits: int,
                        input_signed: bool = False) -> int:
    """Colbert et al. datatype-bound accumulator width (paper §4.2).

    ``input_bits``-bit (default unsigned) inputs, ``weight_bits``-bit signed
    weights, K-element dot product.  Signed inputs spend one bit on the
    sign, so only ``input_bits - 1`` magnitude bits enter alpha."""
    N = input_bits if not input_signed else input_bits - 1
    alpha = np.log2(K) + N + weight_bits - 1
    phi = np.log2(1.0 + 2.0 ** (-alpha))
    return int(np.ceil(alpha + phi + 1))


def exact_worst_case_bits(K: int, x_lo: int, x_hi: int,
                          w_lo: int, w_hi: int) -> int:
    """Exact worst-case accumulator width from integer operand ranges
    (independent of trained values, tighter than the log-sum formula for
    asymmetric ranges)."""
    prods = [x_lo * w_lo, x_lo * w_hi, x_hi * w_lo, x_hi * w_hi]
    z_lo, z_hi = K * min(prods), K * max(prods)
    m = max(abs(z_lo), abs(z_hi) + 1)
    return int(np.ceil(np.log2(max(m, 2)))) + 1


def channel_worst_case_bits(q: np.ndarray, x_lo: int, x_hi: int
                            ) -> np.ndarray:
    """Per-output-channel refinement of :func:`exact_worst_case_bits` for
    *known* integer weights ``q`` of shape (K, M): the worst-case signed
    accumulator width of each of the M dot products when every input
    element independently takes any value in ``[x_lo, x_hi]``.

    This is the oracle the accumulator-aware QAT projection
    (``repro_torch.qat.constraints``) is validated against: for any channel,
    ``channel_worst_case_bits(q)[j] <= exact_worst_case_bits(K, x_lo,
    x_hi, q.min(), q.max())`` (the scalar bound forgets which channel a
    weight belongs to), and both use the §4.2 bit formula."""
    q = np.asarray(q, dtype=np.float64)
    z_hi = np.maximum(q * x_lo, q * x_hi).sum(axis=0)
    z_lo = np.minimum(q * x_lo, q * x_hi).sum(axis=0)
    m = np.maximum(np.abs(z_lo), np.abs(z_hi) + 1.0)
    return (np.ceil(np.log2(np.maximum(m, 2.0))) + 1).astype(np.int64)


def sira_bits(r: ScaledIntRange) -> int:
    return r.required_signed_bits()


@dataclasses.dataclass
class AccumulatorReport:
    node_name: str
    op_type: str
    K: int
    sira_bits: int
    datatype_bits: int
    baseline_bits: int = 32

    @property
    def reduction_vs_datatype(self) -> float:
        return 1.0 - self.sira_bits / self.datatype_bits

    @property
    def reduction_vs_baseline(self) -> float:
        return 1.0 - self.sira_bits / self.baseline_bits


def _weight_value(g: Graph, tensor: str) -> Optional[np.ndarray]:
    """Resolve a weight tensor to its constant value, looking through a
    residual Mul(q_W, s) if the region was not fully aggregated."""
    if g.is_constant(tensor):
        return g.initializers[tensor]
    prod = g.producer(tensor)
    if prod is not None and prod.op_type == "Mul" and \
            all(g.is_constant(t) for t in prod.inputs):
        return g.initializers[prod.inputs[0]] * g.initializers[prod.inputs[1]]
    return None


def _dot_length(g: Graph, node) -> int:
    if node.op_type in ("MatMul", "Gemm"):
        for t in node.inputs[:2]:
            w = _weight_value(g, t)
            if w is not None:
                return int(w.shape[0])
        return 0
    if node.op_type == "Conv":
        w = _weight_value(g, node.inputs[1])
        if w is None:
            return 0
        cout, cin_g, kh, kw = w.shape
        return int(cin_g * kh * kw)
    return 0


def minimize_accumulators(g: Graph,
                          input_ranges: Dict[str, ScaledIntRange],
                          input_bits: int = 8,
                          weight_bits: int = 8,
                          ranges: Optional[Dict[str, ScaledIntRange]] = None
                          ) -> List[AccumulatorReport]:
    """Analyze every integer MatMul/Conv in a (streamlined) graph and report
    SIRA vs datatype-bound accumulator widths."""
    if ranges is None:
        ranges = analyze(g, input_ranges)
    reports: List[AccumulatorReport] = []
    for node in g.nodes:
        if node.op_type not in ("MatMul", "Gemm", "Conv"):
            continue
        r_out = ranges.get(node.outputs[0])
        if r_out is None or not r_out.is_scaled_int:
            continue
        # integer kernel requires *pure integer* inputs (scale 1, bias 0)
        rs_in = [ranges.get(t) for t in node.inputs[:2]]
        if any(x is None or not x.is_scaled_int or
               not (np.all(x.scale == 1.0) and np.all(x.bias == 0.0))
               for x in rs_in):
            continue
        K = _dot_length(g, node)
        if K == 0:
            continue
        # per-input bitwidths: from the actual integer ranges if available
        def _bits(r, signed_default):
            try:
                if np.min(r.int_lo) >= 0:
                    return r.required_unsigned_bits(), False
                return r.required_signed_bits(), True
            except InvalidRangeError:
                return (input_bits, signed_default)
        dyn = rs_in[0] if not rs_in[0].is_point else rs_in[1]
        wgt = rs_in[1] if not rs_in[1].is_point else rs_in[0]
        n_bits, n_signed = _bits(dyn, False)
        m_bits, _ = _bits(wgt, True)
        reports.append(AccumulatorReport(
            node_name=node.name, op_type=node.op_type, K=K,
            sira_bits=sira_bits(r_out),
            datatype_bits=datatype_bound_bits(K, n_bits, m_bits,
                                              input_signed=n_signed)))
    return reports


def summarize(reports: List[AccumulatorReport]) -> Dict[str, float]:
    if not reports:
        return dict(mean_sira=0.0, mean_datatype=0.0,
                    reduction_vs_datatype=0.0, reduction_vs_32b=0.0)
    mu_s = float(np.mean([r.sira_bits for r in reports]))
    mu_d = float(np.mean([r.datatype_bits for r in reports]))
    return dict(mean_sira=mu_s, mean_datatype=mu_d,
                reduction_vs_datatype=1.0 - mu_s / mu_d,
                reduction_vs_32b=1.0 - mu_s / 32.0)


def accumulator_dtype(bits: int):
    """Map an exact SIRA bitwidth to the accumulation dtype the integer
    matmul kernel emulates (``kernels/int_matmul.py``)."""
    import torch
    if bits <= 15:
        return torch.int16
    if bits <= 31:
        return torch.int32
    return torch.int64
