"""Trained QAT checkpoint -> ``SiraModel`` graph -> proven accumulator
bits -> DSE deltas: the back half of the train -> SIRA -> DSE chain.

The exported graph mirrors the ``core.workloads`` QNN conventions
(input Quant, per-layer weight Quant -> MatMul -> Add bias -> Relu ->
unsigned activation Quant, raw final gemm) so the default ``build_flow``
streamlines it to pure-integer MatMuls that ``minimize_accumulators``
prices.  Weights are exported **snapped**: ``W_snap = s * toz(W / s)``,
so the graph's round-half-to-even Quant executor lands on exactly the
round-toward-zero integers training constrained — the A2Q guarantee
(SIRA-proven bits <= trained budget) then holds by construction and is
asserted, not hoped for.

Counterpart of ``src/repro/qat/export.py`` on the port's own ``core``
graph, ``build_flow`` and ``SiraModel``; params (tensors on any device)
go to float64 numpy before they are snapped, so the exported graph is
the same whatever device trained them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.accumulator import AccumulatorReport
from ..core.flow import BuildResult, build_flow
from ..core.graph import Graph
from ..core.intervals import ScaledIntRange
from ..core.model import SiraModel
from .constraints import _f64, quantize_weights
from .model import QATMLP


def _quant(g: Graph, x: str, scale, bits: int, signed: int,
           out: str) -> str:
    s = g.add_initializer(scale)
    z = g.add_initializer(0.0)
    b = g.add_initializer(float(bits))
    g.add_node("Quant", [x, s, z, b], [out], dict(signed=signed, narrow=0))
    return out


def export_qat_model(model: QATMLP, params,
                     name: str = "qat-mlp") -> SiraModel:
    """Build the inference graph of a trained :class:`QATMLP` with
    snapped integer-exact weights and the training-time frozen scales."""
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", model.input_scale, model.input_bits, 0, "Xq")
    n = len(model.layer_dims)
    for i, layer in enumerate(params["layers"]):
        W = _f64(layer["W"])
        s_w = np.asarray(model.w_scales[i], np.float64)
        q = quantize_weights(W, s_w, model.weight_bits)
        w_name = g.add_initializer(q * s_w[None, :], f"l{i}_W")
        wq = _quant(g, w_name, s_w, model.weight_bits, 1, f"l{i}_Wq")
        g.add_node("MatMul", [x, wq], [f"l{i}_mm"], name=f"l{i}_matmul")
        b_name = g.add_initializer(_f64(layer["b"]), f"l{i}_B")
        g.add_node("Add", [f"l{i}_mm", b_name], [f"l{i}_gemm"])
        x = f"l{i}_gemm"
        if i < n - 1:
            g.add_node("Relu", [x], [f"l{i}_act"])
            x = _quant(g, f"l{i}_act", model.a_scales[i], model.act_bits,
                       0, f"l{i}_out")
    g.outputs = [x]
    budgets = model.budgets()
    return SiraModel(
        g, {"X": ScaledIntRange(lo=np.zeros(()), hi=np.ones(()))},
        name=name,
        metadata=dict(
            input_shape=(1, model.in_dim),
            weight_bits=model.weight_bits,
            act_bits=model.act_bits,
            qat_budgets=[b.bits if b else None for b in budgets],
            qat_zero_center=model.zero_center))


def proven_layer_bits(model: QATMLP, params, *,
                      domain: str = "interval",
                      name: str = "qat-mlp"
                      ) -> Tuple[BuildResult, List[int]]:
    """Export + full default ``build_flow``; returns the build result and
    the SIRA-proven accumulator bits per layer (graph order)."""
    sm = export_qat_model(model, params, name=name)
    result = build_flow(sm, input_bits=model.input_bits,
                        weight_bits=model.weight_bits, domain=domain)
    by_layer: Dict[int, AccumulatorReport] = {}
    for rep in result.accumulator_reports:
        if rep.op_type not in ("MatMul", "Gemm"):
            continue
        if rep.node_name.startswith("l") and "_matmul" in rep.node_name:
            by_layer[int(rep.node_name[1:].split("_")[0])] = rep
    n = len(model.layer_dims)
    missing = sorted(set(range(n)) - set(by_layer))
    if missing:
        raise AssertionError(
            f"layers {missing} did not streamline to pure-integer "
            f"MatMuls; accumulator reports: "
            f"{[r.node_name for r in result.accumulator_reports]}")
    return result, [by_layer[i].sira_bits for i in range(n)]


def check_budget_invariant(model: QATMLP, params,
                           bits: Optional[List[int]] = None
                           ) -> List[int]:
    """Assert the A2Q invariant: SIRA-proven accumulator bits never
    exceed the trained budget on any constrained layer.  Returns the
    proven per-layer bits."""
    if bits is None:
        _, bits = proven_layer_bits(model, params)
    for i, (b, budget) in enumerate(zip(bits, model.budgets())):
        if budget is not None and b > budget.bits:
            raise AssertionError(
                f"layer {i}: SIRA proves {b} accumulator bits, but the "
                f"QAT budget was {budget.bits} — the projection or the "
                f"export scale chain is unsound")
    return bits
