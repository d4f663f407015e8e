"""Export quantized LM blocks into the SIRA graph IR.

Counterpart of ``src/repro/models/export.py`` (numpy only; the same
graphs up to generated names, over this package's ``core.graph`` and
``core.intervals``).  This is the bridge between the model zoo and the
paper's analysis: a transformer block's weight-static matmul chains
(QKV/O projections, the gated MLP, MoE expert FFNs, Mamba in/out
projections) are materialized as a QONNX-style graph with Quant nodes,
so SIRA can aggregate scales, size accumulators, and convert eligible
tails to thresholds for the integer serving path.

Dynamic×dynamic parts (attention scores, SSM recurrence, gate products)
propagate plain interval ranges only — scaled-integer structure stops
there by the paper's rules, and the next Quant re-anchors it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..configs.base import ArchConfig
from ..core.graph import Graph
from ..core.intervals import ScaledIntRange


def _quant(g: Graph, x: str, scale, bits: int, signed: int, out: str) -> str:
    s = g.add_initializer(scale)
    z = g.add_initializer(0.0)
    b = g.add_initializer(float(bits))
    g.add_node("Quant", [x, s, z, b], [out], dict(signed=signed, narrow=0))
    return out


def _qmatmul(g: Graph, rng, x: str, k: int, m: int, w_bits: int,
             prefix: str) -> str:
    W = rng.normal(size=(k, m)) * (1.0 / np.sqrt(k))
    w = g.add_initializer(W, f"{prefix}_W")
    sw = np.maximum(np.abs(W).max(axis=0) / (2 ** (w_bits - 1) - 1), 1e-8)
    wq = _quant(g, w, sw, w_bits, 1, f"{prefix}_Wq")
    g.add_node("MatMul", [x, wq], [f"{prefix}_mm"])
    return f"{prefix}_mm"


def export_block_graph(cfg: ArchConfig, w_bits: int = 4, a_bits: int = 4,
                       seed: int = 0
                       ) -> Tuple[Graph, Dict[str, ScaledIntRange]]:
    """One quantized block of ``cfg`` as a SIRA graph.

    Returns (graph, input_ranges).  The block input is assumed calibrated
    to [-4, 4] (typical post-norm activation range)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 8.0 / (2 ** a_bits), a_bits, 1, "Xq")

    outs = []
    if cfg.n_heads:
        hh = cfg.n_heads * cfg.hd
        kvh = cfg.n_kv_heads * cfg.hd
        for name, m in [("wq", hh), ("wk", kvh), ("wv", kvh)]:
            mm = _qmatmul(g, rng, x, d, m, w_bits, name)
            outs.append(_quant(g, mm, 0.1, a_bits, 1, f"{name}_out"))
        # o-projection fed by a re-quantized attention output
        attn = _quant(g, "Attn", 8.0 / (2 ** a_bits), a_bits, 1, "attn_q")
        mm = _qmatmul(g, rng, attn, hh, d, w_bits, "wo")
        outs.append(_quant(g, mm, 0.1, a_bits, 1, "wo_out"))

    if cfg.family == "ssm" or cfg.family == "hybrid":
        d_in = cfg.ssm.expand * d
        d_proj = 2 * d_in + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + \
            max(d_in // cfg.ssm.head_dim, 1)
        mm = _qmatmul(g, rng, x, d, d_proj, w_bits, "in_proj")
        outs.append(_quant(g, mm, 0.1, a_bits, 1, "in_proj_out"))
        ssm_out = _quant(g, "SSMout", 8.0 / (2 ** a_bits), a_bits, 1,
                         "ssm_q")
        mm = _qmatmul(g, rng, ssm_out, d_in, d, w_bits, "out_proj")
        outs.append(_quant(g, mm, 0.1, a_bits, 1, "out_proj_out"))
    elif cfg.moe.n_experts:
        fe = cfg.moe.d_expert
        mm = _qmatmul(g, rng, x, d, fe, w_bits, "expert_up")
        # gated product is dynamic×dynamic → range-only region; the next
        # quantizer re-anchors the integer structure
        g.add_node("Silu", [mm], ["expert_act"])
        h = _quant(g, "expert_act", 0.05, a_bits, 1, "expert_h")
        mm2 = _qmatmul(g, rng, h, fe, d, w_bits, "expert_down")
        outs.append(_quant(g, mm2, 0.1, a_bits, 1, "expert_out"))
    elif cfg.d_ff:
        ff = cfg.d_ff
        mm = _qmatmul(g, rng, x, d, ff, w_bits, "w_up")
        if cfg.mlp_act == "gelu":
            g.add_node("Gelu", [mm], ["mlp_act"])
        else:
            g.add_node("Silu", [mm], ["mlp_act"])
        h = _quant(g, "mlp_act", 0.05, a_bits, 1, "mlp_h")
        mm2 = _qmatmul(g, rng, h, ff, d, w_bits, "w_down")
        outs.append(_quant(g, mm2, 0.1, a_bits, 1, "mlp_out"))

    g.outputs = outs
    inputs = {"X": ScaledIntRange(lo=np.asarray(-4.0), hi=np.asarray(4.0))}
    if cfg.n_heads:
        inputs["Attn"] = ScaledIntRange(lo=np.asarray(-4.0),
                                        hi=np.asarray(4.0))
    if cfg.family in ("ssm", "hybrid"):
        inputs["SSMout"] = ScaledIntRange(lo=np.asarray(-4.0),
                                          hi=np.asarray(4.0))
    g.inputs = list(inputs)
    return g, inputs


def export_kv_proj_graph(Wk: np.ndarray, Wv: np.ndarray, *,
                         bk: np.ndarray = None, bv: np.ndarray = None,
                         x_lo: float = -4.0, x_hi: float = 4.0,
                         a_bits: int = 8, w_bits: int = 8
                         ) -> Tuple[Graph, Dict[str, ScaledIntRange]]:
    """K/V projection subgraph of one attention layer, built from the
    *actual serving weights*, as a SIRA graph.

    This is what makes the serving KV cache the first consumer of SIRA
    ranges outside the graph IR: running ``core.propagate.analyze`` on
    this graph yields per-output-channel value intervals for the K and V
    tensors entering the cache (outputs ``k_mm`` / ``v_mm``), from which
    ``serve.kv_cache`` derives guaranteed-coverage int8 storage scales
    (A2Q-style: saturation only outside the statically-proven range).

    The input X models the post-norm activation feeding wk/wv, quantized
    per the serving activation precision; weights carry per-output-channel
    Quant nodes so the MatMul propagates scaled-integer structure.
    """
    g = Graph(inputs=["X"], outputs=[])
    s = g.add_initializer(max(abs(x_lo), abs(x_hi)) / (2 ** (a_bits - 1)))
    z = g.add_initializer(0.0)
    b = g.add_initializer(float(a_bits))
    g.add_node("Quant", ["X", s, z, b], ["Xq"], dict(signed=1, narrow=0))
    for name, W, bias in (("k", Wk, bk), ("v", Wv, bv)):
        W = np.asarray(W, np.float64)
        w = g.add_initializer(W, f"{name}_W")
        sw = np.maximum(np.abs(W).max(axis=0) / (2 ** (w_bits - 1) - 1),
                        1e-8)
        ws = g.add_initializer(sw)
        wb = g.add_initializer(float(w_bits))
        g.add_node("Quant", [w, ws, z, wb], [f"{name}_Wq"],
                   dict(signed=1, narrow=0))
        if bias is not None:
            g.add_node("MatMul", ["Xq", f"{name}_Wq"], [f"{name}_proj"])
            bi = g.add_initializer(np.asarray(bias, np.float64),
                                   f"{name}_b")
            g.add_node("Add", [f"{name}_proj", bi], [f"{name}_mm"])
        else:
            g.add_node("MatMul", ["Xq", f"{name}_Wq"], [f"{name}_mm"])
    g.outputs = ["k_mm", "v_mm"]
    inputs = {"X": ScaledIntRange(lo=np.asarray(float(x_lo)),
                                  hi=np.asarray(float(x_hi)))}
    return g, inputs
