"""Carry the reference package's objects across into this package.

The JAX package (``repro``) and this one keep separate copies of
``Graph``, ``ScaledIntRange`` and ``SiraModel``.  These converters read the
reference's objects **by duck typing** — attribute names only, no import of
``repro`` — and build this package's own, so a model analysed and optimized
by the reference can be lowered here.  The tests use that to hold the
backend to the reference independently of the analysis.
"""
from __future__ import annotations

import copy
from typing import Any

import numpy as np

from .graph import Graph, Node
from .intervals import ScaledIntRange
from .model import SiraModel


def graph_from_reference(g: Any) -> Graph:
    """A graph with ``inputs``, ``outputs``, ``initializers`` (numpy) and
    nodes carrying ``op_type``, ``inputs``, ``outputs``, ``attrs``,
    ``name`` → this package's :class:`Graph` (arrays and attrs copied)."""
    out = Graph(list(g.inputs), list(g.outputs))
    out.nodes = [Node(n.op_type, list(n.inputs), list(n.outputs),
                      copy.deepcopy(dict(n.attrs)), name=n.name)
                 for n in g.nodes]
    out.initializers = {k: np.array(v, dtype=np.float64, copy=True)
                        for k, v in g.initializers.items()}
    return out


def range_from_reference(r: Any) -> ScaledIntRange:
    """An object with the fields of ``ScaledIntRange`` (``lo, hi, int_lo,
    int_hi, scale, bias, scale_src, bias_src``) → this package's."""
    def arr(v):
        return None if v is None else np.array(v, copy=True)
    return ScaledIntRange(lo=arr(r.lo), hi=arr(r.hi),
                          int_lo=arr(r.int_lo), int_hi=arr(r.int_hi),
                          scale=arr(r.scale), bias=arr(r.bias),
                          scale_src=frozenset(r.scale_src),
                          bias_src=frozenset(r.bias_src))


def model_from_reference(m: Any) -> SiraModel:
    """An object with ``graph, input_ranges, name, metadata, domain`` →
    this package's :class:`SiraModel`.  The analysis is recomputed here on
    first use; metadata is carried shallowly, minus a compiled executable
    of the other package."""
    meta = {k: v for k, v in dict(m.metadata).items() if k != "compiled"}
    return SiraModel(
        graph_from_reference(m.graph),
        {k: range_from_reference(r) for k, r in m.input_ranges.items()},
        name=m.name, metadata=meta, domain=m.domain)
