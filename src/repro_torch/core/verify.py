"""Empirical verification of SIRA ranges (paper §6.1, §7.1).

Instrument a graph by executing it over a dataset and tracking elementwise
min/max of every intermediate tensor; assert containment in the SIRA
ranges.  Also detects *stuck channels* (point output intervals — the
generalized dying-ReLU phenomenon of §7.1).

Pipeline form: ``passes.VerifyRanges`` wraps :func:`verify_ranges` as a
graph-preserving pass that reuses the ``SiraModel`` cached analysis and
can sample its dataset from the declared input ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .graph import Graph
from .intervals import ScaledIntRange


@dataclasses.dataclass
class VerificationReport:
    contained: bool
    violations: List[str]
    observed: Dict[str, Tuple[float, float]]
    coverage: Dict[str, float]   # fraction of SIRA width actually observed


def instrument(g: Graph, dataset: Iterable[Dict[str, np.ndarray]]
               ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    obs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for feeds in dataset:
        env = g.execute(feeds, record_all=True)
        for name, val in env.items():
            if name in g.initializers:
                continue
            lo, hi = float(np.min(val)), float(np.max(val))
            if name in obs:
                plo, phi = obs[name]
                obs[name] = (min(plo, lo), max(phi, hi))
            else:
                obs[name] = (lo, hi)
    return obs


def verify_ranges(g: Graph, ranges: Dict[str, ScaledIntRange],
                  dataset: Iterable[Dict[str, np.ndarray]],
                  atol: float = 1e-6) -> VerificationReport:
    obs = instrument(g, dataset)
    violations: List[str] = []
    coverage: Dict[str, float] = {}
    for name, (lo, hi) in obs.items():
        r = ranges.get(name)
        if r is None:
            continue
        rlo, rhi = float(np.min(r.lo)), float(np.max(r.hi))
        if lo < rlo - atol or hi > rhi + atol:
            violations.append(
                f"{name}: observed [{lo:.6g},{hi:.6g}] outside "
                f"SIRA [{rlo:.6g},{rhi:.6g}]")
        width = rhi - rlo
        coverage[name] = (hi - lo) / width if width > 0 else 1.0
    return VerificationReport(contained=not violations,
                              violations=violations,
                              observed=obs, coverage=coverage)


def stuck_channels(ranges: Dict[str, ScaledIntRange], tensor: str
                   ) -> np.ndarray:
    """Boolean mask of channels whose SIRA interval is a point (§7.1)."""
    r = ranges[tensor]
    lo = np.atleast_1d(r.lo)
    hi = np.atleast_1d(r.hi)
    return (hi - lo) == 0.0
