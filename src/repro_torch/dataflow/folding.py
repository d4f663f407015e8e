"""Folding search: balance per-node initiation intervals to a target FPS.

FINN-style DSE: a target frame rate fixes a cycle budget
``T = fclk / fps``; every node independently picks the *cheapest*
(PE, SIMD) assignment whose initiation interval fits ``T`` (cycles are
monotone in folding, so the cheapest feasible assignment exists iff the
fully-parallel one fits).  The folded graph is then priced and checked
against the device budget.  Infeasibility is reported with its **binding
constraint**:

  * ``ii:<node>``  — the node cannot reach the cycle budget even fully
    parallelized (throughput-bound);
  * ``luts`` / ``dsps`` / ``brams`` — the resource whose utilization
    overshoots the device the most (resource-bound).

``max_throughput`` binary-searches the cycle budget for the fastest
feasible design point on a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

from ..core.model import SiraModel
from ..obs.trace import get_tracer
from .estimate import (DataflowGraph, GraphEstimate, extract_dataflow,
                       estimate, widen_dataflow)
from .resources import (DeviceBudget, DSP_LUT_EQUIV, NodeModel,
                        baseline_style, cycles_per_frame, fold_options,
                        get_device, node_resources, resource_score,
                        select_style)


@dataclasses.dataclass
class FoldingResult:
    feasible: bool
    folding: Dict[str, Tuple[int, int]]    # node -> (pe, simd)
    target_fps: float
    achieved_fps: float
    utilization: Dict[str, float]
    binding: Optional[str]                 # None when feasible
    estimate: GraphEstimate
    device: str = ""                       # DeviceBudget.name searched on

    def summary(self) -> Dict[str, object]:
        return dict(feasible=self.feasible, target_fps=self.target_fps,
                    achieved_fps=self.achieved_fps, binding=self.binding,
                    utilization=self.utilization, device=self.device)


def _cheapest_folding_for(node: NodeModel, target_cycles: int,
                          styles: str, dsp_lut_equiv: float = DSP_LUT_EQUIV
                          ) -> Optional[Tuple[int, int]]:
    """Least-resource (pe, simd) meeting the cycle budget, or None."""
    best: Optional[Tuple[int, int]] = None
    best_score = math.inf
    n_cand = 0
    for pe, simd in fold_options(node):
        n_cand += 1
        if cycles_per_frame(node, pe, simd) > target_cycles:
            continue
        style = (baseline_style(node) if styles == "baseline"
                 else select_style(node, pe, simd, dsp_lut_equiv))
        score = resource_score(node_resources(node, style, pe, simd),
                               dsp_lut_equiv)
        if score < best_score:
            best, best_score = (pe, simd), score
    get_tracer().count("folding.candidates", n_cand, node=node.name)
    return best


def search_folding(model: SiraModel, *,
                   target_fps: float,
                   device: Union[str, DeviceBudget] = "pynq-z1",
                   widths: str = "sira",
                   styles: str = "auto",
                   input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                   dataflow_graph: Optional[DataflowGraph] = None
                   ) -> FoldingResult:
    """Find a folding that hits ``target_fps`` within the device budget,
    or report the binding constraint that prevents it."""
    tr = get_tracer()
    with tr.span("dse:search_folding", target_fps=target_fps) as sp:
        result = _search_folding(model, target_fps=target_fps,
                                 device=device, widths=widths,
                                 styles=styles,
                                 input_shapes=input_shapes,
                                 dataflow_graph=dataflow_graph)
        sp.set_attr("device", result.device)
        sp.set_attr("feasible", result.feasible)
        if result.binding is not None:
            sp.set_attr("binding", result.binding)
        return result


def _search_folding(model: SiraModel, *,
                    target_fps: float,
                    device: Union[str, DeviceBudget],
                    widths: str, styles: str,
                    input_shapes: Optional[Dict[str, Sequence[int]]],
                    dataflow_graph: Optional[DataflowGraph]
                    ) -> FoldingResult:
    tr = get_tracer()
    d = get_device(device)
    dfg = dataflow_graph or extract_dataflow(model, input_shapes)
    target_cycles = max(1, int(d.fclk_mhz * 1e6 / target_fps))

    # price width-attached nodes — the same cost model estimate() judges
    # the folded design with (raw extracted nodes carry placeholder
    # acc_bits=32, which would inflate every MAC toward dsp_mac)
    wide = widen_dataflow(model, dfg, widths)

    def attempt(dsp_lut_equiv: float) -> FoldingResult:
        folding: Dict[str, Tuple[int, int]] = {}
        for nm in dfg.nodes:
            pick = _cheapest_folding_for(wide[nm.name], target_cycles,
                                         styles, dsp_lut_equiv)
            if pick is None:
                est = estimate(model, widths=widths, styles=styles,
                               folding=folding, device=d,
                               dataflow_graph=dfg,
                               dsp_lut_equiv=dsp_lut_equiv)
                tr.count("folding.reject.ii", node=nm.name)
                return FoldingResult(
                    feasible=False, folding=folding,
                    target_fps=target_fps, achieved_fps=est.fps,
                    utilization=est.utilization(d),
                    binding=f"ii:{nm.name}", estimate=est,
                    device=d.name)
            folding[nm.name] = pick
        est = estimate(model, widths=widths, styles=styles,
                       folding=folding, device=d, dataflow_graph=dfg,
                       dsp_lut_equiv=dsp_lut_equiv)
        util = est.utilization(d)
        over = {k: v for k, v in util.items() if v > 1.0}
        if over:
            binding = max(over, key=over.get)
            tr.count(f"folding.reject.{binding}",
                     utilization=round(over[binding], 3))
            return FoldingResult(feasible=False, folding=folding,
                                 target_fps=target_fps,
                                 achieved_fps=est.fps, utilization=util,
                                 binding=binding, estimate=est,
                                 device=d.name)
        return FoldingResult(feasible=True, folding=folding,
                             target_fps=target_fps, achieved_fps=est.fps,
                             utilization=util, binding=None, estimate=est,
                             device=d.name)

    result = attempt(DSP_LUT_EQUIV)
    # styles trade DSPs against LUTs: before declaring infeasibility,
    # retry with pricing averse to the binding resource (a DSP-starved
    # budget may fit entirely in fabric, a LUT-starved one on DSPs) so
    # the reported binding constraint reflects the *design space*, not
    # one pricing of it
    if not result.feasible:
        retry_equiv = {"dsps": 1e9, "luts": 1.0}.get(result.binding)
        if retry_equiv is not None:
            alt = attempt(retry_equiv)
            if alt.feasible:
                return alt
    return result


def max_throughput(model: SiraModel, *,
                   device: Union[str, DeviceBudget] = "pynq-z1",
                   widths: str = "sira",
                   styles: str = "auto",
                   input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                   dataflow_graph: Optional[DataflowGraph] = None
                   ) -> FoldingResult:
    """Fastest feasible design point: binary search over the cycle budget
    between the fully-parallel II and the fully-folded II."""
    with get_tracer().span("dse:max_throughput",
                           device=get_device(device).name) as sp:
        result = _max_throughput(model, device=device, widths=widths,
                                 styles=styles,
                                 input_shapes=input_shapes,
                                 dataflow_graph=dataflow_graph)
        sp.set_attr("feasible", result.feasible)
        sp.set_attr("achieved_fps", result.achieved_fps)
        return result


def _max_throughput(model: SiraModel, *,
                    device: Union[str, DeviceBudget],
                    widths: str, styles: str,
                    input_shapes: Optional[Dict[str, Sequence[int]]],
                    dataflow_graph: Optional[DataflowGraph]
                    ) -> FoldingResult:
    d = get_device(device)
    dfg = dataflow_graph or extract_dataflow(model, input_shapes)
    # the graph II can never beat the slowest node's fully-parallel II
    lo = max(max(cycles_per_frame(nm, *max(
        fold_options(nm), key=lambda f: f[0] * f[1]))
        for nm in dfg.nodes), 1)
    hi = max(cycles_per_frame(nm, 1, 1) for nm in dfg.nodes)

    def attempt(cycles: int) -> FoldingResult:
        # +0.5 so the derived integer cycle budget is exactly `cycles`
        # (guarding against float round-down to cycles - 1)
        fps = d.fclk_mhz * 1e6 / (cycles + 0.5)
        return search_folding(model, target_fps=fps, device=d,
                              widths=widths, styles=styles,
                              dataflow_graph=dfg)

    best = attempt(hi)
    if not best.feasible:
        return best                      # even fully folded doesn't fit
    while lo < hi:
        mid = (lo + hi) // 2
        r = attempt(mid)
        if r.feasible:
            best, hi = r, mid
        else:
            lo = mid + 1
    return best


__all__ = ["FoldingResult", "search_folding", "max_throughput"]
