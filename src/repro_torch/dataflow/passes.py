"""Build-flow integration of the dataflow DSE subsystem.

Two graph-preserving :class:`~repro_torch.core.passes.Transformation`s,
registered with ``build_flow`` as ``step_dataflow_estimate`` and
``step_dataflow_fold`` (see :mod:`repro_torch.core.flow`).  Both reuse the
model's cached range analysis, so appending them to a flow adds zero
extra full propagations; the extracted dataflow graph (one executor
shape probe) and a folding search result are shared between the two
steps via metadata, keyed on the graph's mutation counter."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from ..core.passes import Transformation
from .estimate import compare_sira_vs_baseline, extract_dataflow
from .folding import search_folding
from .resources import DeviceBudget, get_device


def _shared_dfg(model, input_shapes):
    """Extract (or reuse) the dataflow graph, stashed with the graph
    version so a mutation between steps invalidates it."""
    cached = model.metadata.get("dataflow_graph")
    if cached is not None and cached[0] == model.graph.version:
        return cached[1]
    dfg = extract_dataflow(model, input_shapes)
    model.metadata["dataflow_graph"] = (model.graph.version, dfg)
    return dfg


class DataflowEstimate(Transformation):
    """Graph-level resource/throughput estimate + SIRA-vs-baseline
    comparison.  Stores a :class:`DataflowComparison` under
    ``metadata['dataflow_report']`` (its ``.sira`` side additionally
    under ``metadata['dataflow_estimate']``); with ``target_fps`` set,
    the folding search result also lands under ``metadata['folding']``
    (so a following :class:`DataflowFold` at the same target is free)."""

    def __init__(self, device: Union[str, DeviceBudget] = "pynq-z1",
                 target_fps: Optional[float] = None,
                 input_shapes: Optional[Dict[str, Sequence[int]]] = None):
        self.device = device
        self.target_fps = target_fps
        self.input_shapes = input_shapes

    def apply(self, model):
        dfg = _shared_dfg(model, self.input_shapes)
        folding = None
        if self.target_fps is not None:
            fold = search_folding(model, target_fps=self.target_fps,
                                  device=self.device, dataflow_graph=dfg)
            model.metadata["folding"] = fold
            if fold.feasible:
                folding = fold.folding
        report = compare_sira_vs_baseline(model, device=self.device,
                                          folding=folding,
                                          dataflow_graph=dfg)
        model.metadata["dataflow_report"] = report
        model.metadata["dataflow_estimate"] = report.sira
        return model, False


class DataflowFold(Transformation):
    """Folding search toward a target FPS under a device budget.  Stores
    the :class:`FoldingResult` (feasible or not, with the binding
    constraint) under ``metadata['folding']``.  Reuses the result a
    preceding :class:`DataflowEstimate` already computed when the graph
    and target are unchanged."""

    def __init__(self, target_fps: float = 30.0,
                 device: Union[str, DeviceBudget] = "pynq-z1",
                 input_shapes: Optional[Dict[str, Sequence[int]]] = None):
        self.target_fps = target_fps
        self.device = device
        self.input_shapes = input_shapes

    def apply(self, model):
        cached = model.metadata.get("dataflow_graph")
        existing = model.metadata.get("folding")
        if (existing is not None and cached is not None
                and cached[0] == model.graph.version
                and existing.target_fps == self.target_fps
                and existing.device == get_device(self.device).name):
            return model, False
        model.metadata["folding"] = search_folding(
            model, target_fps=self.target_fps, device=self.device,
            dataflow_graph=_shared_dfg(model, self.input_shapes))
        return model, False


__all__ = ["DataflowEstimate", "DataflowFold"]
