"""The dataflow DSE report of one workload in both analysis domains.

The columns are those of the repository's dataflow benchmark
(``benchmarks/bench_dataflow.py``, baseline
``benchmarks/baselines/BENCH_dataflow.json``): SIRA-vs-datatype-baseline
resource estimates at the folding the search finds for ``target_fps``,
the folding and max-throughput design points, a deliberately infeasible
budget, the tail-conversion outcomes and the interval-vs-affine columns.
They are computed from ``build_flow(..., steps=DATAFLOW_STEPS)`` in each
domain, whose dataflow steps already hold the estimate and the folding
under ``metadata``.  Every number is an output of the analytical FPGA
model of :mod:`repro_torch.dataflow.resources`, not a measurement.

    from repro_torch.dataflow.report import dataflow_flows, report_row
    row = report_row("CNV-w2a2", dataflow_flows(make_cnv()))
"""
from __future__ import annotations

import time
from typing import Dict

from ..core.flow import DATAFLOW_STEPS, BuildResult, build_flow
from ..core.propagate import DOMAINS
from .estimate import estimate
from .folding import max_throughput, search_folding
from .resources import DeviceBudget

# a budget no workload fits: exercises binding-constraint reporting
TINY = DeviceBudget("tiny", luts=400, dsps=1, brams=1)


def dataflow_flows(workload, device: str = "pynq-z1",
                   target_fps: float = 1000.0) -> Dict[str, BuildResult]:
    """``build_flow`` with ``DATAFLOW_STEPS`` in each domain, by domain."""
    return {d: build_flow(workload, steps=DATAFLOW_STEPS, domain=d,
                          device=device, target_fps=target_fps)
            for d in DOMAINS}


def report_row(name: str, flows: Dict[str, BuildResult]) -> dict:
    """The benchmark's columns for one workload, from its two flows."""
    t0 = time.perf_counter()
    model, model_aff = flows["interval"].model, flows["affine"].model
    comp = model.metadata["dataflow_report"]
    fold = model.metadata["folding"]
    device, target_fps = fold.device, fold.target_fps
    dfg = model.metadata["dataflow_graph"][1]
    infeasible = search_folding(model, target_fps=target_fps, device=TINY,
                                dataflow_graph=dfg)
    best = max_throughput(model, device=device, dataflow_graph=dfg)

    # interval-vs-affine: proven accumulator bits plus LUT/DSP at a fixed
    # (fully folded, PE=SIMD=1) design point
    acc_int = sum(r.sira_bits for r in
                  model.metadata["accumulator_reports"])
    acc_aff = sum(r.sira_bits for r in
                  model_aff.metadata["accumulator_reports"])
    est_int_unf = estimate(model, widths="sira", device=device,
                           dataflow_graph=dfg)
    est_aff_unf = estimate(model_aff, widths="sira", device=device,
                           dataflow_graph=model_aff.metadata[
                               "dataflow_graph"][1])
    seconds = time.perf_counter() - t0

    reports = model.metadata.get("tail_reports", [])
    statuses: dict = {}
    for r in reports:
        statuses[r.status] = statuses.get(r.status, 0) + 1

    est = comp.sira
    return dict(
        workload=name,
        graph_nodes=len(model.graph.nodes),
        compute_nodes=len(est.nodes),
        fifos=len(est.fifos),
        styles=est.style_counts(),
        baseline_styles=comp.baseline.style_counts(),
        tails_total=len(reports),
        tails_converted=sum(1 for r in reports if r.converted),
        tails_meta_kernel=sum(1 for r in reports if not r.converted),
        tail_certificates=statuses,
        mean_acc_bits_sira=round(comp.mean_acc_bits_sira, 4),
        mean_acc_bits_datatype=round(comp.mean_acc_bits_datatype, 4),
        acc_bits_reduction=round(comp.acc_bits_reduction, 4),
        sira_luts=round(est.luts, 1),
        sira_dsps=est.dsps,
        sira_brams=est.brams,
        baseline_luts=round(comp.baseline.luts, 1),
        baseline_dsps=comp.baseline.dsps,
        baseline_brams=comp.baseline.brams,
        lut_reduction=round(comp.lut_reduction, 4),
        dsp_reduction=round(comp.dsp_reduction, 4),
        tail_lut_ratio=round(comp.tail_lut_ratio, 4),
        fold_feasible=fold.feasible,
        fold_binding=fold.binding,
        fold_fps=round(fold.achieved_fps, 1),
        infeasible_binding=infeasible.binding,
        max_fps=round(best.achieved_fps, 1),
        acc_bits_sum_interval=acc_int,
        acc_bits_sum_affine=acc_aff,
        affine_acc_bits_saved=acc_int - acc_aff,
        interval_luts_unfolded=round(est_int_unf.luts, 1),
        affine_luts_unfolded=round(est_aff_unf.luts, 1),
        interval_dsps_unfolded=est_int_unf.dsps,
        affine_dsps_unfolded=est_aff_unf.dsps,
        affine_luts_saved=round(est_int_unf.luts - est_aff_unf.luts, 1),
        seconds=seconds,
    )
