"""Dataflow accelerator design-space exploration (DSE) on SIRA analyses.

The paper's headline results come from applying SIRA bitwidths to a whole
FPGA dataflow accelerator; this package turns an analyzed
:class:`~repro_torch.core.model.SiraModel` into accelerator-level numbers:

  * :mod:`costmodel`  — the paper's per-tail LUT models (Table 4/Fig 23;
    absorbed from ``repro_torch.core.costmodel``, which remains as a shim);
  * :mod:`resources`  — per-node LUT/DSP/BRAM + cycles models, device
    budgets, style selection (thresholding / composite / DSP-MAC);
  * :mod:`estimate`   — whole-graph estimates, FIFO sizing, and the
    SIRA-vs-datatype-baseline comparison;
  * :mod:`folding`    — PE/SIMD folding search to a target FPS with
    binding-constraint reporting, plus max-throughput search;
  * :mod:`simulate`   — cycle-accurate stream simulator validating the
    analytical II/FIFO models (tests only);
  * :mod:`passes`     — ``step_dataflow_estimate`` / ``step_dataflow_fold``
    build-flow steps.
"""
from .costmodel import (ELEMENTWISE_COEFFS, TailCost, lut_add,  # noqa: F401
                        lut_composite_compute, lut_composite_memory,
                        lut_composite_total, lut_max, lut_meta_kernel,
                        lut_mul, lut_threshold_compute,
                        lut_threshold_memory, lut_threshold_total,
                        lut_toint, n_thresholds, select_tail_style,
                        tail_cost, hbm_tail_bytes)
from .resources import (DEVICES, DeviceBudget, NodeModel,      # noqa: F401
                        NONLINEAR_ELEMENTWISE, Resources, baseline_style,
                        cycles_per_frame, fifo_depth, fifo_resources,
                        fold_options, get_device, node_resources,
                        node_styles, resource_score, select_style)
from .estimate import (DataflowComparison, DataflowGraph, Edge,  # noqa: F401
                       FifoEstimate, GraphEstimate, NodeEstimate,
                       compare_sira_vs_baseline, estimate,
                       extract_dataflow, widen_dataflow)
from .folding import (FoldingResult, max_throughput,           # noqa: F401
                      search_folding)
from .simulate import (SimEdge, SimNode, SimResult,            # noqa: F401
                       analytical_ii, from_estimate, simulate)
from .passes import DataflowEstimate, DataflowFold             # noqa: F401
