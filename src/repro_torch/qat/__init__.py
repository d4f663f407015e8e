"""Accumulator-aware QAT (A2Q / A2Q+): train weights that provably fit
a chosen accumulator width, then prove it with SIRA and price it with
the dataflow DSE — the paper stack's train -> analyze -> optimize ->
price loop in one subsystem.

    from repro_torch.qat import QATConfig, run_qat, check_budget_invariant
    res = run_qat(QATConfig(budget=14, steps=200), device="cuda")
    bits = check_budget_invariant(res.model, res.state.params)
"""
from .constraints import (AccumulatorBudget, ProjectionFuzzReport,
                          budget_penalty, channel_bits, fuzz_projection,
                          project_weights, quantize_weights,
                          weight_quant_spec, worst_case_inputs)
from .export import (check_budget_invariant, export_qat_model,
                     proven_layer_bits)
from .loop import QATConfig, QATResult, make_optimizer, run_qat
from .model import QATMLP
from .convert import (params_from_reference, qat_model_from_reference,
                      train_state_from_reference)

__all__ = [
    "AccumulatorBudget", "ProjectionFuzzReport", "budget_penalty",
    "channel_bits", "fuzz_projection", "project_weights",
    "quantize_weights", "weight_quant_spec", "worst_case_inputs",
    "check_budget_invariant", "export_qat_model", "proven_layer_bits",
    "QATConfig", "QATResult", "make_optimizer", "run_qat", "QATMLP",
    "params_from_reference", "qat_model_from_reference",
    "train_state_from_reference",
]
