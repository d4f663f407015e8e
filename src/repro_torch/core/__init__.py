"""SIRA core: scaled-integer range analysis and FDNA-style optimizations.

New (preferred) API — ``SiraModel`` + transformation passes + build flow:

    from repro_torch.core import SiraModel, build_flow
    result = build_flow(SiraModel.from_workload(make_tfc()))

The loose functions (``analyze``, ``convert_tails_to_thresholds``,
``minimize_accumulators``, ``verify_ranges``) remain as deprecated shims
over the pass pipeline.  The ``streamline`` function family
(``streamline``, ``aggregate_scales_biases``, ``explicitize_quantizers``,
``duplicate_shared_constants``) has been removed — use
``passes.Streamline`` / ``flow.build_flow`` or the ``*_inplace`` cores in
``streamline.py``.
"""
from .intervals import ScaledIntRange, InvalidRangeError   # noqa: F401
from .ops import (OpDef, OP_REGISTRY, register_op, get_op,  # noqa: F401
                  EXEC_REGISTRY, PROP_REGISTRY, COST_REGISTRY,
                  AFFINE_REGISTRY, MONOTONE_REGISTRY)
from .graph import Graph, Node, quant_bounds               # noqa: F401
from .propagate import (SIRA, analyze, analysis_calls,     # noqa: F401
                        POISON, DOMAINS)
from .model import SiraModel                               # noqa: F401
from .streamline import (remove_identity_ops,              # noqa: F401
                         AggregationResult)
from .monotone import (MonotoneCertificate, MonotoneStep,  # noqa: F401
                       certify_tail, compose_direction)
from .thresholds import (convert_tails_to_thresholds,      # noqa: F401
                         find_layer_tails, extract_thresholds,
                         convert_tails, ThresholdConversionError,
                         TailReport, ThresholdSpec)
from .accumulator import (minimize_accumulators, datatype_bound_bits,  # noqa: F401
                          sira_bits, summarize, accumulator_dtype,
                          exact_worst_case_bits)
from .verify import verify_ranges, instrument, stuck_channels  # noqa: F401
from .passes import (Transformation, Fixpoint, Sequence,   # noqa: F401
                     FunctionTransformation, ExplicitizeQuantizers,
                     DuplicateSharedConstants, AggregateScalesBiases,
                     RemoveIdentityOps, Streamline,
                     ConvertTailsToThresholds, MinimizeAccumulators,
                     VerifyRanges, VerificationError, LintGraph)
from .lint import (lint_graph, LintReport, LintFinding,    # noqa: F401
                   LintError)
from .lower import (lower, CompiledSiraModel, CompileBackend,  # noqa: F401
                    LoweringError, LoweredOp)
from .convert import (graph_from_reference,                # noqa: F401
                      range_from_reference, model_from_reference)
from .flow import (BuildConfig, BuildResult, StepReport,   # noqa: F401
                   build_flow, register_step, STEP_REGISTRY,
                   DEFAULT_STEPS, DATAFLOW_STEPS)
