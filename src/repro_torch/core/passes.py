"""Composable transformation passes over :class:`~repro_torch.core.model.SiraModel`.

QONNX/FINN-style design: every pass is a :class:`Transformation` with

    apply(model) -> (model, modified)

``modified`` reports whether the graph was structurally changed; the
``SiraModel`` analysis cache is keyed on the graph version, so read-only
passes (accumulator minimization, verification, reporting) share one full
range propagation instead of re-running it per pass.

Combinators: ``tx.fixpoint()`` applies a pass until it stops reporting
changes; ``Sequence([...])`` chains passes.  ``flow.build_flow`` drives
declarative step lists of these with timing/verification hooks.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .accumulator import minimize_accumulators as _minimize_accumulators
from .model import SiraModel
from .streamline import (aggregate_with_ranges,
                         duplicate_shared_constants_inplace,
                         explicitize_quantizers_inplace,
                         remove_identity_ops as _remove_identity_ops)
from .thresholds import convert_tails
from .verify import verify_ranges as _verify_ranges

TransformResult = Tuple[SiraModel, bool]


class Transformation:
    """Base class: ``apply(model) -> (model, modified)``.

    Passes mutate ``model.graph`` in place (the model owns its graph; use
    ``SiraModel.transform(...)`` or ``build_flow`` for copy-on-entry
    semantics) and must report structural changes truthfully — the analysis
    cache depends on it."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, model: SiraModel) -> TransformResult:
        raise NotImplementedError

    def __call__(self, model: SiraModel) -> SiraModel:
        return self.apply(model)[0]

    def fixpoint(self, max_iter: int = 20) -> "Fixpoint":
        return Fixpoint(self, max_iter=max_iter)


class Fixpoint(Transformation):
    """Apply an inner pass until it reports no modification."""

    def __init__(self, inner: Transformation, max_iter: int = 20):
        self.inner = inner
        self.max_iter = max_iter

    @property
    def name(self) -> str:
        return f"fixpoint({self.inner.name})"

    def apply(self, model: SiraModel) -> TransformResult:
        any_mod = False
        for _ in range(self.max_iter):
            model, mod = self.inner.apply(model)
            any_mod |= mod
            if not mod:
                return model, any_mod
        raise RuntimeError(
            f"{self.inner.name} did not reach a fixpoint in "
            f"{self.max_iter} iterations")


class Sequence(Transformation):
    """Chain passes; modified = any inner pass modified."""

    def __init__(self, transformations: Iterable[Transformation],
                 name: str = ""):
        self.transformations = list(transformations)
        self._name = name

    @property
    def name(self) -> str:
        return self._name or "+".join(t.name for t in self.transformations)

    def apply(self, model: SiraModel) -> TransformResult:
        any_mod = False
        for tx in self.transformations:
            model, mod = tx.apply(model)
            any_mod |= mod
        return model, any_mod


class FunctionTransformation(Transformation):
    """Adapt a plain callable.  The callable may return ``None`` (in-place,
    unknown modification → treated as modified), a model, or a
    ``(model, modified)`` pair."""

    def __init__(self, fn: Callable, name: str = ""):
        self.fn = fn
        self._name = name or getattr(fn, "__name__", "fn")

    @property
    def name(self) -> str:
        return self._name

    def apply(self, model: SiraModel) -> TransformResult:
        out = self.fn(model)
        if out is None:
            model.graph.touch()
            return model, True
        if isinstance(out, tuple):
            return out
        return out, True


def as_transformation(step) -> Transformation:
    if isinstance(step, Transformation):
        return step
    if callable(step):
        return FunctionTransformation(step)
    raise TypeError(f"cannot interpret {step!r} as a Transformation")


# --------------------------------------------------------------------------
# streamlining passes (paper §4.1.2)
# --------------------------------------------------------------------------

class ExplicitizeQuantizers(Transformation):
    """Rewrite non-trivial ``Quant`` nodes into explicit Div/Add/Quant/Sub/
    Mul chains (idempotent: second application is a no-op)."""

    def apply(self, model: SiraModel) -> TransformResult:
        return model, explicitize_quantizers_inplace(model.graph)


class DuplicateSharedConstants(Transformation):
    """Private per-consumer copies of shared constants (idempotent)."""

    def apply(self, model: SiraModel) -> TransformResult:
        return model, duplicate_shared_constants_inplace(model.graph)


class AggregateScalesBiases(Transformation):
    """Scale/bias aggregation at every safe boundary tensor, driven by the
    model's (cached) contribution-tracking analysis.  Stores the
    :class:`~repro_torch.core.streamline.AggregationResult` under
    ``metadata['aggregation']``."""

    def __init__(self, explicitize: bool = True):
        self.explicitize = explicitize

    def apply(self, model: SiraModel) -> TransformResult:
        changed = False
        if self.explicitize:
            changed |= explicitize_quantizers_inplace(model.graph)
        changed |= duplicate_shared_constants_inplace(model.graph)
        result, agg_changed = aggregate_with_ranges(model.graph,
                                                        model.ranges)
        model.metadata["aggregation"] = result
        return model, changed or agg_changed


class RemoveIdentityOps(Transformation):
    """Remove Mul(x,1)/Div(x,1)/Add(x,0)/Sub(x,0) (idempotent)."""

    def apply(self, model: SiraModel) -> TransformResult:
        return model, _remove_identity_ops(model.graph)


class Streamline(Sequence):
    """Full SIRA streamlining (explicitize + aggregate; aggregation already
    removes identities and dead code)."""

    def __init__(self):
        super().__init__([AggregateScalesBiases(explicitize=True)],
                         name="Streamline")


# --------------------------------------------------------------------------
# threshold conversion (paper §4.1.3)
# --------------------------------------------------------------------------

class ConvertTailsToThresholds(Transformation):
    """Collapse quantized layer tails into MultiThreshold nodes.  Stores the
    extracted specs under ``metadata['threshold_specs']`` and the per-tail
    conversion outcomes (certificate status, reason codes for tails left
    as elementwise chains) under ``metadata['tail_reports']``."""

    def __init__(self, method: str = "auto"):
        self.method = method

    def apply(self, model: SiraModel) -> TransformResult:
        specs, reports = convert_tails(model.graph, model.ranges,
                                       method=self.method)
        model.metadata["threshold_specs"] = specs
        model.metadata["tail_reports"] = reports
        return model, bool(specs)


# --------------------------------------------------------------------------
# analysis passes (graph-preserving; share the cached analysis)
# --------------------------------------------------------------------------

class MinimizeAccumulators(Transformation):
    """Accumulator-width reports (paper §4.2) under
    ``metadata['accumulator_reports']``.  Never modifies the graph."""

    def __init__(self, input_bits: int = 8, weight_bits: int = 8):
        self.input_bits = input_bits
        self.weight_bits = weight_bits

    def apply(self, model: SiraModel) -> TransformResult:
        model.metadata["accumulator_reports"] = _minimize_accumulators(
            model.graph, model.input_ranges,
            input_bits=self.input_bits, weight_bits=self.weight_bits,
            ranges=model.ranges)
        return model, False


class LintGraph(Transformation):
    """Static well-formedness lint (:func:`repro_torch.core.lint.lint_graph`).
    Stores the :class:`~repro_torch.core.lint.LintReport` under
    ``metadata['lint']``; raises :class:`~repro_torch.core.lint.LintError` when
    ``strict`` and error-level findings exist.  Never modifies the graph.

    Range validation covers the *declared input ranges* plus any cached
    analysis — it deliberately does not force a fresh propagation, so the
    lint stays runnable on graphs too malformed to analyze."""

    def __init__(self, strict: bool = True,
                 input_shapes: Optional[Dict[str, tuple]] = None):
        self.strict = strict
        self.input_shapes = input_shapes

    def apply(self, model: SiraModel) -> TransformResult:
        from .lint import LintError, lint_graph
        shapes = self.input_shapes
        if shapes is None:
            shape = model.metadata.get("input_shape")
            if shape is not None and len(model.graph.inputs) == 1:
                shapes = {model.graph.inputs[0]: tuple(shape)}
        cached = model.ranges if model.analysis_cached else None
        report = lint_graph(model.graph, model.input_ranges,
                            input_shapes=shapes, ranges=cached)
        model.metadata["lint"] = report
        if self.strict and not report.ok:
            raise LintError(report)
        return model, False


class VerificationError(AssertionError):
    pass


class VerifyRanges(Transformation):
    """Empirical containment check (paper §6.1): execute the graph on a
    dataset (given, or sampled from the declared input ranges) and assert
    every observation lies inside its SIRA range.  Stores the report under
    ``metadata['verification']``; raises :class:`VerificationError` when
    ``strict`` and containment fails.  Never modifies the graph."""

    def __init__(self, dataset: Optional[List[Dict[str, np.ndarray]]] = None,
                 samples: int = 4, seed: int = 0, strict: bool = True):
        self.dataset = dataset
        self.samples = samples
        self.seed = seed
        self.strict = strict

    def apply(self, model: SiraModel) -> TransformResult:
        data = self.dataset
        if data is None:
            try:
                data = list(model.sample_inputs(
                    rng=np.random.default_rng(self.seed), n=self.samples))
            except ValueError:
                model.metadata["verification"] = None  # no shapes known
                return model, False
        report = _verify_ranges(model.graph, model.ranges, data)
        model.metadata["verification"] = report
        if self.strict and not report.contained:
            raise VerificationError(
                f"SIRA containment violated: {report.violations[:3]}")
        return model, False
