"""FINN-builder-style declarative build flow over ``SiraModel``.

    from repro_torch.core import SiraModel, build_flow
    result = build_flow(SiraModel.from_workload(make_tfc()))
    result.graph                 # streamlined + thresholded graph
    result.accumulator_reports   # paper §4.2 widths
    result.steps                 # per-step timing / modified / #analyses

A flow is a list of *steps* — registered step names, ``Transformation``
instances, or plain callables — executed in order with per-step timing,
analysis-call accounting (how many full range propagations each step
triggered; consecutive graph-preserving steps share one cached analysis)
and optional per-step verification hooks:

  * ``verify="equivalence"``  — after each step, the graph must produce
    outputs numerically identical to the pre-flow model on random inputs.
  * ``verify="containment"``  — after each step, empirical min/max of every
    tensor must lie inside the (cached) SIRA ranges.
  * ``verify="full"``         — both.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import propagate as _prop
from ..obs.trace import get_tracer
from .lower import CompileBackend
from .model import SiraModel
from .passes import (AggregateScalesBiases, ConvertTailsToThresholds,
                     ExplicitizeQuantizers, MinimizeAccumulators,
                     RemoveIdentityOps, Transformation, VerifyRanges,
                     as_transformation)
from .verify import verify_ranges as _verify_ranges
from .workloads import QNNWorkload

Step = Union[str, Transformation, Callable]

DEFAULT_STEPS: List[str] = [
    "explicitize_quantizers",
    "aggregate_scales_biases",
    "convert_tails_to_thresholds",
    "minimize_accumulators",
    "verify_ranges",
]


@dataclasses.dataclass
class BuildConfig:
    """Declarative flow configuration (FINN ``DataflowBuildConfig`` style)."""
    steps: Sequence[Step] = tuple(DEFAULT_STEPS)
    threshold_method: str = "auto"       # "auto" | "edge" | "bisect"
    input_bits: int = 8
    weight_bits: int = 8
    verify: str = "none"                 # "none"|"equivalence"|"containment"|"full"
    verify_samples: int = 3
    seed: int = 0
    strict_verify: bool = True
    # abstract domain for range analysis: "interval" (paper default) or
    # "affine" (zonotope reduced product, repro_torch.core.affine)
    domain: str = "interval"
    # pre-flow graph lint (repro_torch.core.lint); "strict" raises LintError on
    # errors, "warn" records the report under metadata['lint'], "off" skips
    lint: str = "strict"
    # dataflow DSE steps (step_dataflow_estimate / step_dataflow_fold):
    # None -> unfolded estimate; DataflowFold then targets 30 FPS
    device: str = "pynq-z1"
    target_fps: Optional[float] = None


@dataclasses.dataclass
class StepReport:
    name: str
    modified: bool
    seconds: float
    analysis_calls: int       # full range propagations triggered by the step
    note: str = ""


@dataclasses.dataclass
class BuildResult:
    model: SiraModel
    steps: List[StepReport]

    @property
    def graph(self):
        return self.model.graph

    @property
    def threshold_specs(self):
        return self.model.metadata.get("threshold_specs", [])

    @property
    def tail_reports(self):
        return self.model.metadata.get("tail_reports", [])

    @property
    def accumulator_reports(self):
        return self.model.metadata.get("accumulator_reports", [])

    @property
    def verification(self):
        return self.model.metadata.get("verification")

    @property
    def aggregation(self):
        return self.model.metadata.get("aggregation")

    @property
    def total_analysis_calls(self) -> int:
        return sum(s.analysis_calls for s in self.steps)


# --------------------------------------------------------------------------
# step registry: name -> factory(BuildConfig) -> Transformation
# --------------------------------------------------------------------------

STEP_REGISTRY: Dict[str, Callable[[BuildConfig], Transformation]] = {}


def register_step(name: str):
    def deco(factory):
        STEP_REGISTRY[name] = factory
        return factory
    return deco


register_step("explicitize_quantizers")(
    lambda cfg: ExplicitizeQuantizers())
register_step("aggregate_scales_biases")(
    lambda cfg: AggregateScalesBiases(explicitize=False))
register_step("streamline")(
    lambda cfg: AggregateScalesBiases(explicitize=True))
register_step("remove_identity_ops")(
    lambda cfg: RemoveIdentityOps())
register_step("convert_tails_to_thresholds")(
    lambda cfg: ConvertTailsToThresholds(method=cfg.threshold_method))
register_step("minimize_accumulators")(
    lambda cfg: MinimizeAccumulators(input_bits=cfg.input_bits,
                                     weight_bits=cfg.weight_bits))
register_step("verify_ranges")(
    lambda cfg: VerifyRanges(samples=cfg.verify_samples, seed=cfg.seed,
                             strict=cfg.strict_verify))


def _step_lint(cfg: "BuildConfig"):
    from .passes import LintGraph
    return LintGraph(strict=cfg.lint != "warn")


# explicit mid-flow lint (build_flow always pre-lints unless lint="off")
register_step("lint_graph")(_step_lint)
# lower to the compiled CUDA-kernel backend (result under
# metadata['compiled']); optional — append to cfg.steps to enable, e.g.
#   build_flow(wl, steps=list(DEFAULT_STEPS) + ["step_compile"])
register_step("step_compile")(
    lambda cfg: CompileBackend())
register_step("compile")(
    lambda cfg: CompileBackend())


# dataflow DSE steps: the names stay registered so a flow that lists them
# fails with a clear message (not a KeyError) until dataflow/ is ported.
def _step_dataflow_estimate(cfg: "BuildConfig"):
    raise NotImplementedError(
        "step_dataflow_estimate: dataflow/ is not ported yet, see ROADMAP A")


def _step_dataflow_fold(cfg: "BuildConfig"):
    raise NotImplementedError(
        "step_dataflow_fold: dataflow/ is not ported yet, see ROADMAP A")


register_step("step_dataflow_estimate")(_step_dataflow_estimate)
register_step("step_dataflow_fold")(_step_dataflow_fold)

#: DEFAULT_STEPS plus the dataflow DSE tail — the full accelerator flow
DATAFLOW_STEPS: List[str] = list(DEFAULT_STEPS) + [
    "step_dataflow_estimate", "step_dataflow_fold"]


def resolve_step(step: Step, cfg: BuildConfig) -> Transformation:
    if isinstance(step, str):
        if step not in STEP_REGISTRY:
            raise KeyError(f"unknown build step {step!r}; registered: "
                           f"{sorted(STEP_REGISTRY)}")
        return STEP_REGISTRY[step](cfg)
    return as_transformation(step)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _as_model(model, domain: str = "interval") -> SiraModel:
    if isinstance(model, SiraModel):
        m = model.copy()
        if domain != "interval" and m.domain != domain:
            m.domain = domain
            m.invalidate()
        return m
    if isinstance(model, QNNWorkload):
        return SiraModel.from_workload(model, domain=domain)
    if isinstance(model, tuple) and len(model) == 2:
        graph, input_ranges = model
        return SiraModel(graph.copy(), input_ranges, domain=domain)
    raise TypeError(f"cannot build a SiraModel from {type(model).__name__}")


def build_flow(model, cfg: Optional[BuildConfig] = None,
               **overrides: Any) -> BuildResult:
    """Run a configured step list over a model (``SiraModel``,
    ``QNNWorkload``, or ``(graph, input_ranges)``; the input is never
    mutated).  Keyword overrides patch ``cfg`` fields, e.g.
    ``build_flow(wl, verify="equivalence")``."""
    if cfg is None:
        cfg = BuildConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = _as_model(model, domain=cfg.domain)
    tr = get_tracer()
    with tr.span("flow:build", model=model.name, domain=cfg.domain,
                 steps=len(cfg.steps), verify=cfg.verify):
        return _run_flow(model, cfg)


def _run_flow(model: SiraModel, cfg: BuildConfig) -> BuildResult:
    tr = get_tracer()
    reports: List[StepReport] = []
    if cfg.lint != "off":
        from .passes import LintGraph
        t0 = time.perf_counter()
        with tr.span("step:lint_graph", pre_flow=True):
            model, _ = LintGraph(strict=cfg.lint == "strict").apply(model)
        rep = model.metadata.get("lint")
        reports.append(StepReport(
            name="lint_graph", modified=False,
            seconds=time.perf_counter() - t0, analysis_calls=0,
            note=rep.summary() if rep is not None else ""))

    # reference data for per-step equivalence verification
    want_equiv = cfg.verify in ("equivalence", "full")
    want_contain = cfg.verify in ("containment", "full")
    ref_feeds: List[Dict[str, np.ndarray]] = []
    ref_outs: List[List[np.ndarray]] = []   # per feed, per graph output
    if want_equiv or want_contain:
        try:
            ref_feeds = list(model.sample_inputs(
                rng=np.random.default_rng(cfg.seed), n=cfg.verify_samples))
        except ValueError as e:
            # the user explicitly asked for verification — don't silently
            # run an unverified flow
            raise ValueError(
                f"verify={cfg.verify!r} needs sample inputs, but none can "
                f"be drawn ({e}); wrap the graph in a SiraModel with "
                f"metadata['input_shape'] set, or use verify='none'")
    if want_equiv:
        # outputs are compared positionally: passes may rename output
        # tensors (e.g. aggregation appends a Mul/Add stage) but never
        # reorder them
        for f in ref_feeds:
            outs = model.execute(f)
            ref_outs.append([outs[o] for o in model.graph.outputs])

    for step in cfg.steps:
        tx = resolve_step(step, cfg)
        calls0 = _prop.analysis_calls()
        t0 = time.perf_counter()
        # A raising step still closes its span (with an ``error`` attr
        # and partial analysis-call count), so a failed flow produces a
        # usable trace up to and including the failing step.
        with tr.span(f"step:{tx.name}") as sp:
            try:
                model, modified = tx.apply(model)
                sp.set_attr("modified", modified)
                note = ""
                if modified and ref_feeds:
                    if want_equiv:
                        for feeds, expect in zip(ref_feeds, ref_outs):
                            got = model.execute(feeds)
                            for out_name, val in zip(
                                    model.graph.outputs, expect):
                                np.testing.assert_allclose(
                                    got[out_name], val, rtol=1e-9,
                                    atol=1e-9,
                                    err_msg=f"step {tx.name} broke "
                                            f"equivalence")
                        note = "equivalence ok"
                    if want_contain:
                        rep = _verify_ranges(model.graph, model.ranges,
                                             ref_feeds)
                        if not rep.contained:
                            raise AssertionError(
                                f"step {tx.name} broke containment: "
                                f"{rep.violations[:3]}")
                        note = (note + "; " if note else "") + \
                            "containment ok"
            finally:
                sp.set_attr("analysis_calls",
                            _prop.analysis_calls() - calls0)
        seconds = sp.dur_s if getattr(sp, "dur_s", None) is not None \
            else time.perf_counter() - t0
        reports.append(StepReport(
            name=tx.name, modified=modified, seconds=seconds,
            analysis_calls=_prop.analysis_calls() - calls0, note=note))
    return BuildResult(model=model, steps=reports)
