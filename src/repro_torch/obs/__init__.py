"""Unified observability: tracing, metrics, and range provenance.

Three zero-dependency (stdlib-only) pillars threaded through every layer
of the repo — the FINN-R lesson that a dataflow-DSE framework lives or
dies on the quality of its per-stage reports:

* :mod:`repro_torch.obs.trace` — nested spans + counters with Chrome
  ``trace_event`` JSON export (Perfetto / ``chrome://tracing``).  A
  process-global default tracer is a no-op until enabled, so the
  instrumentation in ``core/flow.py``, ``core/propagate.py``,
  ``core/lower.py``, ``serve/engine.py`` and ``dataflow/folding.py``
  costs one flag check when disabled.
* :mod:`repro_torch.obs.metrics` — typed Counter / Gauge / Histogram registry
  with label support and Prometheus text-format + JSON export; the
  serving metrics and every ``BENCH_*.json`` flow through it.
* :mod:`repro_torch.obs.explain` — per-tensor range provenance: which op
  handler and abstract domain produced the final bounds and which input
  interval was the widening culprit (``SiraModel.explain(tensor)``).
"""
from .trace import (Tracer, SpanRecord, NULL_SPAN,          # noqa: F401
                    get_tracer, set_tracer,
                    enable_tracing, disable_tracing,
                    validate_chrome_trace)
from .metrics import (Counter, Gauge, Histogram,            # noqa: F401
                      MetricsRegistry, get_registry, set_registry,
                      export_bench)
from .explain import (RangeProvenance, ProvenanceChain,     # noqa: F401
                      build_chain)
