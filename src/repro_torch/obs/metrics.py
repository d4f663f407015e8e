"""Typed metrics: Counter / Gauge / Histogram registry with labels and
Prometheus text-format + JSON export.

One consistent metrics pipeline for every layer (the Ducasse et al. FINN
benchmarking lesson — reproducible cross-workload measurement needs a
single substrate): ``serve.metrics.ServingMetrics`` is a facade over a
registry from this module, and the ``benchmarks/bench_*.py`` artifacts
are routed through :func:`export_bench`, so the same numbers that land
in ``BENCH_*.json`` are scrapeable as Prometheus text.

    reg = MetricsRegistry()
    hits = reg.counter("cache_hits_total", "range-cache hits",
                       labels=("domain",))
    hits.labels(domain="interval").inc()
    print(reg.to_prometheus())

Stdlib-only by design.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence
from typing import Tuple, Union

Number = Union[int, float]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds-ish; override per histogram)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral floats render as ints."""
    if v != v:
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += n

    def set(self, v: Number) -> None:
        self.value = float(v)

    def dec(self, n: Number = 1) -> None:
        self.value -= n


class _HistChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: Number) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Metric:
    """A named metric family; label() it to get a settable child."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for lbl in labels:
            if not _LABEL_RE.match(lbl):
                raise ValueError(f"invalid label name {lbl!r}")
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _new_child(self) -> Any:
        return _Child()

    def labels(self, **kv: Any) -> Any:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[name]) for name in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._new_child()
            self._children[key] = child
        return child

    def _default_child(self) -> Any:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.label_names}; "
                f"call .labels(...) first")
        return self.labels()

    @property
    def children(self) -> Dict[Tuple[str, ...], Any]:
        return self._children

    def _series(self, key: Tuple[str, ...]) -> str:
        if not key:
            return self.name
        pairs = ",".join(f'{n}="{_escape(v)}"'
                         for n, v in zip(self.label_names, key))
        return f"{self.name}{{{pairs}}}"


class Counter(Metric):
    kind = "counter"

    def inc(self, n: Number = 1) -> None:
        self._default_child().inc(n)

    @property
    def value(self) -> float:
        child = self._children.get(())
        return child.value if child is not None else 0.0


class Gauge(Metric):
    kind = "gauge"

    def set(self, v: Number) -> None:
        self._default_child().set(v)

    def inc(self, n: Number = 1) -> None:
        self._default_child().value += n

    def dec(self, n: Number = 1) -> None:
        self._default_child().value -= n

    @property
    def value(self) -> float:
        child = self._children.get(())
        return child.value if child is not None else 0.0


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs

    def _new_child(self) -> Any:
        return _HistChild(self.buckets)

    def observe(self, v: Number) -> None:
        self._default_child().observe(v)

    @property
    def sum(self) -> float:
        child = self._children.get(())
        return child.sum if child is not None else 0.0

    @property
    def count(self) -> int:
        child = self._children.get(())
        return child.count if child is not None else 0


class MetricsRegistry:
    """Create-or-get metric families; export Prometheus text / JSON."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _register(self, cls: type, name: str, help: str,
                  labels: Sequence[str], **kw: Any) -> Any:
        existing = self._metrics.get(name)
        if existing is not None:
            if not isinstance(existing, cls) or \
                    existing.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind} with labels "
                    f"{existing.label_names}")
            return existing
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def collect(self) -> Iterable[Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    # -------------------------------------------------------------- export
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        for m in self.collect():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in sorted(m.children):
                child = m.children[key]
                if isinstance(child, _HistChild):
                    cum = 0
                    base = m._series(key)
                    for b, c in zip(m.buckets, child.counts):  # type: ignore[attr-defined]
                        cum += c
                        if base.endswith("}"):
                            series = (base[:-1] +
                                      f',le="{_fmt(b)}"}}')
                        else:
                            series = base + f'{{le="{_fmt(b)}"}}'
                        lines.append(f"{m.name}_bucket"
                                     f"{series[len(m.name):]} {cum}")
                    inf = (base[:-1] + ',le="+Inf"}') if \
                        base.endswith("}") else base + '{le="+Inf"}'
                    lines.append(f"{m.name}_bucket"
                                 f"{inf[len(m.name):]} {child.count}")
                    lines.append(f"{m.name}_sum{base[len(m.name):]} "
                                 f"{_fmt(child.sum)}")
                    lines.append(f"{m.name}_count{base[len(m.name):]} "
                                 f"{child.count}")
                else:
                    lines.append(f"{m._series(key)} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        """JSON export: ``{name: {type, help, samples: [...]}}``."""
        out: Dict[str, Any] = {}
        for m in self.collect():
            samples: List[Dict[str, Any]] = []
            for key in sorted(m.children):
                child = m.children[key]
                labels = dict(zip(m.label_names, key))
                if isinstance(child, _HistChild):
                    samples.append(dict(labels=labels, sum=child.sum,
                                        count=child.count,
                                        buckets=dict(zip(
                                            map(_fmt, child.buckets),
                                            child.counts[:-1])),
                                        inf=child.counts[-1]))
                else:
                    samples.append(dict(labels=labels, value=child.value))
            out[m.name] = dict(type=m.kind, help=m.help, samples=samples)
        return out


# --------------------------------------------------------------------------
# process-global default registry
# --------------------------------------------------------------------------

_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _default
    _default = reg
    return reg


# --------------------------------------------------------------------------
# benchmark artifact export
# --------------------------------------------------------------------------

def _metric_name(prefix: str, key: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9_]", "_", f"{prefix}_{key}")
    return name if _NAME_RE.match(name) else f"m_{name}"


def export_bench(payload: Mapping[str, Any], json_path: str,
                 prom_path: Optional[str] = None,
                 key: Sequence[str] = ("workload",),
                 registry: Optional[MetricsRegistry] = None
                 ) -> MetricsRegistry:
    """Route a ``BENCH_*.json`` payload through a metrics registry.

    Every numeric metric of every result row becomes a labeled gauge
    (labels = the row's ``key`` fields), then the registry is exported
    as Prometheus text next to the JSON artifact — the same numbers the
    CI gate (``scripts/check_bench.py``) diffs are scrapeable.  The JSON
    schema is unchanged (baselines stay valid); a self-check asserts the
    JSON and registry views agree before anything is written.
    """
    reg = registry if registry is not None else MetricsRegistry()
    prefix = _metric_name("bench", str(json_path).rsplit("/", 1)[-1]
                          .removeprefix("BENCH_").removesuffix(".json"))
    rows = payload.get("results", [])
    label_names = tuple(re.sub(r"[^a-zA-Z0-9_]", "_", k) for k in key)
    for row in rows:
        labels = {ln: str(row.get(k)) for ln, k in zip(label_names, key)}
        for k, v in row.items():
            if k in key or isinstance(v, bool) or \
                    not isinstance(v, (int, float)):
                continue
            g = reg.gauge(_metric_name(prefix, k),
                          f"{k} from {json_path}", labels=label_names)
            g.labels(**labels).set(float(v))
    # self-check: the registry must reproduce the JSON numbers exactly
    for row in rows:
        labels = {ln: str(row.get(k)) for ln, k in zip(label_names, key)}
        for k, v in row.items():
            if k in key or isinstance(v, bool) or \
                    not isinstance(v, (int, float)):
                continue
            child = reg.gauge(_metric_name(prefix, k),
                              labels=label_names).labels(**labels)
            if child.value != float(v):
                raise AssertionError(
                    f"registry/JSON divergence on {k} of {labels}")
    with open(json_path, "w") as fh:
        json.dump(payload, fh, indent=2)
    if prom_path is None:
        prom_path = str(json_path).removesuffix(".json") + ".prom"
    with open(prom_path, "w") as fh:
        fh.write(reg.to_prometheus())
    return reg


__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "DEFAULT_BUCKETS", "get_registry", "set_registry",
           "export_bench"]
