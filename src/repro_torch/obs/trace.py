"""Tracing: nested spans, counters, Chrome ``trace_event`` JSON export.

A :class:`Tracer` records *spans* (named, nested, attributed wall-clock
intervals) and *counters* (monotonic named tallies).  The process-global
default tracer (:func:`get_tracer`) is **disabled** until
:func:`enable_tracing` is called: a disabled tracer's ``span()`` returns
a shared no-op singleton and ``count()`` returns after one flag check,
so instrumented hot paths (the compiled backend dispatch, the serving
decode loop) pay nothing measurable — ``bench_backend.py`` gates the
enabled-tracer overhead on the compiled TFC path under 5%.

Export is the Chrome ``trace_event`` JSON format (the ``traceEvents``
array of ``"ph": "X"`` complete events and ``"ph": "C"`` counter
events), loadable in Perfetto or ``chrome://tracing``:

    from repro_torch.obs.trace import enable_tracing, get_tracer
    tracer = enable_tracing()
    result = build_flow(make_cnv())        # spans recorded
    tracer.write_chrome_trace("out.json")

Everything here is stdlib-only by design — the observability layer must
never constrain what it observes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

Number = Union[int, float]

#: ``ph`` values this module emits (and :func:`validate_chrome_trace`
#: accepts): complete spans, counter samples, metadata.
_PHASES = ("X", "C", "M")


@dataclasses.dataclass
class SpanRecord:
    """One finished span, in completion order (children before parents)."""
    name: str
    ts_us: float               # start, microseconds since tracer epoch
    dur_us: float
    depth: int                 # nesting depth at entry (0 = top level)
    tid: int
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _NullSpan:
    """Shared no-op span — what a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set_attr(self, key: str, value: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one span on exit.  An exception
    propagating through the span closes it with an ``error`` attr — a
    failed build flow still produces a usable trace."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth", "dur_s")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._depth = 0
        self.dur_s: Optional[float] = None   # set on exit

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = self._tracer.clock()
        self._tracer._touch_epoch(self._t0)
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        t1 = self._tracer.clock()
        self.dur_s = t1 - self._t0
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self, t1)
        return None


class Tracer:
    """Span + counter recorder with Chrome ``trace_event`` export.

    ``clock`` is injectable (seconds, monotonic) so tests can drive
    deterministic time; the epoch is the first clock sample so exported
    timestamps start near zero.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.spans: List[SpanRecord] = []      # completion order
        self.counters: Dict[str, float] = {}   # cumulative totals
        self._counter_events: List[Dict[str, Any]] = []
        self._epoch: Optional[float] = None
        self._local = threading.local()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording
    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _touch_epoch(self, t: float) -> None:
        """Anchor exported timestamps at the earliest sample seen."""
        with self._lock:
            if self._epoch is None or t < self._epoch:
                self._epoch = t

    def _us(self, t: float) -> float:
        if self._epoch is None:
            self._epoch = t
        return (t - self._epoch) * 1e6

    def span(self, name: str, **attrs: Any) -> Union[_Span, _NullSpan]:
        """Start a nested span; use as a context manager.  Disabled
        tracers return the shared :data:`NULL_SPAN` singleton."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs)

    def count(self, name: str, n: Number = 1, **attrs: Any) -> None:
        """Bump a named counter (one Chrome ``"ph": "C"`` sample per
        call; ``attrs`` land in the sample's ``args``)."""
        if not self.enabled:
            return
        t = self.clock()
        with self._lock:
            total = self.counters.get(name, 0.0) + n
            self.counters[name] = total
            ev: Dict[str, Any] = dict(
                name=name, ph="C", ts=self._us(t), pid=os.getpid(),
                tid=threading.get_ident() & 0xFFFF,
                args={name: total, **attrs})
            self._counter_events.append(ev)

    def set_attr(self, key: str, value: Any) -> None:
        """Attach an attribute to the innermost open span (no-op when
        disabled or outside any span)."""
        stack = self._stack()
        if stack:
            stack[-1].set_attr(key, value)

    def _record(self, span: _Span, t1: float) -> None:
        with self._lock:
            self.spans.append(SpanRecord(
                name=span.name, ts_us=self._us(span._t0),
                dur_us=(t1 - span._t0) * 1e6, depth=span._depth,
                tid=threading.get_ident() & 0xFFFF, attrs=span.attrs))

    # -------------------------------------------------------------- export
    def to_chrome_json(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` payload (Perfetto-loadable)."""
        events: List[Dict[str, Any]] = [dict(
            name="process_name", ph="M", ts=0.0, pid=os.getpid(), tid=0,
            args={"name": "sira"})]
        with self._lock:
            for s in self.spans:
                ev: Dict[str, Any] = dict(
                    name=s.name, ph="X", ts=s.ts_us, dur=s.dur_us,
                    pid=os.getpid(), tid=s.tid)
                if s.attrs:
                    ev["args"] = _jsonable(s.attrs)
                events.append(ev)
            events.extend(self._counter_events)
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        payload = self.to_chrome_json()
        validate_chrome_trace(payload)
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1)

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self._counter_events.clear()
            self._epoch = None


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


# --------------------------------------------------------------------------
# process-global default tracer
# --------------------------------------------------------------------------

_default = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer all in-repo instrumentation reports to.
    Disabled (no-op) until :func:`enable_tracing`."""
    return _default


def set_tracer(tracer: Tracer) -> Tracer:
    global _default
    _default = tracer
    return tracer


def enable_tracing(clock: Callable[[], float] = time.perf_counter
                   ) -> Tracer:
    """Install (and return) a fresh enabled global tracer."""
    return set_tracer(Tracer(enabled=True, clock=clock))


def disable_tracing() -> None:
    """Restore the no-op global tracer (records are dropped)."""
    set_tracer(Tracer(enabled=False))


# --------------------------------------------------------------------------
# Chrome trace_event schema validation (CI smoke / tests)
# --------------------------------------------------------------------------

def validate_chrome_trace(payload: Any) -> None:
    """Validate the subset of the Chrome ``trace_event`` schema this
    module emits; raises ``ValueError`` with the offending event on
    violation.  Used by the tier-1 tracing smoke test and by
    ``write_chrome_trace`` itself, so an exported trace is guaranteed
    loadable."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError("trace payload must be an object with a "
                         "'traceEvents' array")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be an array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event #{i} is not an object: {ev!r}")
        for field, types in (("name", str), ("ph", str),
                             ("ts", (int, float)), ("pid", int),
                             ("tid", int)):
            if not isinstance(ev.get(field), types):
                raise ValueError(
                    f"event #{i} field {field!r} missing or mistyped: "
                    f"{ev!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event #{i} has unknown phase {ph!r}")
        if ev["ts"] < 0:
            raise ValueError(f"event #{i} has negative ts: {ev!r}")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                raise ValueError(
                    f"complete event #{i} needs a non-negative 'dur': "
                    f"{ev!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(
                    f"counter event #{i} needs a non-empty 'args': {ev!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event #{i} 'args' must be an object")


__all__ = ["Tracer", "SpanRecord", "NULL_SPAN", "get_tracer",
           "set_tracer", "enable_tracing", "disable_tracing",
           "validate_chrome_trace"]
