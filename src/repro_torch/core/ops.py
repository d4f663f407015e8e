"""Unified per-op registry (one ``OpDef`` per op type).

Historically the repo kept three disjoint registries that all had to be
edited to teach the system a new op:

  * ``graph.EXEC_REGISTRY``        — numpy executor
  * ``propagate.PROP_REGISTRY``    — SIRA range-propagation handler
  * ``costmodel.ELEMENTWISE_COEFFS`` — analytical LUT coefficients

They are now *views* over a single ``OP_REGISTRY`` of :class:`OpDef`
records, so registering an op is one declaration:

    register_op("MyOp", execute=my_exec, propagate=my_prop,
                cost=dict(alpha=1.0, beta=10))

The legacy dict names keep working (both reads and writes), so existing
``EXEC_REGISTRY["X"] = fn`` style code and the ``@executor`` /
``@handler`` decorators are unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

from collections.abc import MutableMapping


@dataclasses.dataclass
class OpDef:
    """Everything the system knows about one op type."""
    op_type: str
    execute: Optional[Callable] = None      # (node, *arrays) -> array(s)
    propagate: Optional[Callable] = None    # (node, graph, ranges) -> range(s)
    # affine-domain transfer: (node, graph, forms, ranges) -> form(s);
    # ops without one fall back to a fresh form over the interval result
    affine: Optional[Callable] = None
    # monotonicity transfer: (node, graph, lo, hi) -> MonotoneStep | None;
    # consumed by core.monotone to certify layer-tail threshold conversion
    monotone: Optional[Callable] = None
    cost: Optional[Dict[str, float]] = None  # analytical LUT coefficients
    # free-form metadata (e.g. is_nonlinear, absorbable) for transform passes
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


OP_REGISTRY: Dict[str, OpDef] = {}


def _ensure(op_type: str) -> OpDef:
    d = OP_REGISTRY.get(op_type)
    if d is None:
        d = OpDef(op_type)
        OP_REGISTRY[op_type] = d
    return d


def register_op(op_type: str,
                execute: Optional[Callable] = None,
                propagate: Optional[Callable] = None,
                affine: Optional[Callable] = None,
                monotone: Optional[Callable] = None,
                cost: Optional[Dict[str, float]] = None,
                **attrs) -> OpDef:
    """Register (or extend) the definition of one op type.

    Fields that are ``None`` leave any previous registration untouched, so
    executors / propagation handlers / cost models may be contributed from
    separate modules but land in the same record."""
    d = _ensure(op_type)
    if execute is not None:
        d.execute = execute
    if propagate is not None:
        d.propagate = propagate
    if affine is not None:
        d.affine = affine
    if monotone is not None:
        d.monotone = monotone
    if cost is not None:
        d.cost = dict(cost)
    if attrs:
        d.attrs.update(attrs)
    return d


def get_op(op_type: str) -> Optional[OpDef]:
    return OP_REGISTRY.get(op_type)


class RegistryView(MutableMapping):
    """Dict-like facade exposing one field of every ``OpDef``.

    ``view[op]`` raises ``KeyError`` when the op exists but the field is
    unset, so it behaves exactly like the legacy per-field dicts."""

    def __init__(self, field: str):
        self._field = field

    def __getitem__(self, op_type: str):
        d = OP_REGISTRY.get(op_type)
        v = getattr(d, self._field) if d is not None else None
        if v is None:
            raise KeyError(op_type)
        return v

    def __setitem__(self, op_type: str, value) -> None:
        register_op(op_type, **{self._field: value})

    def __delitem__(self, op_type: str) -> None:
        d = OP_REGISTRY.get(op_type)
        if d is None or getattr(d, self._field) is None:
            raise KeyError(op_type)
        setattr(d, self._field, None)

    def __iter__(self) -> Iterator[str]:
        return (op for op, d in OP_REGISTRY.items()
                if getattr(d, self._field) is not None)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"RegistryView({self._field!r}, ops={sorted(self)})"


# legacy-compatible views (imported by graph.py / propagate.py / costmodel.py)
EXEC_REGISTRY = RegistryView("execute")
PROP_REGISTRY = RegistryView("propagate")
AFFINE_REGISTRY = RegistryView("affine")
MONOTONE_REGISTRY = RegistryView("monotone")
COST_REGISTRY = RegistryView("cost")

# Table 4 analytical LUT coefficients (LUT = alpha * f(n_i, n_p) * PE +
# beta), registered here — where the unified registry lives — so that
# repro_torch.core never has to import its consumer subsystem
# (repro_torch.dataflow.costmodel) for the side effect.  "ToInt" and "Max" are
# meta-kernel styles rather than graph op types, registered cost-only.
register_op("Mul", cost=dict(alpha=1.18, beta=124))
register_op("Add", cost=dict(alpha=2.0, beta=24))
register_op("ToInt", cost=dict(alpha=4.2, beta=13))
register_op("Max", cost=dict(alpha=4.0, beta=21))
# Elementwise meta-kernel (FINN PR #1040 shape): a generic per-channel
# lookup/evaluation unit pricing layer tails that the monotonicity
# certifier could not convert to thresholds.  LUT = alpha*n_i*n_o*PE +
# beta plus per-channel parameter memory; coefficients follow the Table-4
# fitting style (beyond-paper, calibrated against the Mul/Add entries so
# a meta-kernel is strictly costlier than a same-width multiplier).
register_op("MetaKernel", cost=dict(alpha=2.6, beta=180))
