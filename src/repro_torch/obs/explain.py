"""Range provenance: why does a tensor have the bounds it has?

During :func:`repro_torch.core.propagate.analyze` every tensor's final range
is attributed to the op handler and abstract domain that produced it,
together with the *widening culprit* — the dynamic input whose interval
was widest and therefore dominated the output width.  The per-tensor
records form a chain back to a graph input:

    chain = model.explain("b0c0_mm")
    print(chain.render())

turning "the CNV accumulator is 58 bits, why?" from print-debugging
archaeology into one call (``examples/sira_report.py --explain``).

Stdlib-only; records are plain dataclasses built by the propagation
loop, not recomputed here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RangeProvenance:
    """How one tensor's final range came to be."""
    tensor: str
    node_name: str               # producing node ("" for graph seeds)
    op_type: str                 # "MatMul", ... ("input"/"const" seeds)
    handler: str                 # registry handler name that ran
    domain: str                  # "interval" | "affine"
    affine_tightened: bool       # affine hull strictly narrowed interval
    inputs: Tuple[str, ...]      # dynamic (non-constant) input tensors
    culprit: Optional[str]       # widest dynamic input, None for seeds
    width: float                 # max elementwise width of this range
    in_widths: Dict[str, float]  # width per dynamic input
    bits: Optional[int]          # required_signed_bits if scaled-int
    range_str: str               # human-readable "[lo, hi]" summary

    def describe(self) -> str:
        dom = self.domain + ("+affine-tightened" if self.affine_tightened
                             else "")
        bits = f", {self.bits} bits" if self.bits is not None else ""
        line = (f"{self.tensor}: {self.range_str} (width {self.width:g}"
                f"{bits}) <- {self.op_type}"
                f"[{self.handler}] @ {self.node_name or '<seed>'} "
                f"({dom})")
        if self.culprit is not None:
            line += f"; widened by {self.culprit}"
        return line


@dataclasses.dataclass(frozen=True)
class ProvenanceChain:
    """Culprit-linked walk from a tensor back to a graph seed."""
    tensor: str
    entries: Tuple[RangeProvenance, ...]

    def render(self) -> str:
        lines = [f"provenance of {self.tensor!r} "
                 f"({len(self.entries)} links):"]
        for i, e in enumerate(self.entries):
            lines.append("  " * i + ("`- " if i else "") + e.describe())
        return "\n".join(lines)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)


def build_chain(tensor: str,
                provenance: Mapping[str, RangeProvenance],
                max_depth: int = 32) -> ProvenanceChain:
    """Follow widening-culprit links from ``tensor`` back to a seed.

    Stops at graph inputs/initializers (no culprit), on cycles, on
    tensors with no record, or after ``max_depth`` links.
    """
    if tensor not in provenance:
        known = ", ".join(sorted(provenance)[:8])
        raise KeyError(
            f"no provenance recorded for {tensor!r}; known tensors "
            f"include: {known} ... (run analysis first)")
    entries: List[RangeProvenance] = []
    seen = set()
    cur: Optional[str] = tensor
    while cur is not None and cur not in seen and \
            len(entries) < max_depth:
        seen.add(cur)
        rec = provenance.get(cur)
        if rec is None:
            break
        entries.append(rec)
        cur = rec.culprit
    return ProvenanceChain(tensor=tensor, entries=tuple(entries))


__all__ = ["RangeProvenance", "ProvenanceChain", "build_chain"]
