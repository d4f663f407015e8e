"""``SiraModel`` — the unit of work of the transformation pipeline.

A ``SiraModel`` bundles a :class:`~repro_torch.core.graph.Graph` with the input
ranges SIRA needs and a **cached** range analysis that is invalidated only
by graph mutation.  This mirrors the QONNX ``ModelWrapper`` + shared
``range_analysis`` design the paper ships SIRA as: many transformations
consume one analysis through a single entry point, so a pipeline of N
read-only passes performs O(1) full propagations instead of O(N).

Cache contract
--------------
``Graph`` bumps a monotonic ``version`` on every structural edit made
through its API (``add_node``/``add_initializer``/``remove_node``/
``nodes``-assignment/``replace_input``).  ``SiraModel.ranges`` recomputes
iff the cached ``graph.cache_key`` (version, node count) differs — the
node count also catches raw ``graph.nodes.append/remove`` mutations that
bypass the API.  Code that edits ``node.inputs``, ``node.outputs`` or
initializer *values* in place must call ``graph.touch()`` (all in-repo
passes do).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph
from .intervals import ScaledIntRange
from .propagate import analyze
from ..obs.explain import ProvenanceChain, RangeProvenance, build_chain
from ..obs.trace import get_tracer


class SiraModel:
    """Graph + input ranges + cached SIRA analysis + pass artifacts."""

    def __init__(self, graph: Graph,
                 input_ranges: Dict[str, ScaledIntRange],
                 name: str = "",
                 metadata: Optional[Dict[str, Any]] = None,
                 domain: str = "interval"):
        self.graph = graph
        self.input_ranges: Dict[str, ScaledIntRange] = dict(input_ranges)
        self.name = name
        # abstract domain for the cached analysis: "interval" (paper) or
        # "affine" (zonotope reduced product — see repro_torch.core.affine)
        self.domain = domain
        # free-form artifact store written by passes (threshold specs,
        # accumulator reports, verification reports, ...)
        self.metadata: Dict[str, Any] = dict(metadata or {})
        self._ranges: Optional[Dict[str, ScaledIntRange]] = None
        self._cache_version: Optional[Tuple[int, int]] = None
        self._provenance: Optional[Dict[str, RangeProvenance]] = None

    # ------------------------------------------------------------ construct
    @classmethod
    def from_workload(cls, wl, domain: str = "interval") -> "SiraModel":
        """Wrap a :class:`~repro_torch.core.workloads.QNNWorkload` (graph copied,
        so the workload object stays pristine)."""
        return cls(wl.graph.copy(), wl.input_range, name=wl.name,
                   metadata=dict(input_shape=wl.input_shape,
                                 weight_bits=wl.weight_bits,
                                 act_bits=wl.act_bits),
                   domain=domain)

    def copy(self) -> "SiraModel":
        m = SiraModel(self.graph.copy(), self.input_ranges, name=self.name,
                      metadata=dict(self.metadata), domain=self.domain)
        if self._ranges is not None and \
                self._cache_version == self.graph.cache_key:
            # graph.copy() is semantics-preserving → the analysis carries over
            m._ranges = self._ranges
            m._cache_version = m.graph.cache_key
            m._provenance = self._provenance
        return m

    # -------------------------------------------------------------- analysis
    @property
    def ranges(self) -> Dict[str, ScaledIntRange]:
        """Cached ``{tensor: ScaledIntRange}`` — recomputed only when the
        graph has been mutated since the last analysis."""
        if self._ranges is None or \
                self._cache_version != self.graph.cache_key:
            get_tracer().count("range_cache.miss",
                               graph_version=self.graph.version,
                               model=self.name)
            record: Dict[str, RangeProvenance] = {}
            self._ranges = analyze(self.graph, self.input_ranges,
                                   domain=self.domain, record=record)
            self._provenance = record
            # analyze() toposorts, which may bump the version once
            self._cache_version = self.graph.cache_key
        else:
            get_tracer().count("range_cache.hit",
                               graph_version=self.graph.version,
                               model=self.name)
        return self._ranges

    def range_of(self, tensor: str) -> Optional[ScaledIntRange]:
        return self.ranges.get(tensor)

    @property
    def analysis_cached(self) -> bool:
        return (self._ranges is not None and
                self._cache_version == self.graph.cache_key)

    def invalidate(self) -> None:
        """Drop the cached analysis (automatic for API-mediated edits)."""
        get_tracer().count("range_cache.invalidate",
                           graph_version=self.graph.version,
                           model=self.name)
        self._ranges = None
        self._cache_version = None
        self._provenance = None

    def explain(self, tensor: str) -> ProvenanceChain:
        """Why does ``tensor`` have the bounds it has?  Returns the
        culprit-linked :class:`~repro_torch.obs.explain.ProvenanceChain` from
        the tensor back to a graph input — which op handler and abstract
        domain produced each range, and which input widened it."""
        self.ranges  # ensure analysis (and its provenance) is current
        assert self._provenance is not None
        return build_chain(tensor, self._provenance)

    @property
    def provenance(self) -> Dict[str, RangeProvenance]:
        """Per-tensor :class:`RangeProvenance` for the cached analysis."""
        self.ranges
        assert self._provenance is not None
        return self._provenance

    # ------------------------------------------------------------- execution
    def execute(self, feeds: Dict[str, np.ndarray],
                want: Optional[Sequence[str]] = None,
                record_all: bool = False) -> Dict[str, np.ndarray]:
        return self.graph.execute(feeds, want=want, record_all=record_all)

    def sample_inputs(self, rng=None, n: int = 1
                      ) -> Iterable[Dict[str, np.ndarray]]:
        """Random feed dicts drawn uniformly from the declared input ranges
        (requires ``input_shape`` metadata, single-input graphs only)."""
        shape = self.metadata.get("input_shape")
        if shape is None or len(self.graph.inputs) != 1:
            raise ValueError("sample_inputs needs metadata['input_shape'] "
                             "and a single graph input")
        rng = np.random.default_rng(0) if rng is None else rng
        (inp,) = self.graph.inputs
        r = self.input_ranges[inp]
        # sample elementwise between the broadcast bounds — collapsing a
        # per-channel range to its global hull would draw out-of-range
        # values and spuriously fail strict verification
        lo = np.broadcast_to(np.asarray(r.lo, dtype=np.float64), shape)
        hi = np.broadcast_to(np.asarray(r.hi, dtype=np.float64), shape)
        for _ in range(n):
            yield {inp: rng.uniform(lo, hi, size=shape)}

    def compile(self, **kwargs) -> "Any":
        """Lower this (optimized) model to an eager PyTorch step list backed
        by the CUDA kernels — see :func:`repro_torch.core.lower.lower` for
        the options (``device=None`` means the card and raises without
        one).  Returns a :class:`CompiledSiraModel`."""
        from .lower import lower as _lower
        return _lower(self, **kwargs)

    # ----------------------------------------------------------- transforms
    def transform(self, *transformations, copy: bool = True) -> "SiraModel":
        """Apply transformations in sequence (each once; wrap one in
        ``.fixpoint()`` for to-convergence application) and return the
        resulting model.  ``copy=True`` (default) leaves ``self`` untouched.
        """
        model = self.copy() if copy else self
        for tx in transformations:
            model, _ = tx.apply(model)
        return model

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        cached = "cached" if self.analysis_cached else "stale"
        return (f"SiraModel({self.name or 'unnamed'}, "
                f"{len(self.graph.nodes)} nodes, analysis={cached})")
