"""Validated serving configuration.

Counterpart of ``src/repro/serve/config.py``: the same fields, the same
validation and the same error types.  ``mesh`` takes the port's
``launch.mesh.Layout`` where the reference takes a ``jax`` mesh, and any
other value raises ``ValueError``, as there.

``ServingConfig`` consolidates the engine's construction knobs — slot
count, cache geometry, quantized-KV selection, speculative decoding and
prefix caching — into one frozen dataclass validated at construction, so
a bad combination fails at config time with a message naming the field,
not deep inside the first model step.

    from repro_torch.serve import ServingConfig, ServingEngine
    cfg = ServingConfig(batch_slots=16, max_seq=64, kv_cache="sira-int8",
                        prefix_cache=True)
    eng = ServingEngine(model, cfg)

The legacy loose-kwarg constructor (``ServingEngine(model, batch_slots=2,
max_seq=64, page_size=8, ...)``) still works via a shim that builds a
``ServingConfig`` and emits a single ``DeprecationWarning``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from ..quant.quantizer import QuantSpec
from .kv_cache import KVCacheSpec

_MODES = (None, "paged", "static")
_KV_STRINGS = ("fp", "sira-int8", "int8")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything ``ServingEngine`` needs beyond the model.

    Engine shape:

    * ``batch_slots`` — concurrent decode slots (the batch dimension).
    * ``max_seq`` — per-request prompt + generation budget.
    * ``mode`` — None (auto: paged wherever ``model.supports_paged``),
      "paged", or "static".

    Cache:

    * ``kv_cache`` — "fp", "sira-int8" (scales derived at engine
      construction), or a prebuilt :class:`KVCacheSpec`.
    * ``page_size`` / ``num_pages`` — pool geometry (num_pages=None sizes
      for the worst case: every slot full, plus the trash page).
    * ``prefix_cache`` — copy-on-write prompt-prefix sharing: full prompt
      pages are content-hashed and reused across requests (refcounted,
      fork-on-write), and pages released by finished requests are kept in
      an LRU so repeat traffic skips prefill for the shared head.

    Sampling / speculation:

    * ``quant`` — activation fake-quant spec threaded into every model
      step (weights come quantized inside the model's params).
    * ``seed`` — engine sampling seed (each sampled token's noise is keyed
      on (seed, request_id, token index)).
    * ``spec_decode`` / ``spec_k`` — draft proposer (name or instance)
      and max drafts verified per step.

    Scale-out:

    * ``mesh`` — a ``launch.mesh.Layout`` (bound to the job's ranks):
      tensor-parallel serving over its "model" axis, every rank running
      the same host code on the same requests; or None.
    """
    batch_slots: int
    max_seq: int
    quant: Optional[QuantSpec] = None
    seed: int = 0
    kv_cache: Union[str, KVCacheSpec] = "fp"
    page_size: int = 8
    prefill_chunk: int = 8
    num_pages: Optional[int] = None
    mode: Optional[str] = None
    spec_decode: Any = None
    spec_k: int = 4
    prefix_cache: bool = False
    mesh: Any = None

    def __post_init__(self) -> None:
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.max_seq < 1:
            raise ValueError("max_seq must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if not isinstance(self.kv_cache, KVCacheSpec) and \
                self.kv_cache not in _KV_STRINGS:
            raise ValueError(
                f"kv_cache must be one of {_KV_STRINGS} or a KVCacheSpec, "
                f"got {self.kv_cache!r}")
        if self.num_pages is not None and self.num_pages < 2:
            raise ValueError("num_pages must leave room for the trash "
                             "page plus at least one real page")
        if self.mode == "static":
            if self.kv_cache != "fp":
                raise ValueError(
                    "static mode serves a full-precision cache — a "
                    "quantized kv_cache would be silently ignored")
            if self.prefix_cache:
                raise ValueError(
                    "prefix_cache requires paged mode (the static engine "
                    "has no page table to share)")
        if self.mesh is not None:
            from ..launch.mesh import Layout
            if not isinstance(self.mesh, Layout):
                raise ValueError("mesh must be a repro_torch.launch.mesh."
                                 "Layout")

    def replace(self, **kw) -> "ServingConfig":
        return dataclasses.replace(self, **kw)
