"""Serving subsystem: continuous batching over a SIRA-quantized paged KV
cache.  Counterpart of ``src/repro/serve/``; the engine takes the model
alone (``ServingEngine(model, ServingConfig(...))``: the port's ``Model``
carries its weights) and serves on the model's device.  Public API:

* ``ServingConfig`` — validated engine configuration (slots, cache
  geometry, quantized KV, speculation, prefix caching).
* ``ServingEngine`` — chunked prefill + batched decode, per-request
  sampling; paged mode with a static-batch fallback.
* ``Request`` — prompt, max_new_tokens, temperature, eos_id.
* ``Scheduler`` — FIFO admission, slot/page bookkeeping, termination,
  preemption.
* ``PagedKVCache`` / ``KVCacheSpec`` / ``derive_kv_spec`` — paged pool
  with per-layer int8 scales from SIRA range analysis (fp fallback),
  copy-on-write prefix sharing (``PrefixIndex``, refcounts, reuse LRU).
* ``ServingMetrics`` — TTFT, token latency, tokens/s, slot occupancy,
  speculative acceptance rate / tokens-per-step, prefix hit rate,
  latency percentiles.
* ``DraftProposer`` / ``NgramDrafter`` — draft proposers for speculative
  decoding (``ServingConfig(spec_decode="ngram", spec_k=4)``).
"""
from .config import ServingConfig                              # noqa: F401
from .draft import (DraftProposer, FixedDrafter,               # noqa: F401
                    NgramDrafter, get_drafter)
from .engine import ServingEngine                              # noqa: F401
from .scheduler import Request, Scheduler                      # noqa: F401
from .kv_cache import (PagedKVCache, KVCacheSpec, LayerKVSpec,  # noqa: F401
                       PrefixIndex, derive_kv_spec,
                       observe_block_inputs)
from .metrics import ServingMetrics                            # noqa: F401
