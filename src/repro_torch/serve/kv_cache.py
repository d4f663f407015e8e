"""Paged KV cache with SIRA-derived scaled-integer storage.

Counterpart of ``src/repro/serve/kv_cache.py``, over this package's
``core.propagate.analyze``, ``models.export.export_kv_proj_graph`` and
``quant.calibrate.MinMaxObserver``.  ``derive_kv_spec`` and
``observe_block_inputs`` read the weights from ``model.params``; the page
pools are tensors on the model's device, written in place.

Three parts:

* **Spec derivation** (`derive_kv_spec`): for every attention layer,
  export the K/V projection subgraph with the *actual serving weights*
  (`models.export.export_kv_proj_graph`) and run the SIRA range analysis
  (`core.propagate.analyze`) over it.  The per-output-channel value
  intervals of the K/V tensors reduce to per-KV-head amax bounds (K is
  widened by sqrt(2) for the RoPE rotation hull), giving int8 storage
  scales with a *static coverage guarantee* — saturation can only trigger
  on activations that escape their proven range (A2Q-style, Colbert et
  al. 2023).  A layer falls back to full-precision storage when its bound
  is non-finite or so wide that the int8 step exceeds ``max_step``
  (resolution cliff).  Optionally, per-layer `MinMaxObserver`s
  (`quant.calibrate`) over real token batches tighten the analyzed input
  range from the default post-norm assumption.

* **Page pool** (`PagedKVCache`): fixed pool of physical pages per layer
  (device tensors), a host-side page table (slots x logical pages) and
  free list.  Slots own pages only for the tokens they actually hold;
  finished requests return pages to the pool immediately, which is what
  lets the scheduler admit a queue much deeper than ``batch_slots``
  without sizing device memory for the worst case.  Physical page 0 is
  reserved as the trash page: idle slots' writes land there and it is
  never mapped to a live position.

* **Copy-on-write prefix caching** (``prefix_cache=True``): prompt pages
  are content-addressed in a :class:`PrefixIndex` keyed by the *chain*
  of page token-tuples (a page's identity includes everything before
  it, so position is part of the key and RoPE'd keys stay valid).  A
  new request attaches the longest indexed chain instead of re-running
  prefill over it; attached pages are mapped by multiple slots with
  per-page refcounts.  Pages released by finished requests stay
  resident in an LRU of cached-free pages and are only reclaimed (and
  unindexed) when the free list runs dry — repeat traffic re-attaches
  them for near-zero-TTFT prefill.  Sharing is safe because a slot
  only ever writes at positions >= its own recompute frontier: the
  boundary page (where the new prompt diverges mid-page) is
  copy-on-written into the slot's private page at attach time, and
  ``prepare_write`` forks any other shared page before a write could
  land on it — so a speculative rollback on one request can never
  scribble on a page another request maps.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.lower import resolve_device
from ..core.propagate import analyze
from ..models.common import rms_norm
from ..models.export import export_kv_proj_graph
from ..quant.calibrate import MinMaxObserver
from ..quant.quantizer import QuantSpec

# RoPE rotates channel pairs within a head: |k'| <= sqrt(k1^2 + k2^2)
# <= sqrt(2) * max(|k1|, |k2|), so a per-head pre-rotation amax bound
# widens by sqrt(2) to cover the stored (post-RoPE) keys.
ROPE_HULL = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class LayerKVSpec:
    """Storage decision for one attention layer's KV cache."""
    int8: bool
    k_scale: Optional[np.ndarray] = None    # (KV,) int8 step per head
    v_scale: Optional[np.ndarray] = None
    k_amax: Optional[np.ndarray] = None     # (KV,) proven |K| bound
    v_amax: Optional[np.ndarray] = None
    reason: str = ""                        # why fp fallback, if not int8


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Per-layer storage plan for the paged cache."""
    layers: Tuple[LayerKVSpec, ...]

    @property
    def n_int8(self) -> int:
        return sum(1 for l in self.layers if l.int8)

    def scales(self, device=None) -> List[Optional[Tuple]]:
        """Per-layer (k_scale, v_scale) for ``Model.decode_paged``: numpy
        arrays, or float32 tensors on ``device`` when one is given (a
        serving loop passes those, so no step copies a scale to the card
        and waits for it)."""
        def put(a):
            return a if device is None else torch.as_tensor(
                a, dtype=torch.float32, device=device)
        return [(put(l.k_scale), put(l.v_scale)) if l.int8 else None
                for l in self.layers]

    @staticmethod
    def all_fp(n_layers: int) -> "KVCacheSpec":
        return KVCacheSpec(tuple(LayerKVSpec(int8=False, reason="fp cache")
                                 for _ in range(n_layers)))

    def at_max_step(self, max_step: float) -> "KVCacheSpec":
        """The spec ``derive_kv_spec`` gives for ``max_step`` on the same
        weights and ranges: each layer decided anew from its proven
        bounds (``layer_kv_spec``), with no analysis run again."""
        return KVCacheSpec(tuple(layer_kv_spec(l.k_amax, l.v_amax, max_step)
                                 for l in self.layers))


def layer_kv_spec(k_amax: np.ndarray, v_amax: np.ndarray,
                  max_step: float) -> LayerKVSpec:
    """One layer's decision from its proven per-head |K| and |V| bounds:
    int8 with step amax / 127 per head, or fp where the bound is not
    finite or the step would exceed ``max_step``."""
    worst = float(max(k_amax.max(), v_amax.max()))
    if not np.isfinite(worst):
        return LayerKVSpec(int8=False, k_amax=k_amax, v_amax=v_amax,
                           reason="non-finite SIRA bound")
    if worst / 127.0 > max_step:
        return LayerKVSpec(int8=False, k_amax=k_amax, v_amax=v_amax,
                           reason=f"int8 step {worst / 127.0:.3g} > "
                                  f"max_step {max_step:g}")
    return LayerKVSpec(int8=True,
                       k_scale=np.maximum(k_amax / 127.0, 1e-8),
                       v_scale=np.maximum(v_amax / 127.0, 1e-8),
                       k_amax=k_amax, v_amax=v_amax)


def _float64(w) -> np.ndarray:
    """A weight as a float64 numpy array, dequantizing packed int8."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float64).numpy()
    return _float64(w["q"]) * _float64(w["s"])      # packed {q: int8, s}


def _layer_weights(params, layer: int):
    """(Wk, Wv, bk, bv) of one layer as float64 numpy arrays."""
    attn = params["layers"][layer]["attn"]
    bk = _float64(attn["bk"]) if "bk" in attn else None
    bv = _float64(attn["bv"]) if "bv" in attn else None
    return _float64(attn["wk"]), _float64(attn["wv"]), bk, bv


def observe_block_inputs(model, token_batches: Iterable
                         ) -> List[Tuple[float, float]]:
    """Per-layer ``MinMaxObserver`` over the post-norm activations feeding
    the K/V projections, walked layer by layer on real token batches
    (through ``model``'s own prefill layers, on its device).

    Returns per-layer (lo, hi) to replace the default calibrated-range
    assumption in ``derive_kv_spec`` — calibration tightens the SIRA input
    interval; the propagation itself stays static and guaranteed.
    """
    from ..models.transformer import _dense_layer_fwd, _moe_layer_fwd

    cfg = model.cfg
    params = model._weights()
    obs = [MinMaxObserver(QuantSpec(bits=8)) for _ in range(cfg.n_layers)]
    with torch.inference_mode():
        for toks in token_batches:
            toks = torch.as_tensor(np.asarray(toks), dtype=torch.long,
                                   device=model.device)
            x = model._embed(params, toks, None)
            for layer, p in enumerate(params["layers"]):
                obs[layer].update(rms_norm(x, p["ln1"]).to(torch.float32))
                if cfg.family == "moe":
                    x, _ = _moe_layer_fwd(p, x, cfg)
                else:
                    x = _dense_layer_fwd(p, x, cfg, window=0)
    return [(o.lo, o.hi) for o in obs]


def derive_kv_spec(model, *, x_range: Tuple[float, float] = (-4., 4.),
                   a_bits: int = 8, max_step: float = 0.5,
                   calib_token_batches: Optional[Iterable] = None,
                   domain: str = "interval") -> KVCacheSpec:
    """SIRA-derived per-layer/per-head int8 KV-cache scales for the
    weights in ``model.params``.

    ``x_range`` is the assumed post-norm activation interval feeding the
    K/V projections (export.py convention); pass ``calib_token_batches``
    to replace it with per-layer observed ranges.  ``max_step`` is the
    fp-fallback threshold: a layer stays full-precision when its int8
    resolution (amax / 127) would exceed it.  ``domain`` selects the
    range-analysis abstract domain ("interval" or "affine"); the affine
    reduced product can only tighten the derived scales.
    """
    cfg = model.cfg
    params = model._weights()
    KV, hd = cfg.n_kv_heads, cfg.hd
    ranges = ([tuple(map(float, r)) for r in
               observe_block_inputs(model, calib_token_batches)]
              if calib_token_batches is not None
              else [x_range] * cfg.n_layers)

    layers = []
    for layer in range(cfg.n_layers):
        Wk, Wv, bk, bv = _layer_weights(params, layer)
        lo, hi = ranges[layer]
        g, inputs = export_kv_proj_graph(Wk, Wv, bk=bk, bv=bv,
                                         x_lo=lo, x_hi=hi, a_bits=a_bits)
        r = analyze(g, inputs, domain=domain)

        def head_amax(rng, rope: bool) -> np.ndarray:
            amax = np.maximum(np.abs(np.asarray(rng.lo)),
                              np.abs(np.asarray(rng.hi)))
            amax = amax.reshape(KV, hd).max(axis=1)
            return amax * (ROPE_HULL if rope else 1.0)

        layers.append(layer_kv_spec(head_amax(r["k_mm"], rope=True),
                                    head_amax(r["v_mm"], rope=False),
                                    max_step))
    return KVCacheSpec(tuple(layers))


_Key = Tuple  # (parent_key | None, page-token tuple) — recursive


class PrefixIndex:
    """Content-addressed index of full prompt pages for prefix sharing.

    A page is keyed by ``(parent_key, tokens)`` where ``parent_key`` is
    the key of the page before it (``None`` at position 0) and ``tokens``
    is the page's full token tuple.  Keying by chain rather than by page
    content alone makes position part of the identity — two requests
    share a page only when *everything* up to and including it is
    identical, which is exactly the condition under which the stored
    (RoPE-rotated, possibly int8-quantized) KV is bit-identical.
    """

    def __init__(self) -> None:
        self._page_of: Dict[_Key, int] = {}
        self._key_of: Dict[int, _Key] = {}
        self._kids: Dict[Optional[_Key], Set[_Key]] = {}

    def __len__(self) -> int:
        return len(self._page_of)

    def is_registered(self, page: int) -> bool:
        return page in self._key_of

    def lookup(self, chunks: Sequence[Tuple[int, ...]]) -> List[int]:
        """Physical pages of the longest indexed chain matching the
        per-page token chunks, in position order."""
        pages: List[int] = []
        parent: Optional[_Key] = None
        for chunk in chunks:
            key = (parent, chunk)
            pg = self._page_of.get(key)
            if pg is None:
                break
            pages.append(pg)
            parent = key
        return pages

    def partial_lookup(self, n_matched: int,
                       chunks: Sequence[Tuple[int, ...]],
                       tail: Tuple[int, ...]) -> Tuple[int, Optional[int]]:
        """Best mid-page overlap after ``n_matched`` fully-matched chunks:
        among the indexed children of the matched chain, the page whose
        token tuple shares the longest common prefix with ``tail``.
        Returns (overlap_tokens, physical_page | None)."""
        parent: Optional[_Key] = None
        for chunk in chunks[:n_matched]:
            parent = (parent, chunk)
        best_m, best_pg = 0, None
        for key in self._kids.get(parent, ()):
            chunk = key[1]
            m = 0
            while m < len(tail) and m < len(chunk) and tail[m] == chunk[m]:
                m += 1
            if m > best_m:
                best_m, best_pg = m, self._page_of[key]
        return best_m, best_pg

    def register(self, chunks: Sequence[Tuple[int, ...]],
                 pages: Sequence[int]) -> List[int]:
        """Walk the chain, adding nodes for chunks not yet indexed
        (existing nodes win — the walker's duplicate page stays private).
        Returns the pages newly registered."""
        parent: Optional[_Key] = None
        new: List[int] = []
        for chunk, pg in zip(chunks, pages):
            key = (parent, chunk)
            if key not in self._page_of:
                self._page_of[key] = pg
                self._key_of[pg] = key
                self._kids.setdefault(parent, set()).add(key)
                new.append(pg)
            parent = key
        return new

    def evict(self, page: int) -> List[int]:
        """Drop the node owning ``page`` and its entire subtree (children
        would be unreachable without their parent).  Returns every page
        whose registration was removed, ``page`` first."""
        key = self._key_of[page]
        parent = key[0]
        kids = self._kids.get(parent)
        if kids is not None:
            kids.discard(key)
        dropped: List[int] = []
        stack = [key]
        while stack:
            k = stack.pop()
            pg = self._page_of.pop(k)
            self._key_of.pop(pg, None)
            stack.extend(self._kids.pop(k, ()))
            dropped.append(pg)
        return dropped


class PagedKVCache:
    """Shared physical page pool + host-side page table / free list.

    Device state: per-layer {"k", "v"} pools of shape
    (num_pages, page_size, KV, hd) on ``device`` — int8 for SIRA-certified
    layers, fp otherwise — written in place by ``Model.decode_paged``;
    ``n_kv`` (default: the config's KV heads) is what a tensor-parallel
    rank holds (``launch/shardings.py kv_pool_sharding``).
    The table and free list are plain numpy/python, updated between
    steps.  ``device=None`` means the card (``"cuda"``) and raises without
    one, as every entry point of the port does.

    With ``prefix_cache=True`` pages carry refcounts (``ref[p]`` = slots
    mapping page p), full prompt pages are registered in a
    :class:`PrefixIndex`, and released pages whose content is indexed
    move to a cached-free LRU instead of the free list.
    """

    def __init__(self, cfg, spec: KVCacheSpec, batch_slots: int,
                 max_seq: int, page_size: int = 16,
                 num_pages: Optional[int] = None, fp_dtype=None,
                 prefix_cache: bool = False, device=None,
                 n_kv: Optional[int] = None):
        assert len(spec.layers) == cfg.n_layers
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)
        self.page_size = page_size
        self.slots = batch_slots
        self.max_pages = -(-max_seq // page_size)
        # default pool: worst case (every slot full) + trash page
        self.num_pages = num_pages or batch_slots * self.max_pages + 1
        assert self.num_pages >= self.max_pages + 1, \
            "pool must hold at least one full-length request"
        # a tensor-parallel rank's pools hold its own KV heads only
        KV, hd = n_kv or cfg.n_kv_heads, cfg.hd
        fp_dtype = fp_dtype or cfg.dtype
        shape = (self.num_pages, page_size, KV, hd)

        def pool(dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.pages = [
            {"k": pool(torch.int8 if l.int8 else fp_dtype),
             "v": pool(torch.int8 if l.int8 else fp_dtype)}
            for l in spec.layers]
        self.table = np.zeros((batch_slots, self.max_pages), np.int32)
        self.free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.owned: List[List[int]] = [[] for _ in range(batch_slots)]
        # --- prefix sharing state (inert when prefix_cache is False) ---
        self.prefix_cache_enabled = prefix_cache
        self.index: Optional[PrefixIndex] = \
            PrefixIndex() if prefix_cache else None
        self.ref = np.zeros(self.num_pages, np.int32)   # slots mapping p
        # cached-free pages: ref == 0 but content still indexed; ordered
        # oldest-released first so reclamation evicts the coldest prefix
        self.lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.forks = 0                # copy-on-write page copies performed

    # ------------------------------------------------------- allocation
    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _take_page(self) -> Optional[int]:
        """A writable page: the free list first, else reclaim the
        oldest cached-free page (evicting its prefix subtree — orphaned
        descendants drop from the LRU to the free list)."""
        if self.free:
            return self.free.pop()
        if self.lru:
            pg, _ = self.lru.popitem(last=False)
            for dropped in self.index.evict(pg):
                if dropped != pg and dropped in self.lru:
                    del self.lru[dropped]
                    self.free.append(dropped)
            return pg
        return None

    def grow(self, slot: int, new_len: int) -> bool:
        """Ensure the slot maps every logical position < new_len.

        Returns False (no change) when the pool cannot satisfy it — the
        scheduler then preempts or defers admission.  Cached-free LRU
        pages count as available: they are reclaimed on demand."""
        need = self.pages_for(new_len) - len(self.owned[slot])
        if need > len(self.free) + len(self.lru):
            return False
        for _ in range(max(need, 0)):
            pg = self._take_page()
            self.ref[pg] = 1
            self.table[slot, len(self.owned[slot])] = pg
            self.owned[slot].append(pg)
        return True

    def _drop_ref(self, pg: int) -> None:
        self.ref[pg] -= 1
        assert self.ref[pg] >= 0, "page refcount underflow"
        if self.ref[pg] == 0:
            if self.index is not None and self.index.is_registered(pg):
                self.lru[pg] = None          # most-recently released
            else:
                self.free.append(pg)

    def release(self, slot: int) -> None:
        """Return the slot's pages to the pool (request finished/evicted).

        Shared pages survive under their other mappings; pages whose
        content is registered in the prefix index park in the LRU."""
        for pg in reversed(self.owned[slot]):
            self._drop_ref(pg)
        self.owned[slot] = []
        self.table[slot, :] = 0

    # ---------------------------------------------------- prefix sharing
    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(len(tokens) // ps)]

    def _copy_page(self, src: int, dst: int) -> None:
        for pool in self.pages:
            pool["k"][dst] = pool["k"][src]
            pool["v"][dst] = pool["v"][src]

    def attach_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Map the longest cached prefix of ``tokens`` into the slot,
        swapping out the private pages admission allocated (each swap
        frees one private page, so attachment never needs allocation).

        Fully-matched pages are *shared*: mapped with a refcount bump,
        never written (the slot's writes all land at positions >= the
        returned frontier).  A mid-page overlap at the boundary is
        *copied* into the slot's own private page — copy-on-write done
        eagerly, because the slot will write the divergent suffix of
        that very page during prefill.

        Returns the recompute frontier: the number of leading tokens
        whose KV is already in the cache (< len(tokens); the last token
        is always recomputed so prefill has logits to sample from).
        """
        if self.index is None or len(tokens) < 2:
            return 0
        chunks = self._chunks(tokens)
        shared = self.index.lookup(chunks)
        ps = self.page_size
        matched = len(shared) * ps
        part_m, part_pg = self.index.partial_lookup(
            len(shared), chunks,
            tuple(int(t) for t in tokens[len(shared) * ps:]))
        cached = min(matched + part_m, len(tokens) - 1)
        if cached <= 0:
            return 0
        n_full = cached // ps
        for j, pg in enumerate(shared[:n_full]):
            priv = self.owned[slot][j]
            assert priv != pg, "slot already maps an indexed page"
            if pg in self.lru:
                del self.lru[pg]
            self.ref[pg] += 1
            self.table[slot, j] = pg
            self.owned[slot][j] = pg
            self._drop_ref(priv)
        if cached % ps:
            # boundary page: diverges (or ends) mid-page — copy content
            # into the private page admission gave us, don't alias it
            src = shared[n_full] if n_full < len(shared) else part_pg
            self._copy_page(src, self.owned[slot][n_full])
            self.forks += 1
        return cached

    def register_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Index the slot's fully-written prompt pages (full pages only —
        a partly-filled tail page will still be written).  First writer
        wins: chunks already indexed keep their existing page and the
        slot's duplicate stays private.  Returns pages newly indexed."""
        if self.index is None:
            return 0
        chunks = self._chunks(tokens)
        pages = [int(self.table[slot, j]) for j in range(len(chunks))]
        return len(self.index.register(chunks, pages))

    def prepare_write(self, slot: int, start_pos: int) -> bool:
        """Fork-on-write guard: any page the slot maps at positions
        >= ``start_pos`` that is also visible elsewhere (mapped by
        another slot, or reachable through the prefix index) is forked
        to a private copy before the write.  In the normal serving flow
        this is a no-op — slots only write above their attach frontier,
        which lands in private pages — but it is what makes the
        reserve/rollback contract survive sharing: a speculative window
        (and its rolled-back garbage) can only ever touch pages no one
        else maps.  Returns False when a fork cannot be allocated."""
        if self.index is None:
            return True
        for j in range(start_pos // self.page_size,
                       len(self.owned[slot])):
            pg = self.owned[slot][j]
            if self.ref[pg] > 1 or self.index.is_registered(pg):
                if not self._fork(slot, j):
                    return False
        return True

    def _fork(self, slot: int, j: int) -> bool:
        old = self.owned[slot][j]
        new = self._take_page()
        if new is None:
            return False
        self._copy_page(old, new)
        self.ref[new] = 1
        self.table[slot, j] = new
        self.owned[slot][j] = new
        self._drop_ref(old)
        self.forks += 1
        return True

    # ------------------------------------------------- speculative window
    def reserve(self, slot: int, new_len: int) -> bool:
        """Map capacity for a speculative write window: every logical
        position < ``new_len`` addressable (``new_len`` may exceed what
        ends up committed).  Pages acquired here stay owned by the slot
        even when the window is rolled back — rejection causes no
        free-list churn, the pages are reused by the very next step."""
        return self.grow(slot, min(new_len, self.max_pages * self.page_size))

    def rollback(self, slot: int, committed_len: int) -> None:
        """Discard speculative writes beyond ``committed_len``.

        Physically a no-op by construction: every read masks key
        positions against the per-slot length pointer, so the rejected
        suffix is unreadable garbage, and the next step's writes land on
        top of it (scatter happens before gather inside
        ``paged_attention``, so it is overwritten before it could ever
        enter a live mask).  Pages stay allocated (see ``reserve``)."""
        assert self.pages_for(committed_len) <= len(self.owned[slot]), \
            "rollback below the slot's mapped extent"

    # ------------------------------------------------------------ views
    def device_table(self) -> torch.Tensor:
        """The page table as an int32 tensor on the pools' device (a copy:
        the host table changes between steps)."""
        return torch.tensor(self.table, dtype=torch.int32,
                            device=self.device)

    def slot_table(self, slot: int) -> torch.Tensor:
        return torch.tensor(self.table[slot:slot + 1], dtype=torch.int32,
                            device=self.device)

    @property
    def used_pages(self) -> int:
        """Pages mapped by live slots (cached-free LRU pages excluded —
        they are reclaimable on demand, not in use)."""
        return self.num_pages - 1 - len(self.free) - len(self.lru)

    @property
    def cached_pages(self) -> int:
        """Cached-free pages held for prefix reuse (the LRU)."""
        return len(self.lru)

    @property
    def shared_pool_occupancy(self) -> float:
        """Fraction of the pool physically holding data — live mappings
        plus cached prefixes (the trash page excluded)."""
        return (self.num_pages - 1 - len(self.free)) / (self.num_pages - 1)

    def hbm_bytes(self) -> int:
        """Device bytes of the page pools."""
        return sum(t.numel() * t.element_size()
                   for p in self.pages for t in (p["k"], p["v"]))
