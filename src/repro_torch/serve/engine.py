"""Serving engine: continuous batching over a SIRA-quantized paged KV
cache (full-context attention families), with a static-batch fallback for
model families whose state cannot be paged (SSM/hybrid recurrent state,
sliding-window rolling caches).

Counterpart of ``src/repro/serve/engine.py``.  The port's ``Model``
carries its weights, so the engine is ``ServingEngine(model, config)``;
each of the reference's jitted steps is a plain call under
``torch.inference_mode()`` on the model's device, and the page pools are
written in place.

Paged mode (the default wherever ``model.supports_paged``):

* prompts are prefilled in **multi-token chunks** — one model call per
  ``prefill_chunk`` tokens (B=1), not one call per token;
* decode runs one model call per step over *all* slots with per-slot
  cache lengths — requests at different positions batch together;
* the scheduler admits from a FIFO queue into freed slots between steps,
  terminates per request (EOS / max_new_tokens), and preempts the newest
  request when the page pool runs dry;
* KV storage is int8 with per-layer/per-head scales derived from SIRA
  range analysis of the exported K/V projection graph
  (``kv_cache.derive_kv_spec``), fp fallback per layer.

Sampling is deterministic per request and re-keyed from the reference's
``jax.random`` keys (which cannot be reproduced here): a row with
``temperature > 0`` draws Gumbel noise over the vocabulary from a CPU
``torch.Generator`` seeded by ``np.random.SeedSequence([seed, request_id,
token_index])`` and takes ``argmax(logits / temperature + noise)`` on the
model's device; a greedy row takes ``argmax(logits)`` and draws nothing.
A sampled token is a function of (seed, request_id, token index, logits)
alone, so a request draws the same tokens whether it is served alone or
packed with others.

Speculative decoding (``spec_decode=``) amortizes the per-step dispatch
cost of the decode loop: a pluggable drafter proposes up to ``spec_k``
tokens per slot, one ``decode_paged`` call over (slots, spec_k+1)
verifies them all against the target model (the same multi-token path
chunked prefill uses), accepted prefixes commit to the paged cache and
rejected suffixes roll back via the per-slot length pointers — pages
stay allocated, no pool churn.  Because sampling is a deterministic
function of (seed, request_id, token index, logits), acceptance is exact
at any temperature: the emitted stream is the per-token stream, and
speculation only changes how many model steps it takes.

Tensor-parallel serving (``ServingConfig(mesh=layout)``, a bound
``launch.mesh.Layout``): the engine serves a copy of the model sharded
over the layout's "model" axis (``Model.shard``), its page pools hold the
rank's KV heads only, and the page table, free list and prefix index
stay global.  Every rank runs the same host code on the same requests;
its greedy picks and Gumbel draws read the logits after the model's
``all_gather``, which every rank holds bit for bit, so every rank takes
the same decisions.  The KV spec is derived from the whole model first.
Static mode under a layout serves the sharded model's ``decode_step``
against its ``init_cache`` (the rank's KV heads, and Mamba2's conv and
SSD states of its heads), with the same rule for the decisions.

Prefix caching (``ServingConfig(prefix_cache=True)``) makes prefill
incremental across requests: the engine attaches the longest cached
prefix of each new prompt (copy-on-write shared pages, see
``kv_cache.PagedKVCache``) and recomputes only the suffix — emitted
tokens equal a cold prefill's because the shared pages hold exactly the
KV the slot would have recomputed.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.lower import resolve_device
from ..models.transformer import Model
from ..obs.trace import get_tracer
from ..quant.quantizer import QuantSpec
from .config import ServingConfig
from .draft import DraftProposer, get_drafter
from .kv_cache import KVCacheSpec, PagedKVCache, derive_kv_spec
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler

_SENTINEL = object()


def _legacy_config(batch_slots, max_seq, quant, seed, kw) -> ServingConfig:
    """Build a ServingConfig from the pre-config loose kwargs."""
    fields = dict(batch_slots=batch_slots, max_seq=max_seq,
                  quant=quant, seed=0 if seed is _SENTINEL else seed)
    for k, v in kw.items():
        if v is not _SENTINEL:
            fields[k] = v
    return ServingConfig(**fields)


def gumbel_noise(seed: int, request_id: int, token_index: int,
                 n: int) -> torch.Tensor:
    """Standard Gumbel noise (n,) float32 on the CPU, a function of (seed,
    request_id, token_index) alone: the sampling key of one token."""
    state = np.random.SeedSequence(
        [seed, request_id, token_index]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def local_kv_scales(spec: KVCacheSpec, model: Model, device):
    """``spec.scales(device)`` for the KV heads ``model`` holds: all of
    them, or a tensor-parallel rank's (``launch/shardings.py
    kv_head_range``)."""
    scales = spec.scales(device)
    layout = model.layout
    if layout is None or layout.size("model") == 1:
        return scales
    from ..launch.shardings import kv_head_range
    first, n = kv_head_range(model.cfg, layout)
    return [None if s is None else tuple(t[first:first + n] for t in s)
            for s in scales]


class ServingEngine:
    def __init__(self, model: Model,
                 config: Union[ServingConfig, int, None] = None,
                 max_seq: Optional[int] = None,
                 quant: Optional[QuantSpec] = None,
                 seed=_SENTINEL, *,
                 batch_slots: Optional[int] = None,
                 kv_cache=_SENTINEL, page_size=_SENTINEL,
                 prefill_chunk=_SENTINEL, num_pages=_SENTINEL,
                 mode=_SENTINEL, spec_decode=_SENTINEL,
                 spec_k=_SENTINEL):
        """Preferred: ``ServingEngine(model, ServingConfig(...))`` — every
        knob lives on :class:`ServingConfig`, validated there.  The model
        serves on its own device; a CUDA model with no card raises.

        The pre-config surface (``batch_slots``/``max_seq`` positional or
        keyword, loose ``kv_cache=…``/``page_size=…``/… kwargs) still
        works through a shim that assembles the equivalent config and
        emits one ``DeprecationWarning`` per construction."""
        legacy_kw = dict(kv_cache=kv_cache, page_size=page_size,
                         prefill_chunk=prefill_chunk, num_pages=num_pages,
                         mode=mode, spec_decode=spec_decode, spec_k=spec_k)
        if isinstance(config, ServingConfig):
            if (max_seq is not None or quant is not None or
                    seed is not _SENTINEL or batch_slots is not None or
                    any(v is not _SENTINEL for v in legacy_kw.values())):
                raise TypeError(
                    "pass every option on the ServingConfig — mixing a "
                    "config with loose legacy kwargs is ambiguous")
            cfg = config
        else:
            if isinstance(config, int):          # legacy positional
                if batch_slots is not None:
                    raise TypeError("batch_slots given twice")
                batch_slots = config
            elif config is not None:
                raise TypeError(
                    f"second argument must be a ServingConfig (or the "
                    f"legacy batch_slots int), got {type(config).__name__}")
            if batch_slots is None or max_seq is None:
                raise TypeError(
                    "ServingEngine needs a ServingConfig (or legacy "
                    "batch_slots + max_seq)")
            warnings.warn(
                "loose ServingEngine(...) kwargs are deprecated — "
                "construct a repro_torch.serve.ServingConfig and pass it "
                "as the second argument",
                DeprecationWarning, stacklevel=2)
            cfg = _legacy_config(batch_slots, max_seq, quant, seed,
                                 legacy_kw)

        self.config = cfg
        self.model = model
        self.layout = cfg.mesh
        self.device = resolve_device(model.device)
        self.B = cfg.batch_slots
        self.S = cfg.max_seq
        self.quant = cfg.quant
        self.seed = cfg.seed
        self.prefill_chunk = cfg.prefill_chunk
        mode = cfg.mode
        if mode is None:
            mode = "paged" if model.supports_paged else "static"
        if mode == "paged" and not model.supports_paged:
            raise NotImplementedError(
                f"paged serving needs full-context attention — "
                f"family={model.cfg.family!r} "
                f"sliding_window={model.cfg.sliding_window}")
        self.mode = mode
        if cfg.spec_decode is not None and mode != "paged":
            raise NotImplementedError(
                "speculative decoding requires paged mode (the static "
                "engine has no per-slot length pointers to roll back)")
        self.drafter: Optional[DraftProposer] = (
            get_drafter(cfg.spec_decode)
            if isinstance(cfg.spec_decode, str) else cfg.spec_decode)
        self.spec_k = cfg.spec_k
        if mode == "static" and cfg.kv_cache != "fp":
            raise ValueError(
                "static mode serves a full-precision cache — a quantized "
                "kv_cache would be silently ignored")
        if mode == "static" and cfg.prefix_cache:
            raise ValueError(
                "prefix_cache requires paged mode (the static engine "
                "has no page table to share)")
        if mode == "static" and self.layout is not None and \
                self.layout.size("model") > 1:
            # decode_step and init_cache of the sharded model: the rank's
            # KV heads and Mamba2 states
            self.model = model.shard(self.layout)

        if mode == "paged":
            mcfg = model.cfg
            if isinstance(cfg.kv_cache, KVCacheSpec):
                spec = cfg.kv_cache
            elif cfg.kv_cache == "fp":
                spec = KVCacheSpec.all_fp(mcfg.n_layers)
            else:                       # "sira-int8" / "int8" (validated)
                spec = derive_kv_spec(model)
            self.kv_spec = spec
            n_kv = None
            if self.layout is not None and self.layout.size("model") > 1:
                from ..launch.shardings import tp_heads
                self.model = model.shard(self.layout)
                n_kv = tp_heads(mcfg, self.layout)[1]
            self._kv_scales = local_kv_scales(spec, self.model, self.device)
            self.cache = PagedKVCache(mcfg, spec, cfg.batch_slots,
                                      cfg.max_seq,
                                      page_size=cfg.page_size,
                                      num_pages=cfg.num_pages,
                                      prefix_cache=cfg.prefix_cache,
                                      device=self.device, n_kv=n_kv)
            self.metrics = ServingMetrics()
            self.scheduler = Scheduler(cfg.batch_slots, cfg.max_seq,
                                       self.cache, self.metrics)

    # ------------------------------------------------------- model steps
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long, device=self.device)

    def _step(self, tokens: np.ndarray, table: torch.Tensor,
              lengths: np.ndarray) -> torch.Tensor:
        """One ``decode_paged`` call: tokens (B, T) at per-slot offsets
        ``lengths`` (B,) → logits (B, T, V); the pools are written in
        place."""
        with torch.inference_mode():
            logits, _ = self.model.decode_paged(
                self._tensor(tokens), self.cache.pages, table,
                self._tensor(lengths), page_size=self.cache.page_size,
                quant=self.quant, kv_scales=self._kv_scales)
        return logits

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                rids: np.ndarray, steps: np.ndarray) -> np.ndarray:
        """Tokens (N,) for logits (N, V): greedy rows take the argmax,
        rows with ``temps > 0`` the argmax of ``logits / temp`` plus their
        own Gumbel noise (``gumbel_noise``)."""
        with torch.inference_mode():
            lg = logits.to(torch.float32)
            tokens = torch.argmax(lg, dim=-1)
            hot = np.flatnonzero(temps > 0)
            if hot.size:
                V = lg.shape[-1]
                noise = torch.stack([
                    gumbel_noise(self.seed, int(rids[i]), int(steps[i]), V)
                    for i in hot]).to(self.device)
                rows = torch.as_tensor(hot, device=self.device)
                t = torch.as_tensor(temps[hot], dtype=torch.float32,
                                    device=self.device)
                tokens[rows] = torch.argmax(lg[rows] / t[:, None] + noise,
                                            dim=-1)
            return tokens.cpu().numpy()

    # ------------------------------------------------------- paged mode
    def submit(self, request: Request) -> int:
        """Queue a request; returns its request id (also its sampling id
        unless ``request.request_id`` pins one)."""
        if self.mode != "paged":
            raise NotImplementedError("submit() requires paged mode")
        return self.scheduler.submit(request)

    def step(self) -> bool:
        """One scheduler iteration: admit + prefill new requests, then one
        batched decode step.  Returns False when there is nothing to do."""
        if self.mode != "paged":
            raise NotImplementedError("step() requires paged mode")
        sched = self.scheduler
        if not sched.has_work():
            return False
        for slot, entry in sched.admit():
            self._prefill(slot, entry)
        if self.drafter is not None:
            self._decode_spec()
        else:
            self._decode_once()
        return True

    def run(self) -> None:
        while self.step():
            pass

    def reset_metrics(self) -> None:
        """Fresh counters (e.g. after a warm-up run)."""
        if self.mode != "paged":
            raise NotImplementedError("metrics require paged mode")
        self.metrics = ServingMetrics()
        self.scheduler.metrics = self.metrics

    def _prefill(self, slot: int, entry) -> None:
        """Chunked multi-token prefill of one slot (B=1): one
        ``decode_paged`` call per ``prefill_chunk`` tokens, then sample
        the first continuation token from the last prompt position.

        With prefix caching the slot first attaches the longest cached
        prefix of its sequence (shared pages, refcounted; the mid-page
        boundary copied) and prefill recomputes only the suffix — same
        logits, fewer chunks.  After the prompt is in the cache its full
        pages are registered for the next request to attach."""
        seq = entry.seq
        L = len(seq)
        C = self.prefill_chunk
        cached = self.cache.attach_prefix(slot, seq)
        # every page at/above the recompute frontier must be private
        # before prefill writes land (a no-op by construction — attach
        # copies the boundary page)
        if not self.cache.prepare_write(slot, cached):
            raise RuntimeError("prefill: no page to fork a shared page "
                               "into")
        if self.cache.prefix_cache_enabled:
            self.metrics.on_prefix_lookup(cached, L)
        table = self.cache.slot_table(slot)
        logits = None
        tr = get_tracer()
        with tr.span("serve:prefill", slot=slot, prompt_tokens=L,
                     chunk=C, cached_tokens=cached):
            for start in range(cached, L, C):
                chunk = seq[start:start + C]
                toks = np.zeros((1, C), np.int64)
                toks[0, :len(chunk)] = chunk
                with tr.span("serve:prefill_chunk", start=start):
                    logits = self._step(toks, table,
                                        np.full((1,), start, np.int64))
                self.metrics.on_prefill_chunk()
        self.scheduler.set_prefilled(slot, L)
        # register before the first record_token: a request finishing on
        # its very first token releases the slot right there, and only
        # registered pages park in the reuse LRU
        self.cache.register_prefix(slot, seq[:len(entry.request.prompt)])

        req = entry.request
        last = (L - 1 - cached) % C    # last prompt token in final chunk
        tok = self._sample(logits[:, last],
                           np.full((1,), req.temperature, np.float32),
                           np.full((1,), entry.prng_id, np.int64),
                           np.full((1,), entry.n_generated, np.int64))
        handle = entry.handle
        done = self.scheduler.record_token(slot, int(tok[0]))
        self.metrics.on_token(handle)
        if done:
            self.metrics.on_finish(handle)

    def _grow_for_step(self, proposals=None) -> None:
        """Map page capacity for this step's per-slot write window.

        Every slot must map the write position ``length`` (per-token) or
        the verify window ``[length, length + spec_k + 1)`` when it has
        proposals.  A window that cannot be mapped drops its proposals
        (``proposals[i]`` cleared in place) before anyone is preempted —
        speculation never evicts a victim.  When even one token cannot
        be mapped, the newest-admitted request is preempted (possibly
        the needy slot itself)."""
        sched = self.scheduler
        for i in sorted(sched.active_slots(),
                        key=lambda i: sched.slots[i].admit_seq):
            while True:
                st = sched.slots[i]
                if st is None:          # lost its slot as preemption victim
                    break
                props = proposals.get(i) if proposals else None
                if props and self.cache.reserve(
                        i, st.length + 1 + self.spec_k) and \
                        self.cache.prepare_write(i, st.length):
                    break
                if props:
                    proposals[i] = []
                if self.cache.grow(i, st.length + 1) and \
                        self.cache.prepare_write(i, st.length):
                    break
                sched.preempt(sched.newest_active())

    def _decode_once(self) -> None:
        sched = self.scheduler
        self._grow_for_step()
        active = sched.active_slots()
        if not active:
            return
        with get_tracer().span("serve:decode_step", active=len(active),
                               batch_slots=self.B):
            self._decode_once_inner(sched, active)

    def _decode_once_inner(self, sched, active) -> None:
        B = self.B
        toks = np.zeros((B, 1), np.int64)
        lens = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        rids = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)
        for i in active:
            st = sched.slots[i]
            toks[i, 0] = st.entry.seq[-1]       # sampled, not yet cached
            lens[i] = st.length
            temps[i] = st.entry.request.temperature
            rids[i] = st.entry.prng_id
            steps[i] = st.entry.n_generated
        logits = self._step(toks, self.cache.device_table(), lens)
        nxt = self._sample(logits[:, -1], temps, rids, steps)
        self.metrics.on_decode_step(len(active), B, tokens=len(active))
        for i in active:
            sched.note_cache_write(i)
            handle = sched.slots[i].entry.handle
            done = sched.record_token(i, int(nxt[i]))
            self.metrics.on_token(handle)
            if done:
                self.metrics.on_finish(handle)

    # -------------------------------------------------- speculative decode
    def _decode_spec(self) -> None:
        """One speculative decode step: propose, verify in a single
        (slots, spec_k+1) call, commit accepted prefixes, roll back
        rejected suffixes.

        Per slot, the input row is ``[pending, d_1 .. d_m, pad]`` at
        positions ``length .. length+spec_k``.  ``logits[:, t]`` predicts
        the token after position ``length+t``, so draft ``d_{t+1}`` is
        accepted iff it equals the token the engine would sample from
        ``logits[:, t]`` at token index ``n_generated + t`` — the exact
        per-token stream at any temperature.  The first mismatch yields
        the corrected token; full acceptance yields a bonus token from
        the last position.  Cache commits ``1 + accepted`` positions
        (pending + accepted drafts); the rest is rolled back by leaving
        the per-slot length pointer behind (pages stay allocated).

        A slot whose drafter proposes nothing rides along with an all-pad
        tail; when *no* slot has proposals the step degrades to the
        per-token path (identical tokens, narrower call).
        """
        sched = self.scheduler
        k = self.spec_k
        proposals = {}
        for i in sched.active_slots():
            e = sched.slots[i].entry
            remaining = e.request.max_new_tokens - e.n_generated
            want = min(k, remaining - 1)   # last token never needs a draft
            props = (self.drafter.propose(e.seq, want, e.prng_id)
                     if want > 0 else [])
            proposals[i] = [int(t) for t in props][:want]
        if not any(proposals.values()):
            self._decode_once()            # the per-token path
            return

        T = k + 1
        self._grow_for_step(proposals)
        active = sched.active_slots()
        if not active:
            return
        with get_tracer().span("serve:spec_verify", active=len(active),
                               spec_k=k) as sp:
            self._verify_window(sched, proposals, active, T, sp)

    def _verify_window(self, sched, proposals, active, T, sp) -> None:
        B = self.B
        toks = np.zeros((B, T), np.int64)
        lens = np.zeros((B,), np.int64)
        for i in active:
            st = sched.slots[i]
            row = [st.entry.seq[-1]] + proposals.get(i, [])
            toks[i, :len(row)] = row
            lens[i] = st.length
        logits = self._step(toks, self.cache.device_table(), lens)

        # sample every verify position of the active slots: row (i, t)
        # uses the same (seed, request_id, token index) key the per-token
        # path would, so acceptance == equality with the exact stream
        temps = np.zeros((B, T), np.float32)
        rids = np.zeros((B, T), np.int64)
        steps = np.zeros((B, T), np.int64)
        for i in active:
            e = sched.slots[i].entry
            temps[i] = e.request.temperature
            rids[i] = e.prng_id
            steps[i] = e.n_generated + np.arange(T)
        sampled = self._sample(logits.reshape(B * T, -1), temps.ravel(),
                               rids.ravel(), steps.ravel()).reshape(B, T)

        emitted_total = proposed = accepted_total = 0
        for i in active:
            props = proposals.get(i, [])
            exp = sampled[i]
            a = 0
            while a < len(props) and props[a] == int(exp[a]):
                a += 1
            # emit accepted drafts + the correction/bonus token;
            # record_tokens stops at EOS / max_new_tokens inside the
            # window (slot + pages freed there, tail discarded)
            emitted = [int(t) for t in exp[:a + 1]]
            handle = sched.slots[i].entry.handle
            n_rec, done = sched.record_tokens(i, emitted)
            for _ in range(n_rec):
                self.metrics.on_token(handle)
            emitted_total += n_rec
            proposed += len(props)
            # drafts accepted AND emitted — an EOS/max_new termination
            # inside the window discards the tail, which must not count
            # toward the acceptance rate
            accepted_total += min(a, n_rec)
            if done:
                self.metrics.on_finish(handle)
            else:
                sched.advance(i, 1 + a)          # pending + accepted
                self.cache.rollback(i, sched.slots[i].length)
                self.drafter.observe(sched.slots[i].entry.seq,
                                     sched.slots[i].entry.prng_id)
        self.metrics.on_decode_step(len(active), B, tokens=emitted_total)
        self.metrics.on_spec_step(proposed, accepted_total)
        sp.set_attr("proposed", proposed)
        sp.set_attr("accepted", accepted_total)
        sp.set_attr("emitted", emitted_total)

    # ---------------------------------------------------------- generate
    def generate(self, requests: List[Request]) -> List[List[int]]:
        """Serve requests to completion; outputs in submission order.

        Paged mode accepts any number of requests (the queue can be
        deeper than ``batch_slots``); static mode keeps the fixed-batch
        contract of the pre-scheduler engine."""
        if self.mode == "paged":
            rids = [self.submit(r) for r in requests]
            self.run()
            return [self.scheduler.outputs[rid] for rid in rids]
        return self._generate_static(requests)

    # ------------------------------------------------------ static mode
    def _generate_static(self, requests: List[Request]) -> List[List[int]]:
        """Static-batch fallback (≤ batch_slots requests, no paging).

        Prompts are left-padded to a common length; ``valid_from`` masks
        pad slots out of attention and shifts RoPE per slot, so each row
        computes exactly what it would when served alone.  Mixed-length
        batches are rejected for model families where pad tokens cannot
        be masked retroactively (SSM/hybrid state updates, sliding-window
        rolling caches).  Finished rows (EOS / max_new_tokens) stop
        accumulating tokens and the loop exits once every row is done."""
        assert len(requests) <= self.B
        outs: List[List[int]] = [[] for _ in requests]
        L = max(len(r.prompt) for r in requests)
        # rows are padded to a common prompt length, so the cache must
        # hold the padded prompt plus the largest per-request budget
        need = L + max(r.max_new_tokens for r in requests)
        if need > self.S:
            raise ValueError(
                f"padded prompt ({L}) + max_new_tokens exceeds "
                f"max_seq {self.S} (need {need})")
        needs_mask = any(len(r.prompt) != L for r in requests)
        cfg = self.model.cfg
        if needs_mask and (cfg.sliding_window or
                           cfg.family in ("ssm", "hybrid")):
            raise NotImplementedError(
                f"mixed-length batches are not supported for "
                f"family={cfg.family!r} sliding_window={cfg.sliding_window}"
                f" — pad-token masking only covers full-context attention")
        toks = np.zeros((self.B, L), np.int64)
        valid = np.zeros((self.B,), np.int64)
        for i, r in enumerate(requests):
            toks[i, L - len(r.prompt):] = np.asarray(r.prompt).ravel()
            valid[i] = L - len(r.prompt)             # first real slot
        valid_from = self._tensor(valid) if needs_mask else None

        n = len(requests)
        temps = np.zeros((self.B,), np.float32)
        rids = np.zeros((self.B,), np.int64)
        for i, r in enumerate(requests):
            temps[i] = r.temperature
            rids[i] = i if r.request_id is None else r.request_id
        done = np.array([False] * self.B)
        done[n:] = True
        steps = np.zeros((self.B,), np.int64)

        with torch.inference_mode():
            cache = self.model.init_cache(self.B, self.S)
            logits = None
            for t in range(L):
                logits, cache = self.model.decode_step(
                    self._tensor(toks[:, t:t + 1]), cache, t,
                    quant=self.quant, valid_from=valid_from)
            cur = self._sample(logits[:, -1], temps, rids, steps)
            for i, r in enumerate(requests):
                outs[i].append(int(cur[i]))
                steps[i] = 1
                if r.max_new_tokens <= 1 or (r.eos_id is not None and
                                             cur[i] == r.eos_id):
                    done[i] = True
            step = 1
            while not done.all():
                logits, cache = self.model.decode_step(
                    self._tensor(cur.reshape(self.B, 1)), cache,
                    L + step - 1, quant=self.quant, valid_from=valid_from)
                cur = self._sample(logits[:, -1], temps, rids, steps)
                for i, r in enumerate(requests):
                    if done[i]:
                        continue
                    outs[i].append(int(cur[i]))
                    steps[i] += 1
                    if steps[i] >= r.max_new_tokens or (
                            r.eos_id is not None and cur[i] == r.eos_id):
                        done[i] = True
                step += 1
        return outs
