"""Continuous-batching scheduler: FIFO queue, slot table, paged-cache
bookkeeping, per-request termination, preemption.

The scheduler owns *what runs where* — admission of queued requests into
free batch slots (gated on page availability; with prefix caching,
cached-free LRU pages count as available and are reclaimed on demand),
per-request EOS / max-token termination (finished requests free their
slot and pages immediately, mid-batch — shared pages survive under
their other mappings, indexed pages park in the reuse LRU), and
preemption of the newest-admitted request when the page pool runs dry
(its sequence goes back to the queue front, preserving FIFO order, and
is replayed by chunked prefill on re-admission — a replay that
re-attaches its own just-released prefix pages when they are still
cached).  The engine owns *how it runs* — the model calls.

Invariant for an active slot: ``len(entry.seq) == state.length + 1`` —
the sequence always ends with exactly one token that has been sampled
but not yet written to the KV cache; it is the next decode input.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .kv_cache import PagedKVCache
from .metrics import ServingMetrics


@dataclasses.dataclass
class Request:
    """One generation request.

    ``request_id`` is the PRNG identity: sampling for a request depends
    only on (engine seed, request_id, token index), never on batch
    composition.  Left unset, the submission handle is used; pin it to
    reproduce a request's sampled stream across different submission
    orders.  The object is never mutated by the engine."""
    prompt: np.ndarray                 # (S_prompt,) token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    request_id: Optional[int] = None


@dataclasses.dataclass
class _QueueEntry:
    request: Request
    seq: List[int]                     # prompt + generated (replay source)
    handle: int = 0                    # unique bookkeeping key
    prng_id: int = 0                   # sampling identity (request_id/handle)
    n_generated: int = 0


@dataclasses.dataclass
class _SlotState:
    entry: _QueueEntry
    length: int                        # tokens currently in the KV cache
    admit_seq: int                     # admission stamp (preempt newest)


class Scheduler:
    def __init__(self, batch_slots: int, max_seq: int, cache: PagedKVCache,
                 metrics: Optional[ServingMetrics] = None):
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.cache = cache
        self.metrics = metrics
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_SlotState]] = [None] * batch_slots
        self.outputs: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._admit_counter = 0

    # -------------------------------------------------------- submission
    def submit(self, request: Request) -> int:
        prompt = [int(t) for t in np.asarray(request.prompt).ravel()]
        if not prompt:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + request.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds max_seq {self.max_seq}")
        handle = self._next_rid
        self._next_rid += 1
        prng_id = handle if request.request_id is None else \
            request.request_id
        self.outputs[handle] = []
        self.queue.append(_QueueEntry(request, prompt, handle, prng_id))
        if self.metrics:
            self.metrics.on_submit(handle, len(prompt))
        return handle

    # --------------------------------------------------------- admission
    def admit(self) -> List[Tuple[int, _QueueEntry]]:
        """FIFO-admit queued requests into free slots while pages last.

        Head-of-line blocking is deliberate: the oldest request is never
        skipped in favor of a smaller one, so no request can starve."""
        admitted = []
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            entry = self.queue[0]
            slot = free[0]
            # reserve one position beyond the prompt: the first decode
            # write otherwise lands exactly on a page boundary for
            # page-multiple prompts and a dry pool would preempt the
            # request right after its (wasted) prefill
            if not self.cache.grow(slot, len(entry.seq) + 1):
                break
            self.queue.popleft()
            self.slots[slot] = _SlotState(entry, 0, self._admit_counter)
            self._admit_counter += 1
            admitted.append((slot, entry))
        return admitted

    # ------------------------------------------------------- slot state
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def newest_active(self) -> Optional[int]:
        act = self.active_slots()
        if not act:
            return None
        return max(act, key=lambda i: self.slots[i].admit_seq)

    def set_prefilled(self, slot: int, length: int) -> None:
        self.slots[slot].length = length

    def advance(self, slot: int, n: int) -> None:
        """``n`` tokens were committed into the slot's KV cache this step
        (1 on the per-token path; 1 + accepted drafts on a speculative
        step — the rejected suffix never advances the pointer)."""
        self.slots[slot].length += n

    def note_cache_write(self, slot: int) -> None:
        """One decode step wrote the slot's pending token into the cache."""
        self.advance(slot, 1)

    # ------------------------------------------------------ termination
    def record_tokens(self, slot: int, tokens) -> Tuple[int, bool]:
        """Append sampled tokens in order, honoring EOS / max_new_tokens
        *inside the window*: recording stops at the terminating token
        (the slot is freed, later tokens are discarded).  Returns
        (n_recorded, finished)."""
        for n, tok in enumerate(tokens):
            if self.record_token(slot, int(tok)):
                return n + 1, True
        return len(tokens), False

    def record_token(self, slot: int, token: int) -> bool:
        """Append a sampled token; free the slot if the request finished
        (EOS hit or max_new_tokens reached).  Returns finished."""
        st = self.slots[slot]
        e = st.entry
        self.outputs[e.handle].append(token)
        e.seq.append(token)
        e.n_generated += 1
        done = e.n_generated >= e.request.max_new_tokens or (
            e.request.eos_id is not None and token == e.request.eos_id)
        if done:
            self.free_slot(slot)
        return done

    def free_slot(self, slot: int) -> None:
        self.cache.release(slot)
        self.slots[slot] = None

    def preempt(self, slot: int) -> int:
        """Evict a running request: pages freed (shared mappings just
        drop a reference), sequence (prompt + generated so far) back to
        the queue *front* — it was admitted before anything still
        queued, so FIFO order is preserved.  Returns the preempted
        request id."""
        st = self.slots[slot]
        self.cache.release(slot)
        self.slots[slot] = None
        self.queue.appendleft(st.entry)
        if self.metrics:
            self.metrics.on_preemption(st.entry.handle)
        return st.entry.handle
