"""Serving metrics: TTFT, per-token latency, throughput, slot occupancy.

Pure host-side bookkeeping updated by the scheduler/engine between model
steps; ``clock`` is injectable so tests can drive deterministic time.

``ServingMetrics`` is a compatibility facade over a
:class:`repro_torch.obs.metrics.MetricsRegistry`: the public API (event
methods, count fields, aggregate properties, ``summary()``) is unchanged
from the pre-obs implementation, but every count lives in a typed
registry metric and every latency lands in a histogram, so the same
numbers the tests assert on are scrapeable via :meth:`to_prometheus`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass
class RequestRecord:
    request_id: int
    submit_t: float
    prompt_tokens: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.token_times)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class ServingMetrics:
    """Counters surfaced by the serving engine.

    * TTFT — submit → first generated token, per request (includes queue
      wait, which is the point: it exposes scheduling quality).
    * per-token latency — mean gap between consecutive generated tokens.
    * tokens/s — generated tokens over the busy wall-clock window.
    * slot occupancy — active slot-steps / (slots x decode steps): how
      much of the batch the scheduler actually kept filled.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.requests: Dict[int, RequestRecord] = {}
        # every ServingMetrics owns a fresh registry — engines call
        # reset_metrics() by constructing a new instance, which must not
        # carry counts over
        self.registry = MetricsRegistry()
        r = self.registry
        self._decode_steps = r.counter(
            "serving_decode_steps_total", "decode model calls")
        self._decode_tokens = r.counter(
            "serving_decode_tokens_total",
            "tokens emitted by decode steps")
        self._active_slot_steps = r.counter(
            "serving_active_slot_steps_total",
            "sum of active slots over decode steps")
        self._slot_capacity = r.counter(
            "serving_slot_capacity_total",
            "sum of total slots over decode steps")
        self._prefill_chunks = r.counter(
            "serving_prefill_chunks_total", "prefill chunk model calls")
        self._preemptions = r.counter(
            "serving_preemptions_total", "requests preempted")
        self._spec_steps = r.counter(
            "serving_spec_steps_total", "speculative verify steps")
        self._spec_proposed = r.counter(
            "serving_spec_proposed_total", "draft tokens proposed")
        self._spec_accepted = r.counter(
            "serving_spec_accepted_total", "draft tokens accepted")
        self._prefix_lookups = r.counter(
            "serving_prefix_lookups_total", "prefix-cache lookups")
        self._prefix_hit_tokens = r.counter(
            "serving_prefix_hit_tokens_total",
            "prompt tokens served from cached prefix pages")
        self._prefix_lookup_tokens = r.counter(
            "serving_prefix_lookup_tokens_total",
            "prompt tokens that went through prefix lookup")
        self._submitted = r.counter(
            "serving_requests_total", "requests submitted")
        self._tokens = r.counter(
            "serving_tokens_total", "tokens generated")
        self._ttft_hist = r.histogram(
            "serving_ttft_seconds", "submit to first token")
        self._latency_hist = r.histogram(
            "serving_token_latency_seconds",
            "gap between consecutive tokens of one request")
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    # ------------------------------------------------- registry-backed
    # count fields keep their historical names/types (plain ints) while
    # the registry holds the authoritative value
    @property
    def decode_steps(self) -> int:
        return int(self._decode_steps.value)

    @property
    def decode_tokens(self) -> int:
        return int(self._decode_tokens.value)

    @property
    def active_slot_steps(self) -> int:
        return int(self._active_slot_steps.value)

    @property
    def slot_capacity(self) -> int:
        return int(self._slot_capacity.value)

    @property
    def prefill_chunks(self) -> int:
        return int(self._prefill_chunks.value)

    @property
    def preemptions(self) -> int:
        return int(self._preemptions.value)

    @property
    def spec_steps(self) -> int:
        return int(self._spec_steps.value)

    @property
    def spec_proposed(self) -> int:
        return int(self._spec_proposed.value)

    @property
    def spec_accepted(self) -> int:
        return int(self._spec_accepted.value)

    def to_prometheus(self) -> str:
        """Prometheus text-format export of every serving metric."""
        return self.registry.to_prometheus()

    # ----------------------------------------------------------- events
    def on_submit(self, request_id: int, prompt_tokens: int) -> None:
        t = self.clock()
        self.requests[request_id] = RequestRecord(request_id, t,
                                                  prompt_tokens)
        self._submitted.inc()
        if self._t0 is None:
            self._t0 = t

    def on_prefill_chunk(self) -> None:
        self._prefill_chunks.inc()

    def on_token(self, request_id: int) -> None:
        r = self.requests[request_id]
        t = self.clock()
        if r.first_token_t is None:
            r.first_token_t = t
            self._ttft_hist.observe(t - r.submit_t)
        else:
            self._latency_hist.observe(t - r.token_times[-1])
        r.token_times.append(t)
        self._tokens.inc()
        self._t_last = t

    def on_finish(self, request_id: int) -> None:
        self.requests[request_id].finish_t = self.clock()

    def on_decode_step(self, active_slots: int, total_slots: int,
                       tokens: int = 0) -> None:
        self._decode_steps.inc()
        self._decode_tokens.inc(tokens)
        self._active_slot_steps.inc(active_slots)
        self._slot_capacity.inc(total_slots)

    def on_spec_step(self, proposed: int, accepted: int) -> None:
        """One speculative decode step verified ``proposed`` draft tokens
        across the batch and accepted ``accepted`` of them."""
        self._spec_steps.inc()
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)

    def on_preemption(self, request_id: int) -> None:
        self._preemptions.inc()
        self.requests[request_id].preemptions += 1

    def on_prefix_lookup(self, cached_tokens: int,
                         prompt_tokens: int) -> None:
        """One prefill consulted the prefix cache: ``cached_tokens`` of
        its ``prompt_tokens`` were attached instead of recomputed."""
        self._prefix_lookups.inc()
        self._prefix_hit_tokens.inc(cached_tokens)
        self._prefix_lookup_tokens.inc(prompt_tokens)

    # ------------------------------------------------------- aggregates
    @property
    def total_tokens(self) -> int:
        return sum(r.n_tokens for r in self.requests.values())

    @property
    def mean_ttft(self) -> float:
        ts = [r.ttft for r in self.requests.values() if r.ttft is not None]
        return sum(ts) / len(ts) if ts else float("nan")

    @property
    def mean_token_latency(self) -> float:
        gaps = []
        for r in self.requests.values():
            gaps.extend(b - a for a, b in zip(r.token_times,
                                              r.token_times[1:]))
        return sum(gaps) / len(gaps) if gaps else float("nan")

    @property
    def tokens_per_s(self) -> float:
        if self._t0 is None or self._t_last is None or \
                self._t_last <= self._t0:
            return float("nan")
        return self.total_tokens / (self._t_last - self._t0)

    @property
    def slot_occupancy(self) -> float:
        if not self.slot_capacity:
            return float("nan")
        return self.active_slot_steps / self.slot_capacity

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens across all speculative steps.
        High acceptance (repetitive prompts) is where speculation pays;
        near zero it degrades to the per-token path plus wasted verify
        width — watch this before raising ``spec_k``."""
        if not self.spec_proposed:
            return float("nan")
        return self.spec_accepted / self.spec_proposed

    @property
    def prefix_lookups(self) -> int:
        return int(self._prefix_lookups.value)

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._prefix_hit_tokens.value)

    @property
    def prefix_lookup_tokens(self) -> int:
        return int(self._prefix_lookup_tokens.value)

    @property
    def prefix_hit_rate(self) -> float:
        """Prompt tokens attached from cached prefix pages / prompt
        tokens that went through lookup.  Token-weighted (not
        per-request) so one long cold prompt cannot be papered over by
        many short hits."""
        if not self.prefix_lookup_tokens:
            return float("nan")
        return self.prefix_hit_tokens / self.prefix_lookup_tokens

    def ttft_percentile(self, q: float) -> float:
        """q-th percentile (0-100) of per-request TTFT, seconds."""
        ts = [r.ttft for r in self.requests.values() if r.ttft is not None]
        return float(np.percentile(ts, q)) if ts else float("nan")

    def token_latency_percentile(self, q: float) -> float:
        """q-th percentile (0-100) of inter-token gaps, seconds."""
        gaps: List[float] = []
        for r in self.requests.values():
            gaps.extend(b - a for a, b in zip(r.token_times,
                                              r.token_times[1:]))
        return float(np.percentile(gaps, q)) if gaps else float("nan")

    @property
    def tokens_per_decode_step(self) -> float:
        """Generated tokens emitted per decode model call, per active
        slot (1.0 without speculation; up to 1 + spec_k with it)."""
        if not self.active_slot_steps:
            return float("nan")
        return self.decode_tokens / self.active_slot_steps

    def summary(self) -> Dict[str, float]:
        return dict(
            requests=len(self.requests),
            total_tokens=self.total_tokens,
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            preemptions=self.preemptions,
            spec_steps=self.spec_steps,
            spec_proposed=self.spec_proposed,
            spec_accepted=self.spec_accepted,
            acceptance_rate=self.acceptance_rate,
            tokens_per_decode_step=self.tokens_per_decode_step,
            mean_ttft_s=self.mean_ttft,
            mean_token_latency_s=self.mean_token_latency,
            tokens_per_s=self.tokens_per_s,
            slot_occupancy=self.slot_occupancy,
            prefix_lookups=self.prefix_lookups,
            prefix_hit_rate=self.prefix_hit_rate,
        )
