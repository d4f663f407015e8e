"""Draft proposers for speculative decoding.

A :class:`DraftProposer` guesses the next ``k`` tokens of a sequence;
the engine verifies the whole guess in **one** ``decode_paged``
call over (slots, k+1) positions and commits the accepted prefix
(``serve/engine.py``).  Because the engine's sampling is a deterministic
function of (seed, request_id, token index, logits), verification is
exact at any temperature: a draft token is accepted iff it equals the
token the per-token engine would have sampled at that position — the
output stream is bit-identical to non-speculative decoding, proposals
only change how many model steps it takes to produce it.

The interface is deliberately model-free (token ids in, token ids out)
so a small-model drafter can slot in later: propose() may run its own
forward pass, observe() lets it ingest committed tokens.

``NgramDrafter`` is the zero-cost baseline: prompt-lookup decoding
(suffix n-gram matching against the request's own history), which is
where speculative decoding shines on repetitive prompts — summarization,
code editing, retrieval-heavy serving.
"""
from __future__ import annotations

import abc
from typing import List, Sequence


class DraftProposer(abc.ABC):
    """Per-engine draft-token proposer (stateless across slots unless a
    subclass keeps per-request state keyed on ``request_id``)."""

    @abc.abstractmethod
    def propose(self, seq: Sequence[int], k: int,
                request_id: int = 0) -> List[int]:
        """Up to ``k`` guessed continuation tokens for ``seq`` (prompt +
        everything generated so far, including the still-uncached pending
        token).  Returning fewer than ``k`` (or none) is fine — the
        engine degrades gracefully down to the per-token path."""

    def observe(self, seq: Sequence[int], request_id: int = 0) -> None:
        """Post-commit hook (default: no-op), fired after a speculative
        commit — NOT on prefill, per-token degrade steps, or request
        termination.  ``propose()`` always receives the full sequence,
        which is the only reliable source of truth; a stateful
        small-model drafter must reconcile its own cache against ``seq``
        (e.g. in ``propose``) rather than assume ``observe`` saw every
        token."""


class NgramDrafter(DraftProposer):
    """Prompt-lookup decoding: match the longest recent n-gram suffix of
    the sequence earlier in the sequence and propose what followed it.

    ``max_ngram``/``min_ngram`` bound the suffix length tried (longest
    first — longer matches are more specific and accept more often).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, seq: Sequence[int], k: int,
                request_id: int = 0) -> List[int]:
        seq = list(seq)
        L = len(seq)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = seq[L - n:]
            # most recent earlier occurrence of the suffix n-gram
            for start in range(L - n - 1, -1, -1):
                if seq[start:start + n] == suffix:
                    cont = seq[start + n:start + n + k]
                    if cont:
                        return cont
        return []


class FixedDrafter(DraftProposer):
    """Deterministic canned proposals — test/benchmark scaffolding."""

    def __init__(self, tokens: Sequence[int]):
        self.tokens = list(tokens)

    def propose(self, seq: Sequence[int], k: int,
                request_id: int = 0) -> List[int]:
        return self.tokens[:k]


def get_drafter(name: str, **kwargs) -> DraftProposer:
    """Drafter registry for string configuration (``spec_decode="ngram"``)."""
    if name == "ngram":
        return NgramDrafter(**kwargs)
    raise ValueError(f"unknown drafter {name!r} (have: 'ngram')")
