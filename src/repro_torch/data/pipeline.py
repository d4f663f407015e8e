"""Deterministic, shardable, resumable synthetic token pipeline.

Every example is a pure function of its global example id (counter-based
PRNG), so the stream is:
  * deterministic across restarts (resume = set the cursor),
  * elastically re-shardable: any host count H re-partitions the same
    global stream as ids {host, host+H, host+2H, ...} without replay,
  * order-independent for validation.

The synthetic task is Zipf-distributed token n-gram copying — enough
structure for loss to fall during the example runs.

Counterpart of ``src/repro/data/pipeline.py``, numpy only (counter-based
Philox): its batches equal the reference's, array for array.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


def _example_tokens(example_id: int, seq_len: int, vocab: int,
                    seed: int) -> np.ndarray:
    rng = np.random.Philox(key=np.uint64(seed) + np.uint64(example_id))
    g = np.random.Generator(rng)
    # zipf-ish marginal + copy structure: second half echoes the first
    base = (g.zipf(1.5, size=seq_len).astype(np.int64) - 1) % vocab
    half = seq_len // 2
    base[half:half * 2] = base[:half]
    return base.astype(np.int32)


@dataclasses.dataclass
class DataState:
    step: int = 0


class TokenPipeline:
    def __init__(self, seq_len: int, global_batch: int, vocab: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.vocab = vocab
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        assert global_batch % n_hosts == 0
        self.local_batch = global_batch // n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Local shard of the global batch for ``step`` (stateless)."""
        ids = (step * self.global_batch + self.host_id
               + np.arange(self.local_batch) * self.n_hosts)
        toks = np.stack([_example_tokens(int(i), self.seq_len + 1,
                                         self.vocab, self.seed)
                         for i in ids])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, state: Optional[DataState] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        state = state or DataState()
        while True:
            yield self.batch_at(state.step)
            state.step += 1
