"""Elastic / fault-tolerant training supervision.

SPMD collectives make in-step straggler work-stealing impossible — the
production mitigation is (a) cheap frequent checkpoints, (b) a supervisor
that restarts the job on failure, resuming from the latest checkpoint,
and (c) elastic re-partitioning of the data stream when the healthy host
set changes (the pipeline is indexed by global example id, so any host
count re-partitions the same stream with no replay — tested in
tests/test_torch_train.py).

``run_supervised`` is the single-host embodiment used by the integration
test: it runs a training function that may raise (simulated preemption /
hardware fault) and resumes from the latest checkpoint until the step
budget completes.  On a real cluster the same loop runs under the cluster
scheduler, with ``torch.distributed.init_process_group`` per restart.
Counterpart of ``src/repro/train/elastic.py``, host-only.

Checkpoint cadence guidance: with mean-time-between-failures F and
checkpoint cost c, the optimal interval is ~sqrt(2·c·F) (Young/Daly);
at c ≈ 30 s (npz of a 2.5 B-param state) and F ≈ 6 h, that is every
~19 min.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .checkpoint import latest_checkpoint, step_of


@dataclasses.dataclass
class SupervisionReport:
    restarts: int
    completed_steps: int
    resumed_from: list


def run_supervised(train_fn: Callable[[int], int], total_steps: int,
                   ckpt_dir: str, max_restarts: int = 16
                   ) -> SupervisionReport:
    """Run ``train_fn(start_step) -> reached_step`` to completion.

    ``train_fn`` trains from ``start_step`` and either returns the step it
    reached (== total_steps when done) or raises on a (simulated) fault.
    After each fault we resume from the latest checkpoint's step."""
    restarts = 0
    resumed_from = []
    step = 0
    while step < total_steps:
        try:
            step = train_fn(step)
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            ck = latest_checkpoint(ckpt_dir)
            step = step_of(ck) if ck else 0
            resumed_from.append(step)
    return SupervisionReport(restarts=restarts, completed_steps=step,
                             resumed_from=resumed_from)
