"""Accumulator-aware QAT driver: ``make_train_step`` + ``AdamW`` with
per-step hard budget projection and fault-tolerant checkpointing.

Counterpart of ``src/repro/qat/loop.py`` (eager, where the reference
jits the step).  The projection rides inside the train step via
``AdamW(project=...)`` — it is applied to the f32 *master* weights, the
only place it sticks (params are re-materialized from the masters every
step).  Checkpoints round-trip the full constrained ``TrainState``
through ``repro_torch.train.checkpoint`` and resume bit-identically (the
data stream is keyed by step, the schedule by the optimizer step
counter).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from ..optim.adamw import AdamW
from ..train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                save_checkpoint, step_of)
from ..train.train_step import (TrainState, init_train_state,
                                make_train_step)
from .model import QATMLP


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """One accumulator-aware QAT run (workload + budget + optimizer)."""
    in_dim: int = 16
    hidden: Tuple[int, ...] = (32,)
    classes: int = 4
    weight_bits: int = 4
    act_bits: int = 4
    input_bits: int = 8
    budget: int = 0              # target accumulator bits; 0 = off
    zero_center: bool = False    # A2Q+ variant
    lam: float = 1e-2            # penalty weight
    steps: int = 150
    batch: int = 64
    lr: float = 5e-3
    weight_decay: float = 1e-4
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50

    def make_model(self, device=None) -> QATMLP:
        return QATMLP(in_dim=self.in_dim, hidden=self.hidden,
                      classes=self.classes, weight_bits=self.weight_bits,
                      act_bits=self.act_bits, input_bits=self.input_bits,
                      budget_bits=self.budget,
                      zero_center=self.zero_center, lam=self.lam,
                      seed=self.seed, device=device)


@dataclasses.dataclass
class QATResult:
    config: QATConfig
    model: QATMLP
    state: TrainState
    losses: List[float]
    resumed_from: int = 0
    checkpoint_path: Optional[str] = None
    # host seconds of each step this run took, the step ending when its
    # loss reached the host (which waits for the device)
    step_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def final_loss(self) -> float:
        tail = self.losses[-10:] or [float("nan")]
        return float(np.mean(tail))


def make_optimizer(cfg: QATConfig, model: QATMLP) -> AdamW:
    proj = model.make_projector() if cfg.budget else None
    return AdamW(lr=cfg.lr, weight_decay=cfg.weight_decay,
                 warmup_steps=max(cfg.steps // 10, 1),
                 total_steps=cfg.steps, project=proj)


def run_qat(cfg: QATConfig, model: Optional[QATMLP] = None,
            device=None) -> QATResult:
    """Train (or resume) a QAT run to ``cfg.steps`` and return the final
    constrained state.  The model is ``cfg.make_model(device)`` unless
    one is given; ``device=None`` means the card and raises without
    one."""
    model = model or cfg.make_model(device)
    opt = make_optimizer(cfg, model)
    state = init_train_state(model, opt, cfg.seed)
    step_fn = make_train_step(model, opt, remat=False)

    start, losses = 0, []
    ckpt_path: Optional[str] = None
    if cfg.ckpt_dir:
        ckpt_path = latest_checkpoint(cfg.ckpt_dir)
        if ckpt_path is not None:
            state, extra = restore_checkpoint(ckpt_path, state)
            start = int(extra.get("step", step_of(ckpt_path)))
            losses = list(extra.get("losses", []))

    seconds = []
    for step in range(start, cfg.steps):
        t0 = time.perf_counter()
        batch = model.synth_batch(step, cfg.batch)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        done = step + 1
        if cfg.ckpt_dir and (done % cfg.ckpt_every == 0
                             or done == cfg.steps):
            ckpt_path = save_checkpoint(
                cfg.ckpt_dir, done, state,
                extra={"step": done, "losses": losses})
    return QATResult(config=cfg, model=model, state=state, losses=losses,
                     resumed_from=start, checkpoint_path=ckpt_path,
                     step_seconds=seconds)
