"""End-to-end training launcher with fault tolerance.

Counterpart of ``src/repro/launch/train.py``: runs QAT (or
full-precision) training of any registered architecture on the
deterministic synthetic pipeline, with periodic atomic checkpoints and
automatic resume from the latest checkpoint — kill the process at any
point and relaunch with the same command to continue bit-exactly (on the
card, under ``torch.use_deterministic_algorithms(True)``).

The flags, defaults and printed lines are the reference's, plus
``--device`` (default ``cuda``; raises without a card).  The step is a
plain eager call of ``make_train_step`` (``remat=False``, as the
reference's) that takes the state donated, as the reference's jitted
step does (AdamW updates the masters and moments in place: gemma2-2b's
state then fits one 80 GB card): every attention layer runs the
flash-attention kernel forward and its backward kernels on a card.

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 \\
      --batch 2 --seq 2048 --microbatches 2 --ckpt-dir /tmp/ckpt
  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --device cpu --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.lower import resolve_device
from ..data import TokenPipeline
from ..models import get_model
from ..optim import AdamW
from ..quant.quantizer import QuantSpec
from ..train import (TrainState, init_train_state, latest_checkpoint,
                     make_train_step, restore_checkpoint, save_checkpoint,
                     step_of)


class TrainRun(NamedTuple):
    """What :func:`run` leaves behind: the loss of each step it ran (from
    ``start_step``), the host seconds of each step (each ends when its
    loss reaches the host), the final state, and the step function and
    pipeline, so that a caller can take one more step."""
    start_step: int
    losses: List[float]
    step_seconds: List[float]
    state: TrainState
    step_fn: Callable[..., Any]
    pipeline: TokenPipeline


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant-bits", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> TrainRun:
    """Parse ``argv``, train, print the reference's lines."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = get_model(cfg, device=device)
    optimizer = AdamW(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    quant = QuantSpec(bits=args.quant_bits) if args.quant_bits else None

    pipeline = TokenPipeline(args.seq, args.batch, cfg.vocab,
                             seed=args.seed)
    # the weights are drawn on the device they live on
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(model, optimizer, gen,
                             compress=args.compress_grads)
    start_step = 0
    if args.ckpt_dir:
        ck = latest_checkpoint(args.ckpt_dir)
        if ck:
            state, extra = restore_checkpoint(ck, state)
            start_step = extra.get("data_step", step_of(ck))
            print(f"resumed from {ck} at step {start_step}", flush=True)

    # the state is donated to the step, as the reference donates it to its
    # jitted step (donate_argnums=(0,)): AdamW updates it in place
    step_fn = make_train_step(
        model, optimizer, microbatches=args.microbatches, quant=quant,
        remat=False, compress=args.compress_grads, donate=True)

    losses: List[float] = []
    step_s: List[float] = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        state, metrics = step_fn(state, pipeline.batch_at(step))
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, state,
                            extra={"data_step": step + 1})
    # the reference saves the last step once more even when the loop has
    # just saved it; the state is the same, so that second write is left
    # out (at full width one checkpoint is tens of GB)
    saved_last = start_step < args.steps and args.steps % args.ckpt_every == 0
    if args.ckpt_dir and not saved_last:
        save_checkpoint(args.ckpt_dir, args.steps, state,
                        extra={"data_step": args.steps})
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return TrainRun(start_step, losses, step_s, state, step_fn, pipeline)


def main(argv: Optional[list] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
