"""AdamW with cosine schedule, global-norm clipping and f32 master
weights, on trees of tensors (no ``torch.optim``).

Counterpart of ``src/repro/optim/adamw.py``, in its functional shape:
``init(params) -> state`` and ``update(grads, state, params) -> (params,
state)``, run under ``torch.no_grad()``; no tensor is written in place.
The state holds f32 master weights plus first/second moments; params may
be in a lower precision and are re-materialized from the masters each
step in their own dtype.  The schedule and the bias corrections
``b ** step`` are computed in float32, as the reference computes them.
Params may share storage with the masters (a float32 param is the master
itself after an update): neither is ever written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    master: Any          # f32 master weights
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # Optional post-step projection onto a constraint set (tree -> tree).
    # Applied to the f32 *master* weights — the params handed back each
    # step are re-materialized from the masters, so projecting params
    # alone would be undone on the next update.  Used by repro_torch.qat
    # for A2Q accumulator-budget projection.
    project: Optional[Callable[[Any], Any]] = None

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - self.warmup_steps)
                        / max(self.total_steps - self.warmup_steps, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def init(self, params: Any) -> AdamWState:
        with torch.no_grad():
            f32 = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                           params)
            flat = leaves(f32)
            device = flat[0].device if flat else None
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=device),
                master=f32, m=tree_map(torch.zeros_like, f32),
                v=tree_map(torch.zeros_like, f32))

    def update(self, grads: Any, state: AdamWState, params: Any, *,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, AdamWState]:
        """One step.  ``gnorm``: the global gradient norm, when ``grads``
        are a rank's blocks of the whole gradient (a sharded train step
        sums the squares over the ranks); default: the norm of
        ``grads``.  ``params`` gives the new params' dtypes only."""
        with torch.no_grad():
            g32 = tree_map(lambda g: g.to(torch.float32), grads)
            if self.clip_norm:
                if gnorm is None:
                    gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                           for g in leaves(g32)))
                scale = torch.clamp(
                    self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
                g32 = tree_map(lambda g: g * scale, g32)
            step = state.step + 1
            lr = self.schedule(step)
            b1c = 1 - self.b1 ** step.to(torch.float32)
            b2c = 1 - self.b2 ** step.to(torch.float32)

            m = tree_map(lambda m_, g: self.b1 * m_ + (1 - self.b1) * g,
                         state.m, g32)
            v = tree_map(lambda v_, g: self.b2 * v_ + (1 - self.b2) * g * g,
                         state.v, g32)

            def upd(p, m_, v_):
                mh = m_ / b1c
                vh = v_ / b2c
                return p - lr * (mh / (torch.sqrt(vh) + self.eps)
                                 + self.weight_decay * p)

            master = tree_map(upd, state.master, m, v)
            if self.project is not None:
                master = self.project(master)
            new_params = tree_map(lambda mp, p: mp.to(p.dtype), master,
                                  params)
        return new_params, AdamWState(step=step, master=master, m=m, v=v)
