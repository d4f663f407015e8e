"""AdamW with cosine schedule, global-norm clipping and f32 master
weights, on trees of tensors (no ``torch.optim``).

Counterpart of ``src/repro/optim/adamw.py``, in its functional shape:
``init(params) -> state`` and ``update(grads, state, params) -> (params,
state)``, run under ``torch.no_grad()``; no tensor is written in place
unless the caller donates the state (``in_place=True``: the masters and
moments are then updated in their own storage, as XLA reuses the buffers
of the reference's donated train state).
The state holds f32 master weights plus first/second moments; params may
be in a lower precision and are re-materialized from the masters each
step in their own dtype.  The schedule and the bias corrections
``b ** step`` are computed in float32, as the reference computes them.
Params may share storage with the masters (a float32 param is the master
itself after an update): out of place neither is ever written; a donated
state's float32 params change with their masters, as the caller gave
them up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..tree import flatten, leaves, tree_map, unflatten


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
               gnorm: Optional[torch.Tensor] = None, in_place: bool = False
               ) -> Tuple[Any, AdamWState]:
        """One step.  ``gnorm``: the global gradient norm, when ``grads``
        are a rank's blocks of the whole gradient (a sharded train step
        sums the squares over the ranks); default: the norm of
        ``grads``.  ``params`` gives the new params' dtypes only.  The
        leaves are updated one after the other, so only one leaf's
        temporaries are held at a time.  ``in_place``: ``state`` is
        donated, and its masters and moments are written in place (the
        old and the new optimizer state are never held at once, which is
        what lets gemma2-2b's 2.6 B parameters train on one 80 GB card);
        the values are those of the step out of place, bit for bit: the
        same operations in the same order."""
        with torch.no_grad():
            flat_g = leaves(grads)
            if self.clip_norm:
                if gnorm is None:
                    gnorm = torch.sqrt(sum(torch.sum(torch.square(
                        g.to(torch.float32))) for g in flat_g))
                scale = torch.clamp(
                    self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
            step = state.step + 1
            lr = self.schedule(step)
            b1c = 1 - self.b1 ** step.to(torch.float32)
            b2c = 1 - self.b2 ** step.to(torch.float32)

            masters, spec = flatten(state.master)
            new = ([], [], [])
            for g, p, m_, v_ in zip(flat_g, masters, leaves(state.m),
                                    leaves(state.v)):
                g = g.to(torch.float32)
                if self.clip_norm:
                    g = g * scale
                gm = (1 - self.b1) * g
                gv = (1 - self.b2) * g * g
                del g
                if in_place:
                    m_ = m_.mul_(self.b1).add_(gm)
                    v_ = v_.mul_(self.b2).add_(gv)
                else:
                    m_ = self.b1 * m_ + gm
                    v_ = self.b2 * v_ + gv
                del gm, gv
                delta = lr * (m_ / b1c / (torch.sqrt(v_ / b2c) + self.eps)
                              + self.weight_decay * p)
                p = p.sub_(delta) if in_place else p - delta
                for out, x in zip(new, (p, m_, v_)):
                    out.append(x)
            master, m, v = (unflatten(spec, x) for x in new)
            if self.project is not None:
                master = self.project(master)
            new_params = tree_map(lambda mp, p: mp.to(p.dtype), master,
                                  params)
        return new_params, AdamWState(step=step, master=master, m=m, v=v)
