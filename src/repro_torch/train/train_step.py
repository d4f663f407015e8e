"""Training step: microbatched gradient accumulation, QAT fake-quant,
remat, optional scaled-integer gradient compression with error feedback.

Counterpart of ``src/repro/train/train_step.py``.  ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the param leaves, which each step
detaches and marks ``requires_grad`` (the state's tensors are never
changed in place); the microbatch ``lax.scan`` becomes a loop that
accumulates float32 grads in place (its own tensors, never the
state's).  The model protocol is the reference's:
``model.init(generator)`` gives the params (or, for the LM
:class:`~repro_torch.models.transformer.Model`, fills and returns the
model, whose ``param_tree()`` gives them) and ``model.loss(params,
tokens, labels, frontend_embed, quant=..., remat=...)`` a scalar.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Union

import torch

from ..optim.adamw import AdamW, AdamWState
from ..quant.quantizer import QuantSpec
from ..tree import flatten, leaves, unflatten
from .compression import compress_grads, init_error_feedback


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    error_feedback: Any       # None when compression disabled
    rng: torch.Tensor         # the init seed, int64 0-d


def init_train_state(model, optimizer: AdamW,
                     key: Union[int, torch.Generator],
                     compress: bool = False,
                     params: Any = None) -> TrainState:
    """The state at step 0.  ``key`` is a seed or a CPU
    ``torch.Generator`` that ``model.init`` draws from; ``params`` (a tree
    of tensors) starts from given weights instead, e.g. weights carried
    across from the reference."""
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key))
    seed = gen.initial_seed()
    if params is None:
        params = model.init(gen)
        if hasattr(params, "param_tree"):     # the LM fills itself
            params = params.param_tree()
    opt = optimizer.init(params)
    ef = init_error_feedback(params) if compress else None
    return TrainState(params=params, opt=opt, error_feedback=ef,
                      rng=torch.tensor(seed, dtype=torch.int64))


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def make_train_step(model, optimizer: AdamW, *,
                    microbatches: int = 1,
                    quant: Optional[QuantSpec] = None,
                    remat: bool = True,
                    compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tokens/labels (B_global, S) (+ optional frontend_embed), numpy
    arrays or tensors; they are moved to the params' device.  ``remat``
    is handed to ``model.loss``: the LM recomputes each layer in the
    backward pass (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does; the QAT MLP ignores it, as the reference's
    does.  metrics: ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""

    def loss_and_grads(params, mb):
        flat, spec = flatten(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        loss = model.loss(unflatten(spec, live), mb["tokens"], mb["labels"],
                          mb.get("frontend_embed"), quant=quant, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return loss.detach(), unflatten(spec, grads)

    def train_step(state: TrainState, batch: Dict[str, Any]):
        device = leaves(state.params)[0].device
        batch = _on(batch, device)
        if microbatches > 1:
            mbs = {k: None if a is None else a.reshape(
                (microbatches, a.shape[0] // microbatches) + a.shape[1:])
                for k, a in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=device)
            acc = None
            for i in range(microbatches):
                mb = {k: None if a is None else a[i] for k, a in mbs.items()}
                l_i, g_i = loss_and_grads(state.params, mb)
                loss = loss + l_i
                # float32 sums in place: the first microbatch's grads
                # (exact in float32) start the sum, so no zero tree and
                # no second tree of sums is ever held
                if acc is None:
                    acc = [g.to(torch.float32) for g in leaves(g_i)]
                else:
                    for a, g in zip(acc, leaves(g_i)):
                        a.add_(g)
                del g_i
            loss = loss / microbatches
            for a in acc:
                a.div_(microbatches)
            grads = unflatten(flatten(state.params)[1], acc)
        else:
            loss, grads = loss_and_grads(state.params, batch)

        ef = state.error_feedback
        if compress:
            grads, ef = compress_grads(grads, ef)

        new_params, new_opt = optimizer.update(grads, state.opt,
                                               state.params)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for g in leaves(grads)))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": optimizer.schedule(new_opt.step)}
        return TrainState(params=new_params, opt=new_opt,
                          error_feedback=ef, rng=state.rng), metrics

    return train_step
