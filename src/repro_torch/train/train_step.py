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

A model sharded over a layout of more than one rank (``Model.shard``)
trains split: every rank takes the same global batch and runs its share
of each global microbatch (the rows of its ("pod", "data") index); the
loss and the gradients are averaged over those axes; AdamW's float32
masters and moments are ZeRO-split over "data" (``launch/shardings.py
train_plan``: the reference's ``opt_pspecs``), so each rank updates its
block and the new params are joined by ``all_gather``; the global
gradient norm counts every element of the whole model once.  The
update is elementwise, so the masters equal the unsharded step's up to
float32 summation order.
"""
from __future__ import annotations

import functools
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
    slices = zero_slices(params, model)
    opt = optimizer.init(slices)
    ef = init_error_feedback(slices) if compress else None
    return TrainState(params=params, opt=opt, error_feedback=ef,
                      rng=torch.tensor(seed, dtype=torch.int64))


def _layout(model):
    """The layout of a sharded LM (``Model.shard``) spanning more than one
    rank, else None."""
    layout = getattr(model, "layout", None)
    return layout if layout is not None and layout.n_devices > 1 else None


def zero_slices(tree: Any, model) -> Any:
    """The blocks of ``tree`` (a sharded model's params, or a tree like
    them) that this rank's AdamW state holds: each leaf's block along
    its ZeRO dim on "data" (``launch/shardings.py train_plan``), the leaf
    itself where it has none.  The tree itself without a layout."""
    layout = _layout(model)
    if layout is None:
        return tree
    from ..launch.shardings import train_plan
    plans = leaves(train_plan(model.cfg, layout))
    flat, spec = flatten(tree)
    return unflatten(spec, [_zero_block(t, p, layout)
                            for t, p in zip(flat, plans)])


def _zero_block(t: torch.Tensor, plan, layout) -> torch.Tensor:
    if plan.zero_dim is None:
        return t
    step = t.shape[plan.zero_dim] // layout.size("data")
    return t.narrow(plan.zero_dim, layout.index("data") * step, step)


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def make_train_step(model, optimizer: AdamW, *,
                    microbatches: int = 1,
                    quant: Optional[QuantSpec] = None,
                    remat: bool = True,
                    compress: bool = False,
                    return_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: tokens/labels (B_global, S) (+ optional frontend_embed), numpy
    arrays or tensors; they are moved to the params' device.  ``remat``
    is handed to ``model.loss``: the LM recomputes each layer in the
    backward pass (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does; the QAT MLP ignores it, as the reference's
    does.  metrics: ``loss``, ``grad_norm``, ``lr`` (0-d tensors), and
    with ``return_grads`` ``grads``: the gradient AdamW takes (before
    clipping; under a layout the rank's blocks of the data-averaged
    one)."""

    def loss_and_grads(params, mb):
        flat, spec = flatten(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        loss = model.loss(unflatten(spec, live), mb["tokens"], mb["labels"],
                          mb.get("frontend_embed"), quant=quant, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return loss.detach(), unflatten(spec, grads)

    layout = _layout(model)
    plans = None
    if layout is not None:
        from ..launch.shardings import train_plan
        plans = leaves(train_plan(model.cfg, layout))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        device = leaves(state.params)[0].device
        batch = _on(batch, device)
        if microbatches > 1 or layout is not None:
            mbs = {k: None if a is None else _microbatches(
                a, microbatches, layout) for k, a in batch.items()}
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
            if layout is not None:        # consumes acc, leaf by leaf
                return _sharded_update(state, loss, acc)
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
        if return_grads:
            metrics["grads"] = grads
        return TrainState(params=new_params, opt=new_opt,
                          error_feedback=ef, rng=state.rng), metrics

    def _sharded_update(state: TrainState, loss, flat):
        """Data parallelism and ZeRO: the loss and the grads averaged over
        ("pod", "data"), each ZeRO leaf's grad reduce-scattered to this
        rank's block, the global norm summed over every rank (each
        element once: ``LeafPlan.owned`` over "model", ZeRO blocks over
        "data", the rest on data rank 0), AdamW on the blocks, and the
        new params joined by ``all_gather`` over "data".  ``flat``: the
        float32 grads in leaf order, replaced by their blocks in place,
        so that each whole grad is freed as its block is made."""
        n_data = layout.size(BATCH_AXES)
        with torch.no_grad():
            loss = layout.all_reduce(loss, BATCH_AXES) / n_data
            for i, p in enumerate(plans):
                flat[i] = _reduce_grad(flat[i], p).div_(n_data)
            sq = sum(_owned_square_sum(g, p, layout)
                     for g, p in zip(flat, plans))
            gnorm = torch.sqrt(layout.all_reduce(
                sq, ("model", "data", "pod")))
            grads = unflatten(flatten(state.params)[1], flat)
        ef = state.error_feedback
        if compress:
            grads, ef = compress_grads(grads, ef, amax=functools.partial(
                layout.max, axis=("model", "data")))
        blocks, new_opt = optimizer.update(grads, state.opt, state.params,
                                           gnorm=gnorm)
        with torch.no_grad():
            flat, spec = flatten(blocks)
            new_params = unflatten(spec, [
                b if p.zero_dim is None else
                layout.all_gather(b, "data", dim=p.zero_dim)
                for b, p in zip(flat, plans)])
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": optimizer.schedule(new_opt.step)}
        if return_grads:
            metrics["grads"] = grads
        return TrainState(params=new_params, opt=new_opt,
                          error_feedback=ef, rng=state.rng), metrics

    def _reduce_grad(g: torch.Tensor, plan) -> torch.Tensor:
        g = layout.all_reduce(g, "pod")
        if plan.zero_dim is None:
            return layout.all_reduce(g, "data")
        return layout.reduce_scatter(g, "data", plan.zero_dim)

    return train_step


#: the axes a batch is split over (``launch/shardings.py batch_pspec``)
BATCH_AXES = ("pod", "data")


def _microbatches(a: torch.Tensor, n: int, layout) -> torch.Tensor:
    """(n, rows, ...) microbatches of a global batch: the reference's
    reshape (n, B/n), and under a layout this rank's block of each
    microbatch's rows over ("pod", "data"), so that rank r's microbatch i
    is its share of the global microbatch i."""
    a = a.reshape((n, a.shape[0] // n) + a.shape[1:])
    if layout is None:
        return a
    from ..launch.shardings import _block
    if a.shape[1] % layout.size(BATCH_AXES):
        raise ValueError(f"a microbatch of {a.shape[1]} rows does not "
                         f"split over the {layout.size(BATCH_AXES)} data "
                         f"ranks")
    return _block(a, 1, layout, BATCH_AXES)


def _owned_square_sum(g: torch.Tensor, plan, layout) -> torch.Tensor:
    """This rank's share of the gradient's squared norm: the elements it
    owns over "model" (``plan.owned``), all of a ZeRO block, and a leaf
    every data rank holds whole on data rank 0 only; nothing on a pod
    other than the first (every pod holds the same blocks)."""
    if layout.index("pod") != 0 or (plan.zero_dim is None and
                                    layout.index("data") != 0):
        return g.new_zeros(())
    owned = plan.owned
    if isinstance(owned, bool):
        return torch.sum(torch.square(g)) if owned else g.new_zeros(())
    mask = owned.to(g.device)
    if plan.zero_dim is not None and plan.zero_dim % g.dim() == g.dim() - 1:
        mask = _zero_block(mask, plan, layout)
    return torch.sum(torch.square(g) * mask)
