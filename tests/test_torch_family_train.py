"""Training parity of the MoE, Mamba2, Zamba2, vlm and audio families
and of the dense glm4-9b, granite-3-2b and gemma2-2b (its local and
global layers, window and soft-caps): three steps of the port's ``make_train_step`` (two microbatches; the vlm
and audio configs with a ``frontend_embed`` in the batch) against
``jax.jit`` of the reference's ``make_train_step``, from the reference's
weights carried across by ``load_reference_params``, on the CPU, at the
reduced configs.

Bars, float32: each step's loss within 1e-5 relative; after each step,
every master within 1e-5 of the largest master (not of the leaf's own
scale: AdamW's first steps turn a gradient near its eps into any step in
[-lr, lr], so a rounding-level difference there moves that element by up
to lr) -- the bars of ``test_torch_tp_train.py``'s steps against the
reference.  ``launch.train`` on these archs (its printed lines, a kill and
a bit-exact resume) is held by ``tests/test_torch_launch.py``.

Mamba2 and Zamba2 train with their SSD chunk cut from the reduced
configs' 32 to 4 tokens, in both packages, so the 64-token sequences
span 16 chunks and the backward through the state carried between
chunks is held to the reference's.  At the chunk of 32, from 32 tokens
on, a chunk's decays overflow float32 above the diagonal and the
reference's gradient is NaN (reference fault 12, ROADMAP C:
``jnp.where(causal, jnp.exp(-seg), 0)`` differentiates the overflowed
exp, ``src/repro/models/ssm.py:96-97``; its SSD runs in float32 whatever
the model's dtype, so float64 does not help); a chunk of 4 sums at most
three steps' decays.  The port masks ``seg`` before the exp and stays
finite there, pinned below at the reduced configs' own chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.optim import AdamW as JAdamW
from repro.train import (init_train_state as j_init_train_state,
                         make_train_step as j_make_train_step)
from repro_torch.configs import get_config
from repro_torch.models import get_model, load_reference_params
from repro_torch.optim import AdamW
from repro_torch.train import init_train_state, make_train_step
from test_torch_train import _dotted

FAMILY_ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-780m",
                "zamba2-2.7b", "musicgen-medium", "internvl2-26b", "glm4-9b",
                "granite-3-2b", "gemma2-2b"]
SSD_ARCHS = ("mamba2-780m", "zamba2-2.7b")
STEPS = 3
BATCH, SEQ = 4, 64
SSD_CHUNK = 4               # where the reference's SSD gradient is finite
MICROBATCHES = 2
LOSS_TOL = 1e-5             # relative
MASTER_TOL = 1e-5           # of the largest master


def _optimizer(cls):
    # launch/train.py's schedule for a run of STEPS steps
    return cls(lr=3e-3, warmup_steps=5, total_steps=STEPS)


def _batches(cfg, seq, seed=3):
    """STEPS batches of seeded tokens (inputs and next-token labels), with
    a seeded frontend embedding for the vlm and audio configs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab, (BATCH, seq + 1)).astype(np.int32)
        batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
        if cfg.frontend != "none":
            batch["frontend_embed"] = rng.normal(
                size=(BATCH, cfg.frontend_len, cfg.d_model)).astype(
                    np.float32)
        out.append(batch)
    return out


def _chunked(cfg, chunk):
    """``cfg`` with its SSD chunk set to ``chunk`` (None: as it is)."""
    if chunk is None:
        return cfg
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


def _pair(arch, chunk=None):
    """(the port's config, the reference's step-0 state and jitted step,
    the port's step-0 state with the reference's weights and its step),
    both in MICROBATCHES microbatches, the SSD chunk set to ``chunk`` in
    both packages' configs where it is given."""
    jm = j_get_model(_chunked(j_get_config(arch, reduced=True), chunk))
    j_opt = _optimizer(JAdamW)
    js = j_init_train_state(jm, j_opt, jax.random.PRNGKey(0))
    j_step = jax.jit(j_make_train_step(jm, j_opt, microbatches=MICROBATCHES,
                                       remat=False))
    cfg = _chunked(get_config(arch, reduced=True), chunk)
    tm = get_model(cfg, device="cpu").load_reference_params(
        jax.tree.map(np.asarray, js.params))
    opt = _optimizer(AdamW)
    ts = init_train_state(tm, opt, 0, params=tm.param_tree())
    step = make_train_step(tm, opt, microbatches=MICROBATCHES, remat=False)
    return cfg, js, j_step, ts, step


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_three_steps_match_the_compiled_reference(arch):
    """Losses and masters of three steps in two microbatches against the
    reference's jitted step, every leaf's master compared."""
    cfg, js, j_step, ts, step = _pair(
        arch, SSD_CHUNK if arch in SSD_ARCHS else None)
    if arch in SSD_ARCHS:
        assert SEQ // cfg.ssm.chunk > 2
    for i, batch in enumerate(_batches(cfg, SEQ)):
        js, jmet = j_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = step(ts, batch)
        want = float(jmet["loss"])
        assert abs(float(tmet["loss"]) - want) <= LOSS_TOL * abs(want), \
            (i, float(tmet["loss"]), want)
        ref = load_reference_params(
            cfg, jax.tree.map(np.asarray, js.opt.master))
        assert all(bool(torch.isfinite(v).all()) for v in ref.values())
        got = _dotted(ts.opt.master)
        assert sorted(got) == sorted(ref)
        top = max(float(v.abs().max()) for v in ref.values())
        for name, w in ref.items():
            d = float((got[name].double() - w.double()).abs().max())
            assert d <= MASTER_TOL * top, (i, name, d / top)


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_fault_12_reference_ssd_gradient_is_nan_where_the_port_is_finite(
        arch):
    """Reference fault 12: at 64-token sequences the reference's first
    step leaves NaN in its masters (its SSD differentiates an exp that
    overflowed above the diagonal), while the port's step from the same
    weights has the same loss and finite masters and parameters."""
    cfg, js, j_step, ts, step = _pair(arch)
    batch = _batches(cfg, SEQ)[0]
    js, jmet = j_step(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tmet = step(ts, batch)
    want = float(jmet["loss"])
    assert abs(float(tmet["loss"]) - want) <= LOSS_TOL * abs(want)
    ref = load_reference_params(cfg, jax.tree.map(np.asarray, js.opt.master))
    assert not all(bool(torch.isfinite(v).all()) for v in ref.values())
    got = _dotted(dict(master=ts.opt.master, params=ts.params))
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
