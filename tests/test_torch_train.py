"""Port parity for the training stack: ``repro_torch.quant.calibrate``,
``data``, ``optim``, ``train`` and ``Model.loss`` against the JAX package
on the same numpy inputs, on the CPU, plus the port's own invariants
(microbatching, checkpoint/resume, supervision), mirrored from
``tests/test_train.py``.

Tolerances (float32 unless stated):
  * observers, pipeline batches, the int8 gradient payload and its scale:
    equal;
  * AdamW, five updates from the same params and grads: masters, ``m``
    and ``v`` within ``1e-6`` relative to each leaf's largest magnitude
    (reductions and ``pow`` in another order / library);
  * error-feedback compression, three steps: within ``1e-7`` absolute
    (grads of unit scale);
  * the LM step (reduced qwen2-1.5b, the reference's weights carried
    across by ``load_reference_params``): step-1 grads within ``1e-4`` of
    each leaf's largest ``|g|``, compared before AdamW normalises them
    (there a rounding-level difference in a near-zero grad becomes
    ``±lr``); three steps' losses within ``1e-5`` relative.
"""
import dataclasses
import gc
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import get_model as j_get_model
from repro.optim import AdamW as JAdamW
from repro.quant import calibrate as j_cal
from repro.quant.quantizer import QuantSpec as JQuantSpec
from repro.train import (init_train_state as j_init_train_state,
                         make_train_step as j_make_train_step)
from repro.train import compression as j_comp
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import get_model, load_reference_params
from repro_torch.optim import AdamW
from repro_torch.quant import calibrate as t_cal
from repro_torch.quant.quantizer import QuantSpec
from repro_torch.train import (compress_grads, compressed_psum,
                               init_error_feedback, init_train_state,
                               latest_checkpoint, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train import compression as t_comp
from repro_torch.train.elastic import run_supervised
from repro_torch.tree import flatten, leaves, unflatten

ARCH = "qwen2-1.5b"


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


# ------------------------------------------------------------ calibrate

@pytest.mark.parametrize("observer", ["minmax", "percentile"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_observers_equal_reference(observer, symmetric):
    rng = np.random.default_rng(3)
    batches = [rng.standard_t(3, size=(64, 40)).astype(np.float32) + i
               for i in range(3)]
    j_spec = JQuantSpec(bits=8, signed=symmetric, symmetric=symmetric)
    t_spec = QuantSpec(bits=8, signed=symmetric, symmetric=symmetric)
    if observer == "minmax":
        j_obs, t_obs = (j_cal.MinMaxObserver(j_spec),
                        t_cal.MinMaxObserver(t_spec))
    else:
        j_obs, t_obs = (j_cal.PercentileObserver(j_spec, 0.5),
                        t_cal.PercentileObserver(t_spec, 0.5))
    for b in batches:
        j_obs.update(b)
        t_obs.update(torch.from_numpy(b))
    for got, want in zip(t_obs.scale_zp(), j_obs.scale_zp()):
        np.testing.assert_array_equal(got, want)


def test_calibrate_model_equals_reference():
    rng = np.random.default_rng(4)
    batches = [rng.normal(size=(16, 8)).astype(np.float32) for _ in range(3)]
    w = rng.normal(size=(8, 8)).astype(np.float32)

    def j_apply(p, x):
        return {"h": np.maximum(x @ p, 0.0), "x": x}

    def t_apply(p, x):
        x = torch.from_numpy(x)
        return {"h": torch.relu(x @ torch.from_numpy(p)), "x": x}

    want = j_cal.calibrate_model(j_apply, w, batches, ["h", "x"],
                                 JQuantSpec(bits=4, signed=False,
                                            symmetric=False))
    got = t_cal.calibrate_model(t_apply, w, batches, ["h", "x"],
                                QuantSpec(bits=4, signed=False,
                                          symmetric=False))
    for tap in want:
        for g, w_ in zip(got[tap], want[tap]):
            np.testing.assert_allclose(g, w_, rtol=1e-6)


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_pipeline_equals_reference_and_reshards(n_hosts):
    """Every host's shard equals the reference's, array for array, and
    the shards of any host count interleave to the one-host batch."""
    full = TokenPipeline(seq_len=16, global_batch=8, vocab=100, seed=3
                         ).batch_at(7)
    merged = {k: np.empty_like(v) for k, v in full.items()}
    for h in range(n_hosts):
        kw = dict(seq_len=16, global_batch=8, vocab=100, seed=3,
                  host_id=h, n_hosts=n_hosts)
        got = TokenPipeline(**kw).batch_at(7)
        want = JTokenPipeline(**kw).batch_at(7)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
            merged[k][h::n_hosts] = got[k]
    for k in full:
        np.testing.assert_array_equal(merged[k], full[k])


# ---------------------------------------------------------------- AdamW

def _adamw_case(case):
    """(optimizer keywords, grad scale, projection) of one case."""
    if case == "clip_active":
        return dict(clip_norm=1.0, warmup_steps=2, total_steps=10), 3.0, None
    if case == "clip_inactive":
        return dict(clip_norm=1e6, warmup_steps=2, total_steps=10), 0.1, None
    if case == "warmup":
        # all five steps inside the warmup, the schedule rising
        return dict(warmup_steps=8, total_steps=20, min_lr_frac=0.3), 1.0, \
            None
    return dict(warmup_steps=1, total_steps=5), 1.0, "clip_to_half"


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive", "warmup",
                                  "project"])
def test_adamw_five_updates_match_reference(case):
    kw, gscale, proj = _adamw_case(case)
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(12, 5)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32)]}
    grads = [{"a": (rng.normal(size=(12, 5)) * gscale).astype(np.float32),
              "b": [(rng.normal(size=(7,)) * gscale).astype(np.float32)]}
             for _ in range(5)]
    j_proj = t_proj = None
    if proj:
        j_proj = lambda t: jax.tree.map(lambda x: jnp.clip(x, -.5, .5), t)
        t_proj = lambda t: {"a": torch.clamp(t["a"], -.5, .5),
                            "b": [torch.clamp(x, -.5, .5) for x in t["b"]]}
    j_opt = JAdamW(lr=1e-2, project=j_proj, **kw)
    t_opt = AdamW(lr=1e-2, project=t_proj, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"]),
          "b": [torch.from_numpy(params["b"][0])]}
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.update({"a": torch.from_numpy(g["a"]),
                               "b": [torch.from_numpy(g["b"][0])]}, ts, tp)
    assert int(ts.step) == int(js.step) == 5
    for part in ("master", "m", "v"):
        for got, want in zip(leaves(getattr(ts, part)),
                             jax.tree.leaves(getattr(js, part))):
            _close(got.numpy(), np.asarray(want), 1e-6)
    if proj:
        assert all(float(t.abs().max()) <= .5 for t in leaves(ts.master))
    for got, want in zip(leaves(tp), jax.tree.leaves(jp)):
        _close(got.numpy(), np.asarray(want), 1e-6)
    np.testing.assert_allclose(float(t_opt.schedule(ts.step)),
                               float(j_opt.schedule(js.step)), rtol=1e-7)


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive", "warmup",
                                  "project"])
def test_adamw_in_place_equals_out_of_place(case):
    """A donated state (``in_place=True``, what the launcher's step does,
    as the reference donates its state) gives the same five updates bit
    for bit, and its moments (and masters, without a projection) are
    the donated tensors themselves, updated in their own storage."""
    kw, gscale, proj = _adamw_case(case)
    rng = np.random.default_rng(12)
    params = {"a": torch.from_numpy(rng.normal(size=(12, 5)).astype(
        np.float32)).to(torch.bfloat16),
        "b": [torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))]}
    grads = [{"a": torch.from_numpy((rng.normal(size=(12, 5)) * gscale)
                                    .astype(np.float32)),
              "b": [torch.from_numpy((rng.normal(size=(7,)) * gscale)
                                     .astype(np.float32))]}
             for _ in range(5)]
    t_proj = (lambda t: {"a": torch.clamp(t["a"], -.5, .5),
                         "b": [torch.clamp(x, -.5, .5) for x in t["b"]]}) \
        if proj else None
    opt = AdamW(lr=1e-2, project=t_proj, **kw)
    out_p, out_s = params, opt.init(params)
    in_p, in_s = params, opt.init(params)
    for g in grads:
        out_p, out_s = opt.update(g, out_s, out_p)
        before = [t.data_ptr() for t in leaves(in_s.m) + leaves(in_s.v)
                  + leaves(in_s.master)]
        in_p, in_s = opt.update(g, in_s, in_p, in_place=True)
        after = [t.data_ptr() for t in leaves(in_s.m) + leaves(in_s.v)
                 + leaves(in_s.master)]
        kept = 4 if proj else 6
        assert before[:kept] == after[:kept]
    for part in ("master", "m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(getattr(out_s, part)), leaves(getattr(in_s, part))))
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(leaves(out_p), leaves(in_p)))


# ---------------------------------------------------------- compression

def test_quantize_tensor_payload_bit_equal():
    rng = np.random.default_rng(0)
    g = (rng.normal(size=(64, 64)) * 1e-3).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]           # halves: round to even
    qj, sj = j_comp.quantize_tensor(jnp.asarray(g))
    qt, st = t_comp.quantize_tensor(torch.from_numpy(g))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    deq = t_comp.dequantize_tensor(qt, st)
    assert float((deq - torch.from_numpy(g)).abs().max()) <= \
        float(st) * 0.5 + 1e-12


def test_error_feedback_three_steps_match_reference():
    """Against ``jax.jit(compress_grads)``: the reference compresses inside
    its jitted step, where the scale is ``amax * float32(1/127)`` and the
    error ``g - q*s`` one fused multiply-add (C5)."""
    rng = np.random.default_rng(1)
    gs = [{"w": (rng.normal(size=(32,)) * s).astype(np.float32),
           "v": [rng.normal(size=(3, 4)).astype(np.float32)]}
          for s in (1.0, 1e-4, 0.3)]
    j_ef = j_comp.init_error_feedback(jax.tree.map(jnp.asarray, gs[0]))
    t_ef = init_error_feedback({"w": torch.zeros(32),
                                "v": [torch.zeros(3, 4)]})
    for g in gs:
        j_deq, j_ef = jax.jit(j_comp.compress_grads)(
            jax.tree.map(jnp.asarray, g), j_ef)
        t_deq, t_ef = compress_grads(
            {"w": torch.from_numpy(g["w"]),
             "v": [torch.from_numpy(g["v"][0])]}, t_ef)
        for got, want in zip(leaves(t_deq) + leaves(t_ef),
                             jax.tree.leaves(j_deq) + jax.tree.leaves(j_ef)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-7)


def test_compressed_psum_over_a_one_rank_axis():
    """Over an axis of one rank the int8 all-reduce is the reference's
    quantize → dequantize of ``compress_grads``; an axis with no layout
    raises.  (Two ranks: ``tests/test_torch_tp.py``.)"""
    from repro_torch.launch.mesh import make_layout, use_layout
    g = np.random.default_rng(3).normal(size=(257,)).astype(np.float32)
    q, s = j_comp.quantize_tensor(jnp.asarray(g))
    want = np.asarray(j_comp.dequantize_tensor(q, s))
    with use_layout(make_layout((1, 1, 1), ("pod", "data", "model"))):
        got = compressed_psum(torch.from_numpy(g), "pod")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(RuntimeError, match="no layout"):
        compressed_psum(torch.from_numpy(g), "pod")


# ------------------------------------------------ the LM step (reduced)

_LM = {}


def _lm():
    """(reference model, its optimizer, state and jitted step; the
    port's model, optimizer, step-0 state with the reference's weights,
    and a function making port steps; the pipeline), built once."""
    if not _LM:
        jcfg = j_get_config(ARCH, reduced=True)
        jm = j_get_model(jcfg)
        j_opt = JAdamW(lr=3e-3, warmup_steps=2, total_steps=50)
        js = j_init_train_state(jm, j_opt, jax.random.PRNGKey(0))
        j_step = jax.jit(j_make_train_step(jm, j_opt, remat=False))
        cfg = get_config(ARCH, reduced=True)
        tm = get_model(cfg, device="cpu").load_reference_params(
            jax.tree.map(np.asarray, js.params))
        opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=50)
        ts = init_train_state(tm, opt, 0, params=tm.param_tree())
        pipe = TokenPipeline(seq_len=32, global_batch=4, vocab=cfg.vocab)
        _LM.update(jm=jm, js=js, j_step=j_step, cfg=cfg, tm=tm, opt=opt,
                   ts=ts, pipe=pipe)
    return _LM


def _dotted(tree, prefix=""):
    """A params/grads tree → {"layers.0.attn.wq": tensor, ...}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_dotted(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_dotted(v, f"{prefix}.{i}"))
        return out
    return {prefix: tree}


def test_lm_loss_grads_match_reference():
    lm = _lm()
    b = lm["pipe"].batch_at(0)
    j_grads = jax.grad(lambda p: lm["jm"].loss(
        p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])))(
        lm["js"].params)
    want = load_reference_params(lm["cfg"],
                                 jax.tree.map(np.asarray, j_grads))
    flat, spec = flatten(lm["ts"].params)
    live = [p.detach().requires_grad_(True) for p in flat]
    loss = lm["tm"].loss(unflatten(spec, live), torch.from_numpy(b["tokens"]),
                         torch.from_numpy(b["labels"]))
    got = _dotted(unflatten(spec, list(torch.autograd.grad(loss, live))))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


def test_lm_three_steps_losses_match_reference():
    lm = _lm()
    step = make_train_step(lm["tm"], lm["opt"], remat=False)
    js, ts = lm["js"], lm["ts"]
    for i in range(3):
        batch = lm["pipe"].batch_at(i)
        js, jm = lm["j_step"](js, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        ts, tm = step(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)


def test_lm_remat_gives_the_same_step():
    lm = _lm()
    batch = lm["pipe"].batch_at(0)
    a, ma = make_train_step(lm["tm"], lm["opt"], remat=False)(lm["ts"], batch)
    b, mb = make_train_step(lm["tm"], lm["opt"], remat=True)(lm["ts"], batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(leaves(a.params), leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_lm_donated_steps_equal_the_steps_out_of_place():
    """``make_train_step(..., donate=True)`` (launch/train.py's step: the
    state updated in place) gives three steps in two microbatches equal
    bit for bit to the step that leaves its state alone."""
    lm = _lm()
    plain = make_train_step(lm["tm"], lm["opt"], remat=False, microbatches=2)
    donated = make_train_step(lm["tm"], lm["opt"], remat=False,
                              microbatches=2, donate=True)
    flat, spec = flatten(lm["ts"])
    a = lm["ts"]
    b = unflatten(spec, [t.clone() if torch.is_tensor(t) else t
                         for t in flat])
    for i in range(3):
        batch = lm["pipe"].batch_at(i)
        a, ma = plain(a, batch)
        b, mb = donated(b, batch)
        assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(leaves(a), leaves(b)):
        assert (x is None and y is None) or torch.equal(x, y)
    # the shared step-0 state is untouched by the donated steps
    assert int(lm["ts"].opt.step) == 0


def test_a_donated_step_frees_what_it_drops_without_a_collection():
    """Three donated steps of the reduced LM in bf16 with the garbage
    collector off: the params a step replaces are freed when the state
    that held them is dropped, not held by reference cycles until a
    collection (``tree.flatten``'s and ``unflatten``'s recursion was a
    self-referencing closure, which held each step's gradients and old
    params: 21.6 GB of internvl2-26b's at 4 layers on the card).  A weak
    reference to a leaf of a tree that went through both is dead once the
    tree is dropped."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              dtype=torch.bfloat16)
    model = get_model(cfg, device="cpu")
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=50)
    state = init_train_state(model, opt, 0)
    model.params = None           # the step reads the state's params only
    step = make_train_step(model, opt, remat=False, microbatches=2,
                           donate=True)
    pipe = TokenPipeline(seq_len=32, global_batch=4, vocab=cfg.vocab)
    gc.collect()
    gc.disable()
    try:
        for i in range(3):
            old = [weakref.ref(p) for p in leaves(state.params)]
            state, _ = step(state, pipe.batch_at(i))
            assert all(r() is None for r in old), i
        leaf = torch.ones(3)
        ref = weakref.ref(leaf)
        tree = unflatten(*reversed(flatten({"a": [leaf, (leaf,)]})))
        del leaf, tree
        assert ref() is None
    finally:
        gc.enable()


def test_lm_microbatching_equivalent():
    """Gradient accumulation over microbatches == full-batch step."""
    lm = _lm()
    batch = lm["pipe"].batch_at(0)
    s1, m1 = make_train_step(lm["tm"], lm["opt"], remat=False)(lm["ts"],
                                                                batch)
    s4, m4 = make_train_step(lm["tm"], lm["opt"], remat=False,
                             microbatches=4)(lm["ts"], batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    d = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(leaves(s1.params), leaves(s4.params)))
    assert d < 1e-4


def test_lm_loss_decreases():
    lm = _lm()
    step = make_train_step(lm["tm"], lm["opt"], remat=False)
    state, losses = lm["ts"], []
    for i in range(30):
        state, m = step(state, lm["pipe"].batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_lm_compressed_training_converges():
    lm = _lm()
    opt = lm["opt"]
    step = make_train_step(lm["tm"], opt, remat=False, compress=True)
    state = init_train_state(lm["tm"], opt, 0, compress=True,
                             params=lm["ts"].params)
    losses = []
    for i in range(30):
        state, m = step(state, lm["pipe"].batch_at(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---------------------------------------------------------- checkpoints

def test_lm_checkpoint_restart_bitexact(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, kill, resume 3."""
    lm = _lm()
    step = make_train_step(lm["tm"], lm["opt"], remat=False)
    state_a = state_b = lm["ts"]
    for i in range(6):
        state_a, _ = step(state_a, lm["pipe"].batch_at(i))
    for i in range(3):
        state_b, _ = step(state_b, lm["pipe"].batch_at(i))
    save_checkpoint(str(tmp_path), 3, state_b, extra={"data_step": 3})
    del state_b
    # a fresh process: a new model, optimizer and template
    tm = get_model(lm["cfg"], device="cpu").init(
        torch.Generator().manual_seed(1))
    opt = AdamW(lr=3e-3, warmup_steps=2, total_steps=50)
    template = init_train_state(tm, opt, 1)
    state_c, extra = restore_checkpoint(latest_checkpoint(str(tmp_path)),
                                        template)
    assert extra["data_step"] == 3
    step_c = make_train_step(tm, opt, remat=False)
    for i in range(extra["data_step"], 6):
        state_c, _ = step_c(state_c, lm["pipe"].batch_at(i))
    assert int(state_c.opt.step) == 6 and int(state_c.rng) == 0
    for pa, pc in zip(leaves((state_a.params, state_a.opt)),
                      leaves((state_c.params, state_c.opt))):
        assert torch.equal(pa, pc)


def _small_state(compress=False, width=4):
    params = {"w": torch.arange(width * 3, dtype=torch.float32
                                ).reshape(width, 3),
              "h": [torch.ones(5, dtype=torch.bfloat16)]}
    opt = AdamW()

    class Tiny:
        def init(self, gen):
            return params
    return init_train_state(Tiny(), opt, 7, compress=compress)


def test_checkpoint_round_trip_bit_exact(tmp_path):
    state = _small_state(compress=True)
    state = state._replace(params={
        "w": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)),
        "h": [torch.tensor([1.5, -2.25, 3e-3, 7.0, 0.1],
                           dtype=torch.bfloat16)]})
    path = save_checkpoint(str(tmp_path), 12, state, extra={"k": [1, 2]})
    got, extra = restore_checkpoint(path, _small_state(compress=True))
    assert extra == {"k": [1, 2]}
    assert type(got).__name__ == "TrainState"
    for a, b in zip(leaves(state), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got.rng) == 7


def test_restore_rejects_mismatched_structure(tmp_path):
    """Leaves are stored positionally: restoring into a template with a
    different structure (compression adds error-feedback leaves) must
    raise, not silently scramble tensors."""
    path = save_checkpoint(str(tmp_path), 0, _small_state())
    with pytest.raises(ValueError, match="different state structure"):
        restore_checkpoint(path, _small_state(compress=True))


def test_restore_rejects_mismatched_shapes(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, _small_state(width=4))
    with pytest.raises(ValueError, match="template shape"):
        restore_checkpoint(path, _small_state(width=6))


def test_checkpoint_atomic_and_keeps_three(tmp_path):
    state = _small_state()
    for s in range(5):
        save_checkpoint(str(tmp_path), s, state, keep=3)
    names = sorted(os.listdir(tmp_path))
    assert names == [f"ckpt_{s:08d}.npz" for s in (2, 3, 4)]
    assert not [n for n in names if n.endswith(".tmp")]
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000004.npz")


def test_supervised_restart_recovers(tmp_path):
    """Simulated preemptions mid-training: the supervisor resumes from the
    latest checkpoint and completes, final params identical to a
    fault-free run."""
    lm = _lm()
    step = make_train_step(lm["tm"], lm["opt"], remat=False)
    state0 = lm["ts"]
    holder = {"failed": set()}

    def train_fn(start_step):
        state = state0
        ck = latest_checkpoint(str(tmp_path))
        if ck:
            state, extra = restore_checkpoint(ck, state0)
            start_step = extra["data_step"]
        for i in range(start_step, 6):
            state, _ = step(state, lm["pipe"].batch_at(i))
            save_checkpoint(str(tmp_path), i + 1, state,
                            extra={"data_step": i + 1})
            if i in (1, 4) and i not in holder["failed"]:
                holder["failed"].add(i)
                raise RuntimeError("simulated preemption")
        holder["state"] = state
        return 6

    rep = run_supervised(train_fn, total_steps=6, ckpt_dir=str(tmp_path))
    assert rep.restarts == 2 and rep.completed_steps == 6
    assert rep.resumed_from == [2, 5]
    ref = state0
    for i in range(6):
        ref, _ = step(ref, lm["pipe"].batch_at(i))
    for a, b in zip(leaves(holder["state"].params), leaves(ref.params)):
        assert torch.equal(a, b)
