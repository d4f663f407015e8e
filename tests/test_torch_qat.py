"""Port parity for accumulator-aware QAT: ``repro_torch.qat`` against
``repro.qat`` on shared inputs, on the CPU, and the port's own
invariants, mirrored from ``tests/test_qat.py``.

Tolerances (float32 unless stated):
  * ``project_weights``, both regimes: within ``1e-6`` relative to the
    weights' largest magnitude (a sort, a cumulative sum and a division
    in another library); feasible columns unchanged;
  * ``budget_penalty`` and its gradient (autograd against ``jax.grad``):
    ``1e-5`` relative;
  * ``quantize_weights``, ``channel_bits`` (float64 numpy in both):
    equal;
  * ``QATMLP`` built from the reference's init and scales: logits within
    ``1e-6`` of the logit scale, three ``run_qat`` losses ``1e-5``
    relative;
  * export of the reference's trained params: initialisers bit for bit
    (up to generated names), proven bits and the LUT/DSP numbers equal,
    the compiled model (float64, CPU) bit-exact against
    ``Graph.execute``.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qat as jq
from repro.dataflow import compare_sira_vs_baseline as j_compare
from repro_torch import qat as tq
from repro_torch.dataflow import compare_sira_vs_baseline
from repro_torch.tree import leaves

CPU = "cpu"


def _rand_layer(seed, K=24, M=6, wbits=4):
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(K, M)) * rng.uniform(0.5, 2.0)).astype(np.float32)
    scale = np.maximum(np.abs(W).max(axis=0) / (2 ** (wbits - 1) - 1),
                       1e-8).astype(np.float32)
    return W, scale


def _budgets(zc):
    """(reference, port) budgets: symmetric or A2Q+ regime."""
    kw = dict(bits=8, input_bits=6, zero_center=zc)
    return jq.AccumulatorBudget(**kw), tq.AccumulatorBudget(**kw)


# --------------------------------------------------------------- projection

@pytest.mark.parametrize("zc", [False, True], ids=["symmetric", "a2q_plus"])
@pytest.mark.parametrize("seed", range(4))
def test_project_weights_matches_reference(seed, zc):
    W, scale = _rand_layer(seed)
    jb, tb = _budgets(zc)
    want = np.asarray(jq.project_weights(jnp.asarray(W), jnp.asarray(scale),
                                         jb))
    got = tq.project_weights(torch.from_numpy(W), torch.from_numpy(scale),
                             tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    v = got / scale
    cap_pos, cap_neg = tb.caps()
    if cap_neg >= 0:
        assert np.all(np.maximum(v, 0).sum(0) <= cap_pos + 1e-4)
        assert np.all(np.maximum(-v, 0).sum(0) <= cap_neg + 1e-4)
    else:
        assert np.all(np.abs(v).sum(0) <= cap_pos + 1e-4)


@pytest.mark.parametrize("zc", [False, True], ids=["symmetric", "a2q_plus"])
def test_projection_feasible_columns_unchanged(zc):
    W, scale = _rand_layer(0)
    W = W * 1e-3                      # tiny weights: trivially feasible
    budget = tq.AccumulatorBudget(16, input_bits=4, zero_center=zc)
    got = tq.project_weights(torch.from_numpy(W), torch.from_numpy(scale),
                             budget).numpy()
    if zc:
        # zero-centering is a reparameterization, not a projection
        W = W - (W / scale).mean(axis=0, keepdims=True) * scale
    np.testing.assert_allclose(got, W, atol=1e-7)


@pytest.mark.parametrize("zc", [False, True], ids=["symmetric", "a2q_plus"])
def test_budget_penalty_and_its_gradient_match_reference(zc):
    W, scale = _rand_layer(5)
    jb, tb = _budgets(zc)
    j_val, j_grad = jax.value_and_grad(
        lambda w: jq.budget_penalty(w, jnp.asarray(scale), jb))(
        jnp.asarray(W))
    w = torch.from_numpy(W).requires_grad_(True)
    t_val = tq.budget_penalty(w, torch.from_numpy(scale), tb)
    (t_grad,) = torch.autograd.grad(t_val, w)
    assert float(j_val) > 0
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-5,
                               atol=1e-5 * float(np.abs(j_grad).max()))


@pytest.mark.parametrize("signed", [False, True])
def test_quantize_weights_and_channel_bits_equal(signed):
    W, scale = _rand_layer(7, wbits=5)
    W64 = W.astype(np.float64) * 1.7
    kw = dict(bits=10, input_bits=5, input_signed=signed)
    qj = jq.quantize_weights(W64, scale, 5)
    qt = tq.quantize_weights(torch.from_numpy(W64), torch.from_numpy(scale),
                             5)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(
        tq.channel_bits(qt, tq.AccumulatorBudget(**kw)),
        jq.channel_bits(qj, jq.AccumulatorBudget(**kw)))
    for hi in (True, False):
        np.testing.assert_array_equal(
            tq.worst_case_inputs(qt, tq.AccumulatorBudget(**kw), hi),
            jq.worst_case_inputs(qj, jq.AccumulatorBudget(**kw), hi))


def test_fuzz_projection_honest_clean():
    rep = tq.fuzz_projection(30, seed=1)
    assert rep.clean, rep.violations[:3] + rep.oracle_mismatches[:3]
    assert rep.channels_checked > 0


@pytest.mark.parametrize("lie", ["loose", "skip"])
def test_fuzz_projection_catches_lying_projector(lie):
    rep = tq.fuzz_projection(30, seed=1, lie=lie)
    assert rep.violations, f"lying projector ({lie}) went undetected"


def test_budget_validation():
    with pytest.raises(ValueError):
        tq.AccumulatorBudget(bits=1)


def test_unconstrained_model_has_no_projection():
    model = tq.QATMLP(budget_bits=0, hidden=(8,), device=CPU)
    assert all(b is None for b in model.budgets())
    assert tq.make_optimizer(tq.QATConfig(budget=0), model).project is None


# ------------------------------------------- the model from the reference

def _converted(cfg):
    """The reference's model for ``cfg``, its raw init (numpy) and the
    port's model built from them."""
    jm = cfg.make_model()
    raw = jax.tree.map(np.asarray, jm._raw_init(jax.random.PRNGKey(cfg.seed)))
    return jm, tq.qat_model_from_reference(jm, raw, device=CPU)


def test_converted_model_keeps_the_reference_scales_and_logits():
    jm, tm = _converted(jq.QATConfig(budget=12, hidden=(24,), seed=0))
    for a, b in zip(tm.w_scales, jm.w_scales):
        np.testing.assert_array_equal(a, b)
    assert tm.a_scales == jm.a_scales
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.init(0)                   # the reference's init, projected here
    for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    x = jm.synth_batch(5, 64)
    for k in x:
        np.testing.assert_array_equal(tm.synth_batch(5, 64)[k], x[k])
    want = np.asarray(jm.apply(jp, jnp.asarray(x["tokens"])))
    got = tm.apply(tq.params_from_reference(jax.tree.map(np.asarray, jp),
                                            CPU),
                   torch.from_numpy(x["tokens"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_three_qat_losses_match_reference():
    cfg = dict(budget=12, steps=3, hidden=(24,), seed=0)
    j_cfg = jq.QATConfig(**cfg)
    _, tm = _converted(j_cfg)
    want = jq.run_qat(j_cfg).losses
    got = tq.run_qat(tq.QATConfig(**cfg), model=tm).losses
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_state_from_reference_params():
    j_cfg = jq.QATConfig(budget=12, hidden=(24,), seed=0)
    jm, tm = _converted(j_cfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = tq.train_state_from_reference(
        tm, tq.make_optimizer(tq.QATConfig(budget=12, hidden=(24,)), tm), jp)
    for a, m, b in zip(leaves(state.params), leaves(state.opt.master),
                       jax.tree.leaves(jp)):
        assert torch.equal(a, torch.tensor(b))
        assert torch.equal(m, a) and m.data_ptr() != a.data_ptr()


# ------------------------------------------------------------ export parity

@pytest.fixture(scope="module")
def ref_trained():
    return jq.run_qat(jq.QATConfig(budget=12, steps=50, hidden=(24,),
                                   seed=0))


@pytest.fixture(scope="module")
def exported(ref_trained):
    """(reference export, port export, reference build, port build, port
    model, port params) of the reference's trained params."""
    jm, jp = ref_trained.model, ref_trained.state.params
    tm = tq.qat_model_from_reference(jm, device=CPU)
    tp = tq.params_from_reference(jax.tree.map(np.asarray, jp), CPU)
    j_build, j_bits = jq.proven_layer_bits(jm, jp)
    t_build, t_bits = tq.proven_layer_bits(tm, tp)
    return dict(j_sm=jq.export_qat_model(jm, jp),
                t_sm=tq.export_qat_model(tm, tp), j_build=j_build,
                t_build=t_build, j_bits=j_bits, t_bits=t_bits, tm=tm, tp=tp)


def _named(sm):
    """Initialisers in creation order, generated names blanked."""
    return [(n if n.startswith("l") and n[1:2].isdigit() else None, v)
            for n, v in sm.graph.initializers.items()]


def test_export_initialisers_equal_reference(exported):
    got, want = _named(exported["t_sm"]), _named(exported["j_sm"])
    assert len(got) == len(want)
    for (gn, gv), (wn, wv) in zip(got, want):
        assert gn == wn
        gv, wv = np.asarray(gv), np.asarray(wv)
        assert gv.dtype == wv.dtype and gv.shape == wv.shape
        np.testing.assert_array_equal(gv, wv)
    assert [n.op_type for n in exported["t_sm"].graph.nodes] == \
        [n.op_type for n in exported["j_sm"].graph.nodes]


def test_export_proven_bits_and_dse_equal_reference(exported):
    assert exported["t_bits"] == exported["j_bits"]
    assert max(exported["t_bits"]) <= 12
    tq.check_budget_invariant(exported["tm"], exported["tp"],
                              exported["t_bits"])
    got = compare_sira_vs_baseline(exported["t_build"].model)
    want = j_compare(exported["j_build"].model)
    for side in ("sira", "baseline"):
        g, w = getattr(got, side), getattr(want, side)
        assert (g.luts, g.dsps) == (w.luts, w.dsps), side


def test_exported_model_compiles_bit_exact(exported):
    model = exported["t_build"].model
    compiled = model.compile(device=CPU, dtype=torch.float64)
    compiled = model.compile(device=CPU, dtype=torch.float64,
                             extra_outputs=compiled.int_tensors)
    assert compiled.int_tensors
    x = exported["tm"].synth_batch(3, 64)["tokens"].astype(np.float64)
    got = compiled({"X": x})
    want = model.execute({"X": x}, record_all=True)
    for t in compiled.int_tensors:
        assert got[t].dtype == np.int32
        np.testing.assert_array_equal(got[t].astype(np.float64), want[t])
    (out,) = model.graph.outputs
    np.testing.assert_allclose(got[out], want[out], rtol=1e-12, atol=1e-12)


# ---------------------------------------------- the port's own invariants

@pytest.fixture(scope="module")
def trained():
    return tq.run_qat(tq.QATConfig(budget=12, steps=50, hidden=(24,),
                                   seed=0), device=CPU)


def test_qat_loss_decreases(trained):
    losses = trained.losses
    assert np.mean(losses[-8:]) < np.mean(losses[:8]), losses


def test_projection_enforced_on_params_and_masters(trained):
    model = trained.model
    for params in (trained.state.params, trained.state.opt.master):
        for i, (layer, budget) in enumerate(zip(params["layers"],
                                                model.budgets())):
            v = layer["W"].double().numpy() / model.w_scales[i]
            cap_pos, cap_neg = budget.caps()
            assert cap_neg < 0
            assert np.all(np.abs(v).sum(0) <= cap_pos + 1e-3)


def test_qat_checkpoint_resume_bitexact(tmp_path):
    """Train 6 steps straight == kill after the step-3 checkpoint +
    fresh-process resume, bit-identical, for a constrained state."""
    cfg = tq.QATConfig(budget=12, steps=6, hidden=(16,), seed=1,
                       ckpt_dir=str(tmp_path / "a"), ckpt_every=3)
    straight = tq.run_qat(cfg, device=CPU)
    (tmp_path / "b").mkdir()
    shutil.copy(tmp_path / "a" / "ckpt_00000003.npz", tmp_path / "b")
    resumed = tq.run_qat(dataclasses.replace(cfg,
                                             ckpt_dir=str(tmp_path / "b")),
                         device=CPU)
    assert resumed.resumed_from == 3
    assert resumed.losses[:3] == straight.losses[:3]
    assert len(resumed.step_seconds) == 3
    for a, b in zip(leaves((straight.state.params, straight.state.opt)),
                    leaves((resumed.state.params, resumed.state.opt))):
        assert torch.equal(a, b)


def test_end_to_end_budget_chain():
    """QAT at budget B -> export -> build_flow -> proven bits <= B on
    every constrained layer -> DSE LUT/DSP monotone non-increasing as B
    tightens."""
    prev_luts, prev_dsps = None, None
    for budget in (14, 12, 10):
        res = tq.run_qat(tq.QATConfig(budget=budget, steps=40,
                                      hidden=(24,), seed=2), device=CPU)
        result, bits = tq.proven_layer_bits(res.model, res.state.params)
        checked = tq.check_budget_invariant(res.model, res.state.params,
                                            bits)
        assert all(b <= budget for b in checked)
        comp = compare_sira_vs_baseline(result.model)
        if prev_luts is not None:
            assert comp.sira.luts <= prev_luts + 1e-9
            assert comp.sira.dsps <= prev_dsps
        prev_luts, prev_dsps = comp.sira.luts, comp.sira.dsps


def test_zero_center_variant_trains_and_holds():
    res = tq.run_qat(tq.QATConfig(budget=12, steps=40, hidden=(24,), seed=3,
                                  zero_center=True), device=CPU)
    bits = tq.check_budget_invariant(res.model, res.state.params)
    assert max(bits) <= 12
    for layer, s, b in zip(res.state.opt.master["layers"],
                           res.model.w_scales, res.model.budgets()):
        v = layer["W"].double().numpy() / s
        cap_pos, cap_neg = b.caps()
        assert np.all(np.maximum(v, 0).sum(0) <= cap_pos + 1e-3)
        assert np.all(np.maximum(-v, 0).sum(0) <= cap_neg + 1e-3)

