"""Port parity for the MoE, Mamba2 (SSD) and Zamba2 (hybrid) families and
the SIRA block exporter: ``repro_torch.models.{moe,ssm,transformer,
convert,export}`` against the JAX package on the same numpy inputs and
the same weights (initialised by the reference, carried across by
``load_reference_params``), on the CPU, at the reduced configs.

Tolerances, float32 unless stated:
  * MoE: routing indices and keep mask equal (the inputs' top-k margins
    are asserted, so no near-tie can flip an index); y within
    ``1e-5·max|y|``; aux values within 1e-6 relative;
  * the no-dispatch oracle (``moe.apply_moe_direct``, float64) within
    ``1e-5·max|y|`` of ``apply_moe`` (a dispatch fault is O(1));
  * conv, SSD and Mamba2 blocks within ``1e-5`` of the output's scale;
  * whole models: logits within ``1e-4·max|logits|`` (layers of float32
    products summed in another order), ``decode_step`` against the
    reference's within ``1e-4·max|logits|``, decode against prefill at the
    reference's own ``rtol=1e-3, atol=2e-3``, losses within 1e-5
    relative, their gradients within 1e-4 of each leaf's largest |g|;
  * bfloat16 logits: four bf16 ulps (``4·2^-7``) of the logit scale.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import export as j_export, moe as j_moe, ssm as j_ssm
from repro.quant.quantizer import QuantSpec as JQuantSpec
from repro_torch.configs import get_config, list_archs
from repro_torch.models import export as t_export, moe as t_moe, \
    ssm as t_ssm
from repro_torch.models import get_model, load_reference_params
from repro_torch.quant.quantizer import QuantSpec
from test_torch_analysis import (assert_graph_parity, assert_range_parity,
                                 assert_reports_parity)

FAMILIES = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-780m",
            "zamba2-2.7b"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_to_scale(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _no_drop(cfg):
    """``cfg`` with capacity_factor = n_experts: no slot is dropped (the
    reference's own decode-vs-prefill test does this)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


_MODELS = {}


def _pair(arch, dtype=None, no_drop=False):
    """(reference cfg, reference model, its params, the port's model with
    the same weights), cached."""
    key = (arch, dtype, no_drop)
    if key not in _MODELS:
        jcfg = j_get_config(arch, reduced=True)
        tcfg = get_config(arch, reduced=True)
        if dtype is not None:
            jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
            tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        if no_drop and tcfg.moe.n_experts:
            jcfg, tcfg = _no_drop(jcfg), _no_drop(tcfg)
        jm = j_get_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = get_model(tcfg, device="cpu").load_reference_params(
            _np_tree(params))
        _MODELS[key] = (jcfg, jm, params, tm)
    return _MODELS[key]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,E,seed", [(16, 4, 0), (64, 8, 1), (200, 13, 2)])
def test_rank_in_expert_matches_reference(n, E, seed):
    ids = np.random.default_rng(seed).integers(0, E, (3, n))
    want = np.stack([np.asarray(j_moe._rank_in_expert(jnp.asarray(r), E))
                     for r in ids])
    got = t_moe.rank_in_expert(_t(ids), E)
    np.testing.assert_array_equal(got.numpy(), want)


MOE_D, MOE_E, MOE_E_PAD, MOE_F = 32, 8, 16, 24
MOE_CASES = {f"{'shared' if s else 'routed'} {act} "
             f"{'no-drop' if nd else 'cap 1.25'}": (s, act, nd)
             for s in (0, 2) for act in ("silu", "gelu") for nd in (0, 1)}


def _moe_inputs(n_shared, seed=0):
    """The reference's MoE params (experts padded to 16) and an input; the
    port's params are the same numbers without the pad experts."""
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), MOE_D, MOE_E, MOE_F,
                        n_shared, jnp.float32, n_experts_padded=MOE_E_PAD)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    tp["experts"] = {k: v[:MOE_E] for k, v in tp["experts"].items()}
    x = np.random.default_rng(seed + 10).normal(
        size=(2, 16, MOE_D)).astype(np.float32)
    return jp, tp, x


def _reference_routing(jp, x, top_k, cf):
    B, S, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    E_pad = jp["experts"]["w_gate"].shape[0]
    C = int(max(top_k, cf * S * top_k / MOE_E))
    C = min(C, S * top_k)
    pos = jax.vmap(lambda fe: j_moe._rank_in_expert(fe, E_pad))(
        idx.reshape(B, S * top_k))
    return np.asarray(probs), np.asarray(idx), np.asarray(pos) < C


def _assert_no_near_tie(probs, top_k, min_gap=1e-6):
    """The (k+1) largest probabilities of every token are apart by more
    than ``min_gap``: float32 rounding cannot reorder the top-k."""
    top = -np.sort(-probs, axis=-1)[..., :top_k + 1]
    assert np.diff(-top, axis=-1).min() > min_gap


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case):
    n_shared, act, no_drop = MOE_CASES[case]
    top_k = 2
    cf = float(MOE_E) if no_drop else 1.25
    jp, tp, x = _moe_inputs(n_shared)
    want, jaux = j_moe.apply_moe(jp, jnp.asarray(x), top_k=top_k,
                                 capacity_factor=cf, act=act)
    probs, idx, keep = _reference_routing(jp, x, top_k, cf)
    _assert_no_near_tie(probs, top_k)
    r = t_moe.route(tp, _t(x), top_k=top_k, capacity_factor=cf)
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.in_cap.numpy(), keep)
    assert keep.all() if no_drop else not keep.all()   # drops at 1.25
    got, taux = t_moe.apply_moe(tp, _t(x), top_k=top_k, capacity_factor=cf,
                                act=act)
    _close_to_scale(got.numpy(), np.asarray(want), 1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_the_no_dispatch_oracle(case):
    """Σ_k gate·in_cap·expert_k(x) in float64, with the same routing and
    keep mask, and no (B, E, C, d) dispatch."""
    n_shared, act, no_drop = MOE_CASES[case]
    cf = float(MOE_E) if no_drop else 1.25
    _, tp, x = _moe_inputs(n_shared, seed=3)
    got, _ = t_moe.apply_moe(tp, _t(x), top_k=2, capacity_factor=cf,
                             act=act)
    r = t_moe.route(tp, _t(x), top_k=2, capacity_factor=cf)
    want = t_moe.apply_moe_direct(tp, _t(x), r, act=act)
    assert want.dtype == torch.float64
    _close_to_scale(got.numpy(), want.numpy(), 1e-5)


def test_capacity_is_the_references():
    for S, k, E, cf in ((2048, 8, 40, 1.25), (2048, 4, 60, 1.25),
                        (1, 8, 40, 1.25), (512, 4, 60, 60.0), (7, 2, 8, 1.0)):
        C = int(max(k, cf * S * k / E))
        assert t_moe.capacity(S, k, E, cf) == min(C, S * k)


# --------------------------------------------------------------------------
# Mamba2 (SSD)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    xbc = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=12).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    wy, ws = j_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    gy, gs = t_ssm.causal_conv(_t(xbc), _t(w), _t(b),
                               None if st is None else _t(st))
    _close_to_scale(gy.numpy(), np.asarray(wy), 1e-5)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def _ssd_inputs(S, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 4, 5
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(B, S, H)))) * dt_scale
          ).astype(np.float32)
    A = np.exp(np.linspace(0.0, np.log(16.0), H)).astype(np.float32)
    Bm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, 1, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_ssd_chunked_matches_reference(n_chunks):
    chunk = 16
    args = _ssd_inputs(chunk * n_chunks, seed=n_chunks)
    wy, ws = j_ssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    gy, gs = t_ssm.ssd_chunked(*map(_t, args), chunk)
    _close_to_scale(gy.numpy(), np.asarray(wy), 1e-5)
    _close_to_scale(gs.numpy(), np.asarray(ws), 1e-5)


def test_ssd_decay_matrix_does_not_overflow():
    """A 256-token chunk with decays of 4-64 per step: exp(-seg) above the
    diagonal is far beyond float32 (exp(88) is its limit), so a mask
    applied after the exp would give inf·0 = NaN; the port masks first."""
    args = _ssd_inputs(256, seed=5, dt_scale=4.0)
    wy, ws = j_ssm.ssd_chunked(*map(jnp.asarray, args), 256)
    gy, gs = t_ssm.ssd_chunked(*map(_t, args), 256)
    assert bool(torch.isfinite(gy).all()) and bool(torch.isfinite(gs).all())
    _close_to_scale(gy.numpy(), np.asarray(wy), 1e-5)
    _close_to_scale(gs.numpy(), np.asarray(ws), 1e-5)


def test_ssd_chunked_refuses_a_ragged_length():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ssm.ssd_chunked(*map(_t, _ssd_inputs(20, seed=6)), 16)


def _mamba_pair():
    cfg = get_config("mamba2-780m", reduced=True)
    jcfg = j_get_config("mamba2-780m", reduced=True)
    jp = j_ssm.init_mamba2(jax.random.PRNGKey(7), cfg.d_model, jcfg.ssm,
                           jnp.float32)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    x = np.random.default_rng(8).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, tp, x


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_mamba2_matches_reference(mode):
    cfg, jcfg, jp, tp, x = _mamba_pair()
    wy, wst = j_ssm.apply_mamba2(jp, jnp.asarray(x), jcfg.ssm)
    gy, gst = t_ssm.apply_mamba2(tp, _t(x), cfg.ssm)
    if mode == "decode":             # one step from the prefill's state
        x1 = np.random.default_rng(9).normal(
            size=(2, 1, cfg.d_model)).astype(np.float32)
        wy, wst = j_ssm.apply_mamba2(jp, jnp.asarray(x1), jcfg.ssm,
                                     state=wst, decode=True)
        state = {k: v.clone() for k, v in gst.items()}
        gy, gst = t_ssm.apply_mamba2(tp, _t(x1), cfg.ssm, state=state,
                                     decode=True)
        assert gst is state           # updated in place
    _close_to_scale(gy.numpy(), np.asarray(wy), 1e-5)
    for k in ("conv", "ssd"):
        _close_to_scale(gst[k].numpy(), np.asarray(wst[k]), 1e-5)


# --------------------------------------------------------------------------
# the four families as whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_matches_reference(arch):
    jcfg, jm, params, tm = _pair(arch)
    toks = _tokens(jcfg, 2, 16, seed=len(arch))
    want, jaux = jm.forward(params, jnp.asarray(toks), return_aux=True)
    with torch.no_grad():
        got, taux = tm(_t(toks), return_aux=True)
    assert got.shape == want.shape and got.dtype == torch.float32
    V = jcfg.vocab
    _close_to_scale(got[..., :V].numpy(), np.asarray(want)[..., :V], 1e-4)
    assert (got[..., V:] == -1e30).all()
    if jcfg.family == "moe":
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5)
    else:
        assert taux is None and jaux is None


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_reference(arch):
    jcfg, jm, params, tm = _pair(arch)
    B, S = 2, 12
    toks = _tokens(jcfg, B, S, seed=7)
    jdec = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S)
    got, want = [], []
    for t in range(S):
        lj, jcache = jdec(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.asarray(t))
        lt, tcache = tm.decode_step(_t(toks[:, t:t + 1]), tcache, t)
        want.append(np.asarray(lj[:, 0]))
        got.append(lt[:, 0].numpy())
    V = jcfg.vocab
    _close_to_scale(np.stack(got, 1)[..., :V], np.stack(want, 1)[..., :V],
                    1e-4)
    # the caches agree too (recurrent states, keys and values)
    jl, tl = _leaves(_np_tree(jcache)), _leaves(tcache)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        _close_to_scale(tl[k].numpy(), jl[k], 1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_prefill(arch):
    """The port's twin of the reference's ``test_decode_matches_prefill``
    (MoE at no-drop capacity, as there)."""
    jcfg, _, _, tm = _pair(arch, no_drop=True)
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(jcfg, B, S, seed=1)).long()
    with torch.no_grad():
        ref = tm(toks)
    cache = tm.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=1e-3, atol=2e-3)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, name + "."))
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_cache_matches_reference(arch):
    jcfg, jm, _, tm = _pair(arch)
    want = _leaves(jm.init_cache(3, 10))
    got = _leaves(tm.init_cache(3, 10))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        assert not got[k].any()


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_matches_reference(arch):
    """Equal losses, and both are the plain cross-entropy: neither package
    adds MoE's aux terms (reference fault 8, kept in the port)."""
    jcfg, jm, params, tm = _pair(arch)
    toks = _tokens(jcfg, 2, 16, seed=2)
    labels = np.roll(toks, -1, axis=1)
    want = float(jm.loss(params, jnp.asarray(toks), jnp.asarray(labels)))
    tparams = tm.param_tree()
    got = tm.loss(tparams, _t(toks), _t(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    with torch.no_grad():
        logits = tm(_t(toks)).double()
    ce = (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, _t(labels).long()[..., None])[..., 0]).mean()
    assert abs(float(got) - float(ce)) < 1e-5


def _flat_grads(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree.grad}
    out = {}
    for k, v in items:
        out.update(_flat_grads(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_gradient_matches_reference(arch):
    """``loss`` differentiated on the CPU (autograd through routing,
    dispatch, the SSD and its chunk carry) against ``jax.grad`` of the
    reference's: every leaf within 1e-4 of its largest |g| (the pad
    experts, which the port does not hold, get no gradient there)."""
    jcfg, jm, params, tm = _pair(arch)
    toks = _tokens(jcfg, 2, 16, seed=3)
    labels = np.roll(toks, -1, axis=1)
    gj = jax.grad(lambda p: jm.loss(p, jnp.asarray(toks),
                                    jnp.asarray(labels)))(params)
    want = load_reference_params(tm.cfg, _np_tree(gj))
    tparams = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                           tm.param_tree())
    tm.loss(tparams, _t(toks), _t(labels)).backward()
    got = _flat_grads(tparams)
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        _close_to_scale(got[k].numpy(), g.numpy(), 1e-4)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-780m"])
def test_family_forward_bfloat16_matches_reference(arch):
    jcfg, jm, params, tm = _pair(arch, dtype="bf16")
    toks = _tokens(jcfg, 2, 16, seed=11)
    want = np.asarray(jm.forward(params, jnp.asarray(toks)), np.float32)
    with torch.no_grad():
        got = tm(_t(toks))
    assert got.dtype == torch.bfloat16
    V = jcfg.vocab
    # four bf16 ulps (2^-7 relative) of the logit scale
    _close_to_scale(got.to(torch.float32).numpy()[..., :V], want[..., :V],
                    4 * 2.0 ** -7)


def test_mamba2_forward_with_fake_quant_matches_reference():
    jcfg, jm, params, tm = _pair("mamba2-780m")
    toks = _tokens(jcfg, 2, 16, seed=12)
    want = jm.forward(params, jnp.asarray(toks), quant=JQuantSpec(8))
    with torch.no_grad():
        got = tm(_t(toks), quant=QuantSpec(8))
    V = jcfg.vocab
    _close_to_scale(got[..., :V].numpy(), np.asarray(want)[..., :V], 1e-4)


def test_converter_drops_the_pad_experts_and_keeps_dtypes():
    jcfg, _, params, tm = _pair("granite-moe-3b-a800m")
    assert jcfg.n_experts_padded == 16 and jcfg.moe.n_experts == 8
    flat = load_reference_params(tm.cfg, _np_tree(params))
    assert tuple(flat["layers.1.moe.experts.w_down"].shape) == (8, 32, 64)
    np.testing.assert_array_equal(
        flat["layers.1.moe.experts.w_up"].numpy(),
        np.asarray(params["layers"]["moe"]["experts"]["w_up"][1, :8]))
    assert sorted(tm.params.state_dict()) == sorted(flat)
    bf = _pair("mamba2-780m", dtype="bf16")[3].params.layers[0].mamba
    assert bf.in_proj.dtype == torch.bfloat16
    assert bf.A_log.dtype == bf.D.dtype == bf.dt_bias.dtype == torch.float32


def test_hybrid_layers_unstack_group_major():
    jcfg, _, params, tm = _pair("zamba2-2.7b")
    assert len(tm.params.layers) == jcfg.n_layers == 6
    for i in range(6):
        g, j = divmod(i, jcfg.attn_every)
        np.testing.assert_array_equal(
            tm.params.layers[i].mamba.in_proj.numpy(),
            np.asarray(params["layers"]["mamba"]["in_proj"][g, j]))
    np.testing.assert_array_equal(
        tm.params.shared_attn.attn.wq.numpy(),
        np.asarray(params["shared_attn"]["attn"]["wq"]))


def test_init_draws_every_family():
    for arch in FAMILIES:
        cfg = get_config(arch, reduced=True)
        tm = get_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        ref = load_reference_params(cfg, _np_tree(
            j_get_model(j_get_config(arch, reduced=True)).init(
                jax.random.PRNGKey(0))))
        sd = tm.params.state_dict()
        assert sorted(sd) == sorted(ref), arch
        for k, v in ref.items():
            assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k


# --------------------------------------------------------------------------
# all ten configs: paged support and the block exporter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_supports_paged_matches_reference(arch):
    """Recurrent state cannot be paged: ssm and hybrid say False."""
    want = j_get_model(j_get_config(arch, reduced=True)).supports_paged
    got = get_model(get_config(arch, reduced=True),
                    device="cpu").supports_paged
    assert got == want


@pytest.mark.parametrize("arch", list_archs())
def test_export_block_graph_matches_reference(arch):
    """The exported graph equal up to generated names (reference fault 5),
    and ``build_flow`` over it: same graph, ranges and accumulator bits."""
    gj, ij = j_export.export_block_graph(j_get_config(arch, reduced=True))
    gt, it = t_export.export_block_graph(get_config(arch, reduced=True))
    assert list(ij) == list(it)
    assert_graph_parity(SimpleNamespace(graph=gj), SimpleNamespace(graph=gt))
    rj, rt = jcore.build_flow((gj, ij)), tcore.build_flow((gt, it))
    assert_graph_parity(rj, rt)
    assert_range_parity(rj, rt)
    assert_reports_parity(rj, rt)


@pytest.mark.parametrize("bias", [False, True])
def test_export_kv_proj_graph_matches_reference(bias):
    rng = np.random.default_rng(13)
    Wk, Wv = rng.normal(size=(2, 32, 16)) * 0.2
    kw = dict(bk=rng.normal(size=16), bv=rng.normal(size=16)) if bias \
        else {}
    gj, ij = j_export.export_kv_proj_graph(Wk, Wv, **kw)
    gt, it = t_export.export_kv_proj_graph(Wk, Wv, **kw)
    assert_graph_parity(SimpleNamespace(graph=gj), SimpleNamespace(graph=gt))
    rj, rt = (jcore.SiraModel(gj, ij), tcore.SiraModel(gt, it))
    assert_range_parity(SimpleNamespace(graph=gj, model=rj),
                        SimpleNamespace(graph=gt, model=rt))
