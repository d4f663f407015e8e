"""Port parity for the LM slice: ``repro_torch.configs``, ``quant``,
``models`` against the JAX package on the same numpy inputs and the same
weights (initialised by the reference, carried across through numpy by
``load_reference_params``), on the CPU.

Tolerances, float32 unless stated:
  * building blocks (norm, RoPE, linear, MLP): ``rtol=atol=1e-5``;
  * logits of a whole reduced model: ``atol = 1e-4 · max|logits|`` (two
    layers of float32 products summed in another order, and the
    attention's reduction, which the reference chunks and the port does
    not);
  * bfloat16 logits: four bf16 ulps of the logit scale (each framework
    rounds every product to bf16 at its own points);
  * decode against prefill: the reference's own ``rtol=1e-3, atol=2e-3``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import attention as j_attn, common as j_common, \
    mlp as j_mlp
from repro.quant import quantizer as j_quant
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES, cell_applicable, input_specs
from repro_torch.models import Model, get_model, load_reference_params
from repro_torch.models import common as t_common, mlp as t_mlp
from repro_torch.models.attention import quantize_kv
from repro_torch.quant import quantizer as t_quant

DENSE = [a for a in list_archs()
         if get_config(a).family in ("dense", "vlm", "audio")]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_MODELS = {}


def _pair(arch, dtype=None):
    """(reference cfg, reference model, its params, the port's model with
    the same weights), cached per arch and dtype."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg = j_get_config(arch, reduced=True)
        tcfg = get_config(arch, reduced=True)
        if dtype is not None:
            jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
            tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        jm = j_get_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = get_model(tcfg, device="cpu").load_reference_params(
            _np_tree(params))
        _MODELS[key] = (jcfg, jm, params, tm)
    return _MODELS[key]


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)
                        ).astype(np.float32)
    return toks, fe


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_registry_matches_the_reference():
    import repro.configs as jc
    assert list_archs() == jc.list_archs()
    for a in list_archs():
        for reduced in (False, True):
            j, t = j_get_config(a, reduced), get_config(a, reduced)
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            jdt, tdt = jd.pop("dtype"), td.pop("dtype")
            assert jd == td, a
            assert str(jnp.dtype(jdt)) == str(tdt).split(".")[-1]
            assert (t.hd, t.vocab_padded, t.param_count()) == \
                (j.hd, j.vocab_padded, j.param_count())
            for s in SHAPES.values():
                assert cell_applicable(t, s)[0] == jc.cell_applicable(
                    j, jc.SHAPES[s.name])[0]
                js = jc.input_specs(j, jc.SHAPES[s.name])
                ts = input_specs(t, s)
                assert list(js) == list(ts)
                for name in js:
                    assert tuple(js[name].shape) == tuple(ts[name].shape)
                    assert ts[name].device.type == "meta"


# --------------------------------------------------------------------------
# quantizer and building blocks
# --------------------------------------------------------------------------

SPECS = {
    "per_tensor": j_quant.QuantSpec(bits=8),
    "per_channel narrow": j_quant.QuantSpec(bits=4, narrow=True,
                                            granularity="per_channel"),
    "per_group pot": j_quant.QuantSpec(bits=6, granularity="per_group",
                                       group_size=8, pot=True),
    "asymmetric unsigned": j_quant.QuantSpec(bits=8, signed=False,
                                             symmetric=False),
    "toward_zero": j_quant.QuantSpec(bits=5, rounding="toward_zero",
                                     granularity="per_channel"),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_quantizer_matches_reference(name):
    """Against ``jax.jit`` of the reference's scale and dynamic fake-quant:
    the reference runs them compiled (under its layers' scan), where XLA
    multiplies by the reciprocal of ``qmax`` (C4)."""
    js = SPECS[name]
    ts = t_quant.QuantSpec(**dataclasses.asdict(js))
    x = np.random.default_rng(3).normal(size=(6, 32)).astype(np.float32)
    sj, zj = jax.jit(lambda v: j_quant.compute_scale(v, js))(jnp.asarray(x))
    st, zt = t_quant.compute_scale(_t(x), ts)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(
        t_quant.quantize_int(_t(x), st, zt, ts).numpy(),
        np.asarray(j_quant.quantize_int(jnp.asarray(x), sj, zj, js)))
    np.testing.assert_allclose(
        t_quant.fake_quant_dynamic(_t(x), ts).numpy(),
        np.asarray(jax.jit(lambda v: j_quant.fake_quant_dynamic(v, js))(
            jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_fake_quant_gradient_is_the_clipped_straight_through():
    spec = t_quant.QuantSpec(bits=4)
    x = torch.tensor([-3.0, -0.4, 0.1, 0.6, 5.0], requires_grad=True)
    s, z = torch.tensor([0.1]), torch.tensor([0.0])
    t_quant.fake_quant(x, s, z, spec).sum().backward()
    gj = jax.grad(lambda v: j_quant.fake_quant(
        v, jnp.asarray([0.1]), jnp.asarray([0.0]),
        j_quant.QuantSpec(bits=4)).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gj))


def test_pack_weights_and_int_matmul_match_reference():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    jp = j_quant.pack_weights_int8({"wq": jnp.asarray(w)}, min_size=16)
    tp = t_quant.pack_weights_int8({"wq": _t(w)}, min_size=16)
    np.testing.assert_array_equal(tp["wq"]["q"].numpy(),
                                  np.asarray(jp["wq"]["q"]))
    np.testing.assert_array_equal(tp["wq"]["s"].numpy(),
                                  np.asarray(jp["wq"]["s"]))
    qx = rng.integers(-128, 128, (3, 5, 64)).astype(np.int8)
    np.testing.assert_array_equal(
        t_quant.int_matmul(_t(qx), tp["wq"]["q"]).numpy(),
        np.asarray(j_quant.int_matmul(jnp.asarray(qx), jp["wq"]["q"])))


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        t_common.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(j_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            t_common.apply_rope(_t(x), _t(pos), theta).numpy(),
            np.asarray(j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           theta)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "bias", "quant", "packed"])
def test_linear_matches_reference(mode):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32) * 0.2
    b = rng.normal(size=48).astype(np.float32) if mode == "bias" else None
    jw, tw = jnp.asarray(w), _t(w)
    jq = tq = None
    if mode == "quant":
        jq, tq = j_quant.QuantSpec(8), t_quant.QuantSpec(8)
    if mode == "packed":
        jw = j_quant.pack_weights_int8({"wq": jw}, min_size=1)["wq"]
        tw = t_quant.pack_weights_int8({"wq": tw}, min_size=1)["wq"]
    got = t_common.linear(_t(x), tw, None if b is None else _t(b), tq)
    want = j_common.linear(jnp.asarray(x), jw,
                           None if b is None else jnp.asarray(b), jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    params = j_mlp.init_mlp(jax.random.PRNGKey(2), 32, 64, jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 6, 32)).astype(np.float32)
    got = t_mlp.apply_mlp({k: _t(v) for k, v in params.items()}, _t(x),
                          act=act)
    want = j_mlp.apply_mlp(params, jnp.asarray(x), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantize_kv_matches_reference():
    x = np.random.default_rng(5).normal(size=(2, 3, 4, 8)).astype(
        np.float32) * 5
    s = np.array([0.02, 0.05, 0.1, 0.04], np.float32)
    np.testing.assert_array_equal(
        quantize_kv(_t(x), _t(s)).numpy(),
        np.asarray(j_attn.quantize_kv(jnp.asarray(x), jnp.asarray(s))))


# --------------------------------------------------------------------------
# the slice: forward (prefill) and decode of whole reduced models
# --------------------------------------------------------------------------

def _close_to_scale(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jcfg, jm, params, tm = _pair(arch)
    toks, fe = _inputs(jcfg, 2, 16, seed=len(arch))
    want = jm.forward(params, jnp.asarray(toks),
                      None if fe is None else jnp.asarray(fe))
    with torch.no_grad():
        got = tm(_t(toks), None if fe is None else _t(fe))
    assert got.shape == want.shape and got.dtype == torch.float32
    V = jcfg.vocab
    _close_to_scale(got[..., :V].numpy(), np.asarray(want)[..., :V], 1e-4)
    if jcfg.vocab_padded != V:
        assert (got[..., V:] == -1e30).all()


def test_forward_bfloat16_matches_reference():
    jcfg, jm, params, tm = _pair("qwen2-1.5b", dtype="bf16")
    toks, _ = _inputs(jcfg, 2, 16, seed=11)
    want = np.asarray(jm.forward(params, jnp.asarray(toks)), np.float32)
    got = tm(_t(toks))
    assert got.dtype == torch.bfloat16
    # four bf16 ulps (2^-7 relative) of the logit scale
    _close_to_scale(got.to(torch.float32).numpy(), want, 4 * 2.0 ** -7)


def test_packed_weights_forward_matches_reference():
    jcfg, jm, params, _ = _pair("granite-3-2b")
    packed = j_quant.pack_weights_int8(params, min_size=1)
    tm = get_model(get_config("granite-3-2b", reduced=True),
                   device="cpu").load_reference_params(_np_tree(packed))
    assert tm.params.layers[0].attn.wq.q.dtype == torch.int8
    toks, _ = _inputs(jcfg, 1, 9, seed=3)
    want = jm.forward(packed, jnp.asarray(toks))
    _close_to_scale(tm(_t(toks)).numpy(), np.asarray(want), 1e-4)


def _packed_paths(node, path=()):
    """The paths of the ``{q, s}`` leaves of a packed tree, with layer
    indices and gemma2's ``local``/``global`` keys dropped (the reference
    decides once per stack, so every layer of the port must agree)."""
    if isinstance(node, dict) and set(node) == {"q", "s"}:
        return {path}
    if isinstance(node, dict):
        return set().union(*(_packed_paths(
            v, path if (path == ("layers",) and k in ("local", "global"))
            else path + (k,)) for k, v in node.items())) if node else set()
    if isinstance(node, (list, tuple)):
        return set().union(*(_packed_paths(v, path) for v in node)) \
            if node else set()
    return set()


def _flat_port(node, prefix=""):
    if isinstance(node, dict):
        return {k2: v2 for k, v in node.items()
                for k2, v2 in _flat_port(v, f"{prefix}.{k}" if prefix
                                         else k).items()}
    if isinstance(node, (list, tuple)):
        return {k2: v2 for i, v in enumerate(node)
                for k2, v2 in _flat_port(v, f"{prefix}.{i}").items()}
    return {prefix: node}


@pytest.mark.parametrize("arch", list_archs())
def test_pack_weights_default_min_size_matches_reference(arch):
    """At the default ``min_size`` (4096) the port packs exactly the
    leaves the reference packs, whose layer arrays are stacked (ROADMAP
    C2), to the same bits, and the logits agree within 1e-4 of their
    scale.  Packed MoE experts run in neither package (reference fault
    9), so the MoE configs compare the packed leaves only."""
    jcfg, jm, params, tm = _pair(arch)
    jpacked = j_quant.pack_weights_int8(params)
    tpacked = t_quant.pack_weights_int8(tm.param_tree(), cfg=tm.cfg)
    want = _packed_paths(_np_tree(jpacked))
    assert want and _packed_paths(tpacked) == want
    n_layers = len(tpacked["layers"])
    for i in range(n_layers):        # every layer decides like the stack
        assert _packed_paths(tpacked["layers"][i], ("layers",)) == {
            p for p in want if p[0] == "layers"}
    if jcfg.family == "moe":
        return
    flat = load_reference_params(tm.cfg, _np_tree(jpacked))
    got = _flat_port(tpacked)
    assert sorted(got) == sorted(flat)
    for name, t in flat.items():
        assert torch.equal(got[name], t), name
    tm_packed = get_model(tm.cfg, device="cpu").load_reference_params(
        _np_tree(jpacked))
    toks, fe = _inputs(jcfg, 1, 9, seed=5)
    want_logits = jm.forward(jpacked, jnp.asarray(toks),
                             None if fe is None else jnp.asarray(fe))
    with torch.no_grad():
        got_logits = tm_packed(_t(toks), None if fe is None else _t(fe))
    V = jcfg.vocab
    _close_to_scale(got_logits[..., :V].numpy(),
                    np.asarray(want_logits)[..., :V], 1e-4)


def test_pack_weights_of_a_layer_list_needs_the_cfg():
    """The stacked size that ``min_size`` is held against depends on the
    family (gemma2's halves, the pad experts), so a tree with a
    ``layers`` list is refused without the model's cfg."""
    tm = get_model(get_config("qwen2-1.5b", reduced=True),
                   device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cfg"):
        t_quant.pack_weights_int8(tm.param_tree())
    packed = t_quant.pack_weights_int8(tm.param_tree(), cfg=tm.cfg)
    assert isinstance(packed["layers"][0]["attn"]["wq"], dict)


def test_state_dict_is_the_converted_tree():
    jcfg, _, params, tm = _pair("gemma2-2b")
    flat = load_reference_params(tm.cfg, _np_tree(params))
    sd = tm.params.state_dict()
    assert sorted(sd) == sorted(flat)
    assert len(tm.params.layers) == jcfg.n_layers
    # gemma2: layer 2i is local[i], layer 2i+1 is global[i]
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].numpy(),
        np.asarray(params["layers"]["global"]["attn"]["wq"][0]))
    assert "lm_head" not in sd and "layers.0.post_ln1" in sd


def _decode_both(arch, B, S, toks, *, kv_dtype=None, valid_from=None):
    jcfg, jm, params, tm = _pair(arch)
    jdec = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, S, kv_dtype=None if kv_dtype is None
                           else jnp.int8)
    tcache = tm.init_cache(B, S, kv_dtype=kv_dtype)
    jv = None if valid_from is None else jnp.asarray(valid_from)
    tv = None if valid_from is None else _t(valid_from)
    jouts, touts = [], []
    for t in range(S):
        lj, jcache = jdec(params, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.asarray(t), valid_from=jv)
        lt, tcache = tm.decode_step(_t(toks[:, t:t + 1]), tcache, t,
                                    valid_from=tv)
        jouts.append(np.asarray(lj[:, 0]))
        touts.append(lt[:, 0].numpy())
    return np.stack(touts, 1), np.stack(jouts, 1), tcache, jcache


@pytest.mark.parametrize("case", ["qwen2", "gemma2 rolling", "int8 cache",
                                  "valid_from"])
def test_decode_matches_reference(case):
    arch = "gemma2-2b" if case == "gemma2 rolling" else "qwen2-1.5b"
    jcfg = j_get_config(arch, reduced=True)
    # gemma2: 40 steps wrap its 32-deep local buffer
    B, S = 2, 40 if case == "gemma2 rolling" else 12
    toks, _ = _inputs(jcfg, B, S, seed=7)
    kw = {}
    if case == "int8 cache":
        kw["kv_dtype"] = torch.int8
    if case == "valid_from":        # row 1 is left-padded by 5 slots
        kw["valid_from"] = np.array([0, 5], np.int32)
    got, want, tcache, jcache = _decode_both(arch, B, S, toks, **kw)
    _close_to_scale(got[..., :jcfg.vocab], want[..., :jcfg.vocab], 1e-4)
    if case == "int8 cache":        # the stored integers agree too
        diff = np.abs(tcache["k"].numpy().astype(np.int32)
                      - np.asarray(jcache["k"]).astype(np.int32))
        assert tcache["k"].dtype == torch.int8 and diff.max() <= 1
        assert (diff > 0).mean() < 1e-3
    if case == "gemma2 rolling":
        assert tcache["local"]["k"].shape[2] == jcfg.sliding_window


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch):
    """The port's twin of the reference's ``test_decode_matches_prefill``:
    token-by-token decode reproduces the prefill's logits."""
    jcfg, _, _, tm = _pair(arch)
    B, S = 2, 12
    toks = torch.from_numpy(_inputs(jcfg, B, S, seed=1)[0]).long()
    ref = tm(toks)
    cache = tm.init_cache(B, S)
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(toks[:, t:t + 1], cache, t)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=1e-3, atol=2e-3)


def test_valid_from_with_a_rolling_cache_raises():
    _, _, _, tm = _pair("gemma2-2b")
    cache = tm.init_cache(2, 8)
    with pytest.raises(NotImplementedError):
        tm.decode_step(torch.zeros(2, 1, dtype=torch.long), cache, 0,
                       valid_from=torch.tensor([0, 1]))


# --------------------------------------------------------------------------
# the device
# --------------------------------------------------------------------------

def test_default_device_is_the_card():
    cfg = get_config("qwen2-1.5b", reduced=True)
    if torch.cuda.is_available():
        assert get_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(cfg)


def test_init_draws_the_reference_distributions():
    cfg = get_config("qwen2-1.5b", reduced=True)
    tm = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(tm, Model)
    p = tm.params
    assert not any(t.requires_grad for t in tm.parameters())
    for w, std in ((p.embed, 1.0), (p.layers[0].attn.wq, 64 ** -0.5),
                   (p.layers[0].attn.wo, 64 ** -0.5),
                   (p.layers[1].mlp.w_down, 128 ** -0.5)):
        assert float(w.abs().max()) <= 2 * std + 1e-6
        # a normal truncated at ±2 sigma has 0.880 of sigma as its std
        assert abs(float(w.std()) / std - 0.880) < 0.05
    assert float(p.layers[0].attn.bq.abs().max()) == 0.0
    assert float(p.final_norm.abs().max()) == 0.0
