"""Fake-quant and int8-compression parity with the *compiled* reference.

The reference's fake-quant runs inside its layers' ``lax.scan`` and its
gradient compression inside the jitted train step, so XLA compiles both:
``amax / qmax`` becomes ``amax * float32(1 / qmax)``, which differs from
the IEEE quotient in the last bit for some ``amax``.  A scale one ulp
lower moves the clip bound ``qmax * s`` below a column's max element,
and the clipped STE then gives that element no gradient.  These tests
hold the port to ``jax.jit`` of the reference's functions:

  * ``compute_scale`` (per tensor, channel, group; asymmetric; float32
    and bf16), ``quantize_tensor``, three steps of ``compress_grads`` and
    ``compressed_psum`` over a one-rank axis: bit-equal;
  * power-of-two scales (``pot=True``, C6) in float32, bf16 and float64,
    and ``pot_scale`` alone over every bf16 and float16 value and the
    float32 and float64 exponent ranges: bit-equal;
  * every config's weight clip masks (``|w| > qmax * s``): bit-equal;
  * ``Model.loss(quant=QuantSpec(8))``'s gradient on all ten reduced
    configs against ``jax.jit(jax.grad)`` of the reference's quantized
    loss, as its train step runs it: every leaf within 1e-4 of its
    largest |g|, the bar of ``test_family_gradient_matches_reference``.
    Jitted, because an unjitted ``jax.grad`` hoists what depends only on
    weights the scan does not carry (zamba2's shared attention block) out
    of the scan and runs it eagerly, with the IEEE quotient: 0.29 of a
    leaf's max on zamba2's shared ``wv``.  mamba2 and zamba2 run both
    packages in float64: their float32 SSD sums differ enough to move an
    activation across a quantization level (0.15 and 0.08 of
    ``norm_scale``'s max in float32), which float64 removes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.quant import quantizer as j_quant
from repro.quant.quantizer import QuantSpec as JQuantSpec
from repro.train import compression as j_comp
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as t_attention
from repro_torch.models import get_model, load_reference_params
from repro_torch.quant import quantizer as t_quant
from repro_torch.quant.quantizer import QuantSpec
from repro_torch.train import compression as t_comp
from repro_torch.tree import leaves
from test_torch_families import _flat_grads

F64_ARCHS = ("mamba2-780m", "zamba2-2.7b")
QUANTIZED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
             "in_proj", "out_proj")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a):
    """A float array's bit pattern, for an equality that tells -0 from 0
    and compares bf16 without widening."""
    a = np.asarray(a)
    if a.dtype in (jnp.bfloat16, np.float16):
        return a.view(np.uint16)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _tbits(t):
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


# --------------------------------------------------------------------------
# compute_scale
# --------------------------------------------------------------------------

SCALE_SPECS = {
    "per_tensor": dict(bits=8),
    "per_channel": dict(bits=8, granularity="per_channel"),
    "per_channel narrow 4": dict(bits=4, narrow=True,
                                 granularity="per_channel"),
    "per_group 4": dict(bits=4, granularity="per_group", group_size=32),
    "asymmetric unsigned": dict(bits=8, signed=False, symmetric=False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SCALE_SPECS))
def test_compute_scale_equals_compiled_reference(name, dtype):
    """Scale and zero point bit-equal to ``jax.jit(compute_scale)`` on 48
    seeded 64 x 256 tensors; in float32 some of them are ones where the
    eager reference's IEEE quotient differs (asserted: per tensor, seeds
    18, 26, 37 and 43), so the test tells the two forms apart."""
    js = JQuantSpec(**SCALE_SPECS[name])
    ts = QuantSpec(**SCALE_SPECS[name])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = jax.jit(lambda v: j_quant.compute_scale(v, js))
    eager_differs = 0
    for seed in range(48):
        x = np.random.default_rng(seed).normal(size=(64, 256))
        sj, zj = scale(jnp.asarray(x, jdt))
        st, zt = t_quant.compute_scale(torch.from_numpy(x).to(tdt), ts)
        assert st.dtype == tdt and tuple(st.shape) == sj.shape
        np.testing.assert_array_equal(_tbits(st), _bits(sj))
        np.testing.assert_array_equal(_tbits(zt), _bits(zj))
        se, _ = j_quant.compute_scale(jnp.asarray(x, jdt), js)
        eager_differs += int(not np.array_equal(_bits(se), _bits(sj)))
    if dtype == "float32":
        assert eager_differs > 0



POT_DTYPES = ("float32", "bfloat16", "float64")
POT_SPECS = dict(SCALE_SPECS, **{
    "per_group 8": dict(bits=8, granularity="per_group", group_size=32)})
# Of the 20 seeded tensors, how many the eager form
# exp2(ceil(log2(s))) gives another scale than the compiled reference.
NAIVE_DIFFERS = {("per_tensor", "bfloat16"): 20,
                 ("per_channel", "bfloat16"): 20,
                 ("asymmetric unsigned", "bfloat16"): 20,
                 ("per_group 8", "bfloat16"): 20,
                 ("per_channel", "float64"): 20}


@pytest.mark.parametrize("dtype", POT_DTYPES)
@pytest.mark.parametrize("name", list(POT_SPECS))
def test_pot_scale_equals_compiled_reference(name, dtype):
    """C6: ``compute_scale(..., pot=True)`` bit-equal to
    ``jax.jit(compute_scale)`` on 20 seeded 64 x 256 tensors, per tensor,
    channel and group, symmetric and asymmetric.  The eager form
    ``exp2(ceil(log2(s)))`` of the same scale differs from the compiled
    one on the tensors ``NAIVE_DIFFERS`` counts (asserted), so the test
    tells the two apart."""
    kw = dict(POT_SPECS[name], pot=True)
    js, ts = JQuantSpec(**kw), QuantSpec(**kw)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    scale = jax.jit(lambda v: j_quant.compute_scale(v, js))
    naive_differs = 0
    with jax.enable_x64(True):
        for seed in range(20):
            x = np.random.default_rng(seed).normal(size=(64, 256))
            sj, zj = scale(jnp.asarray(x, jdt))
            st, zt = t_quant.compute_scale(torch.from_numpy(x).to(tdt), ts)
            assert st.dtype == tdt and tuple(st.shape) == sj.shape
            np.testing.assert_array_equal(_tbits(st), _bits(sj))
            np.testing.assert_array_equal(_tbits(zt), _bits(zj))
            s0, _ = t_quant.compute_scale(torch.from_numpy(x).to(tdt),
                                          QuantSpec(**POT_SPECS[name]))
            naive = torch.exp2(torch.ceil(torch.log2(s0)))
            naive_differs += int(not np.array_equal(_tbits(naive),
                                                    _bits(sj)))
    assert naive_differs == NAIVE_DIFFERS.get((name, dtype), 0)


@pytest.mark.parametrize("dtype", POT_DTYPES + ("float16",))
def test_pot_scale_equals_compiled_reference_everywhere(dtype):
    """``pot_scale`` against ``jax.jit(exp2(ceil(log2(s))))``: every bf16
    and float16 value (±, zero, subnormals, inf, nan); in float32 and
    float64 each power of two with its neighbours, both signs, the
    extremes and 200000 seeded values over the whole exponent range."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    f = jax.jit(lambda s: jnp.exp2(jnp.ceil(jnp.log2(s))))
    if dtype in ("bfloat16", "float16"):
        x = torch.arange(0, 1 << 16, dtype=torch.int32).to(
            torch.int16).view(tdt)
        xn = x.float().numpy()
    else:
        npdt = np.dtype(dtype)
        fi = np.finfo(npdt)
        lo, hi = (-149, 127) if dtype == "float32" else (-1074, 1023)
        p = np.array([2.0 ** k for k in range(lo, hi + 1)]).astype(npdt)
        rng = np.random.default_rng(0)
        xn = np.concatenate([
            p, np.nextafter(p, np.inf), np.nextafter(p, 0), -p,
            np.array([0.0, fi.max, fi.tiny, np.inf, np.nan], npdt),
            (rng.uniform(0, 1, 200000)
             * 2.0 ** rng.integers(lo + 30, hi, 200000)).astype(npdt)])
        x = torch.from_numpy(xn)
    with jax.enable_x64(True):
        want = f(jnp.asarray(xn).astype(jdt))
    got = t_quant.pot_scale(x)
    nan = np.isnan(np.asarray(want, np.float64)) & torch.isnan(
        got.double()).numpy()
    assert got.dtype == tdt
    np.testing.assert_array_equal(_tbits(got)[~nan], _bits(want)[~nan])


def test_zero_point_keeps_its_division():
    """The compiled reference multiplies by 1/(qmax - qmin) for the scale
    but divides ``x_lo / s`` for the zero point; a zero point from
    ``x_lo * (1 / s)`` would round the other way on some input."""
    js = JQuantSpec(bits=8, signed=False, symmetric=False)
    ts = QuantSpec(bits=8, signed=False, symmetric=False)
    hlo = jax.jit(lambda v: j_quant.compute_scale(v, js)).lower(
        jnp.zeros((4, 8), jnp.float32)).compile().as_text()
    assert " divide(" in hlo and " multiply(" in hlo
    for seed in range(64):
        x = np.random.default_rng(seed).uniform(-3, 5, size=(4, 8))
        x = x.astype(np.float32)
        _, zj = jax.jit(lambda v: j_quant.compute_scale(v, js))(
            jnp.asarray(x))
        _, zt = t_quant.compute_scale(_t(x), ts)
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))


# --------------------------------------------------------------------------
# gradient compression (``--compress-grads``)
# --------------------------------------------------------------------------

def _grad_tensors(n=200):
    return [np.random.default_rng(seed).normal(size=(64, 64))
            .astype(np.float32) for seed in range(n)]


def test_quantize_tensor_equals_compiled_reference():
    """Payload and scale bit-equal to ``jax.jit(quantize_tensor)`` on 200
    seeded normal tensors, among them the ones where the eager reference
    takes another scale (13 of these 200)."""
    qt_jit = jax.jit(j_comp.quantize_tensor)
    eager_differs = 0
    for g in _grad_tensors():
        qj, sj = qt_jit(jnp.asarray(g))
        qt, st = t_comp.quantize_tensor(_t(g))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(_tbits(st), _bits(sj))
        _, se = j_comp.quantize_tensor(jnp.asarray(g))
        eager_differs += int(float(se) != float(sj))
    assert eager_differs > 0


def test_compress_grads_three_steps_equal_compiled_reference():
    """Three steps of error feedback, dequantized grads and carried error
    bit-equal to ``jax.jit(compress_grads)``, on trees whose leaves
    include tensors where the eager scale differs."""
    gs = _grad_tensors()
    qt_jit = jax.jit(j_comp.quantize_tensor)
    picked = [g for g in gs if float(qt_jit(jnp.asarray(g))[1])
              != float(j_comp.quantize_tensor(jnp.asarray(g))[1])]
    assert len(picked) >= 3
    steps = [{"w": picked[i], "v": [gs[i] * 1e-3, gs[i + 3][:3, :5]]}
             for i in range(3)]
    step = jax.jit(j_comp.compress_grads)
    j_ef = j_comp.init_error_feedback(jax.tree.map(jnp.asarray, steps[0]))
    t_ef = t_comp.init_error_feedback(jax.tree.map(_t, steps[0]))
    for g in steps:
        j_deq, j_ef = step(jax.tree.map(jnp.asarray, g), j_ef)
        t_deq, t_ef = t_comp.compress_grads(jax.tree.map(_t, g), t_ef)
        for got, want in zip(leaves(t_deq) + leaves(t_ef),
                             jax.tree.leaves(j_deq) + jax.tree.leaves(j_ef)):
            np.testing.assert_array_equal(_tbits(got), _bits(want))


def test_compressed_psum_one_rank_equals_compiled_reference():
    """Over a one-rank axis the int8 all-reduce is bit-equal to the
    reference's ``compressed_psum`` jitted under ``shard_map`` on one
    device, on the tensors where the eager scale differs."""
    from jax.sharding import Mesh, PartitionSpec as P
    from repro_torch.launch.mesh import make_layout, use_layout
    try:
        from jax import shard_map
    except ImportError:                      # older JAX
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    psum = jax.jit(shard_map(lambda v: j_comp.compressed_psum(v, "pod"),
                             mesh=mesh, in_specs=P(), out_specs=P()))
    qt_jit = jax.jit(j_comp.quantize_tensor)
    picked = [g for g in _grad_tensors() if float(qt_jit(jnp.asarray(g))[1])
              != float(j_comp.quantize_tensor(jnp.asarray(g))[1])]
    assert picked
    with use_layout(make_layout((1, 1, 1), ("pod", "data", "model"))):
        for g in picked:
            got = t_comp.compressed_psum(_t(g), "pod")
            np.testing.assert_array_equal(_tbits(got),
                                          _bits(psum(jnp.asarray(g))))


# --------------------------------------------------------------------------
# the ten configs under QuantSpec(8)
# --------------------------------------------------------------------------

_PAIRS = {}


def _pair(arch):
    """(reference model, its params, the port's model with the same
    weights); float64 for the SSM families (module docstring)."""
    if arch not in _PAIRS:
        jcfg = j_get_config(arch, reduced=True)
        tcfg = get_config(arch, reduced=True)
        if arch in F64_ARCHS:
            jcfg = dataclasses.replace(jcfg, dtype=jnp.float64)
            tcfg = dataclasses.replace(tcfg, dtype=torch.float64)
        jm = j_get_model(jcfg)
        params = jm.init(jax.random.PRNGKey(0))
        tm = get_model(tcfg, device="cpu").load_reference_params(
            jax.tree.map(np.asarray, params))
        _PAIRS[arch] = (jcfg, jm, params, tm)
    return _PAIRS[arch]


def _x64(arch):
    return jax.enable_x64(arch in F64_ARCHS)


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    fe = None
    if cfg.frontend_len:
        fe = rng.normal(size=(2, cfg.frontend_len, cfg.d_model))
    return toks, np.roll(toks, -1, axis=1), fe


@pytest.mark.parametrize("arch", list_archs())
def test_fake_quant_gradient_matches_reference(arch, monkeypatch):
    """``Model.loss(quant=QuantSpec(8))`` differentiated by autograd
    against ``jax.grad`` of the reference's: every leaf within 1e-4 of its
    largest |g| (before C4's fix: 0.18-0.50 on the worst leaf of every
    config), losses within 1e-5 relative.  In float64 (zamba2's shared
    attention) the prefill attention is the kernel's plain version,
    which the wrapper runs for CPU tensors in the other dtypes: the
    wrapper itself takes no float64."""
    if arch in F64_ARCHS:
        monkeypatch.setattr(t_attention, "flash_attention",
                            flash_attention_ref)
    with _x64(arch):
        jcfg, jm, params, tm = _pair(arch)
        toks, labels, fe = _inputs(jcfg)
        fdt = jnp.float64 if arch in F64_ARCHS else jnp.float32
        jfe = None if fe is None else jnp.asarray(fe, fdt)
        lj, gj = jax.jit(jax.value_and_grad(lambda p: jm.loss(
            p, jnp.asarray(toks), jnp.asarray(labels), jfe,
            quant=JQuantSpec(8))))(params)
        want = load_reference_params(tm.cfg, jax.tree.map(np.asarray, gj))
        tparams = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                               tm.param_tree())
        tfe = None if fe is None else _t(np.asarray(jfe))
        lt = tm.loss(tparams, _t(toks), _t(labels), tfe,
                     quant=QuantSpec(8))
        lt.backward()
    assert abs(lt.item() - float(lj)) <= 1e-5 * abs(float(lj))
    got = _flat_grads(tparams)
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        g = g.numpy().astype(np.float64)
        d = np.abs(got[k].numpy().astype(np.float64) - g).max()
        assert d <= 1e-4 * np.abs(g).max(), (k, d / np.abs(g).max())


@pytest.mark.parametrize("arch", list_archs())
def test_weight_clip_masks_equal_compiled_reference(arch):
    """Every fake-quantized weight (``linear``'s per-output-channel spec)
    has the compiled reference's scale and so its clip mask
    ``|w| > qmax * s``, bit for bit, on the reduced config's weights
    (float32 for every config here: the masks do not depend on
    activations)."""
    jcfg = j_get_config(arch, reduced=True)
    params = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tm = get_model(get_config(arch, reduced=True), device="cpu")
    flat = load_reference_params(tm.cfg, jax.tree.map(np.asarray, params))
    js = JQuantSpec(bits=8, granularity="per_channel", channel_axis=-1)
    ts = QuantSpec(bits=8, granularity="per_channel", channel_axis=-1)
    scale = jax.jit(lambda w: j_quant.compute_scale(w, js)[0])
    n = 0
    for k, w in flat.items():
        if k.rsplit(".", 1)[-1] not in QUANTIZED or w.dim() != 2:
            continue
        sj = scale(jnp.asarray(w.numpy()))
        st, _ = t_quant.compute_scale(w, ts)
        np.testing.assert_array_equal(_tbits(st), _bits(sj), err_msg=k)
        mj = np.abs(w.numpy()) > np.asarray(js.qmax * sj)
        mt = (w.abs() > ts.qmax * st).numpy()
        np.testing.assert_array_equal(mt, mj, err_msg=k)
        n += 1
    assert n > 0
