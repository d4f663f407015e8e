"""Tests that need a CUDA device: each hand-written kernel against its
plain PyTorch version, compiled models (interval- and affine-proven
plans) against the numpy interpreter, reduced LM prefills (dense, MoE,
Mamba2, Zamba2; glm4, internvl2 and musicgen with their frontends)
through the flash-attention kernel, the attention backward kernels, the
LM's gradient (also under fake-quant) and ``launch.train.main`` (remat, a
bit-exact resume), accumulator-aware QAT (training, resume,
the exported model through the kernels), and the serving path
(``paged_attention``, the reduced engine against the CPU's), on the card.  They skip elsewhere (decided
inside each test, never at import).  This file imports neither ``jax``
nor ``repro``, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_gpu.py -q

``python3 chip_smoke.py`` makes the same comparisons at the main path's
real shapes.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import build_flow
from repro_torch.core.workloads import WORKLOADS
from repro_torch.kernels import _build, ops as kops
from repro_torch.kernels.flash_attention import (
    BWD_KERNELS, CUDA_CORES, ROUTES as BWD_ROUTES, TENSOR_CORES,
    flash_attention_bwd, flash_attention_fwd, flash_attention_fwd_lse,
    grad_tolerance, route_for, tolerance)
from repro_torch.kernels.int_matmul import ROUTES, TENSOR_CORES, k_major
from repro_torch.kernels.multithreshold import ROUTES as MT_ROUTES
from repro_torch.kernels.ref import (DEAD_LSE, flash_attention_bwd_ref,
                                     flash_attention_bwd_magnitudes,
                                     flash_attention_lse_ref,
                                     flash_attention_ref)
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn_mod, get_model
from repro_torch.quant.quantizer import QuantSpec
from repro_torch.qat import (QATConfig, check_budget_invariant,
                             proven_layer_bits, run_qat)
from repro_torch.serve import (Request, ServingConfig, ServingEngine,
                               derive_kv_spec)
from repro_torch.tree import flatten, leaves, unflatten

NEEDS_CARD = "needs a CUDA device (the kernels have no CPU mode)"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["int_matmul", "multithreshold",
                                    "quantize"])
def test_cuda_kernel_equals_plain_version(kernel):
    """On a card: the hand-written kernel against its plain version,
    integers and the dequant epilogue exact.  Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    if kernel == "int_matmul":
        for dt in (np.int8, np.int32):
            x = _t(rng.integers(-100, 101, (130, 200)).astype(dt)).to(dev)
            w = _t(rng.integers(-100, 101, (200, 10)).astype(dt)).to(dev)
            s = _t(rng.uniform(.01, .1, 10).astype(np.float32)).to(dev)
            for kw in (dict(), dict(acc_bits=12),
                       dict(acc_bits=12, out_dtype=torch.int32)):
                got = kops.int_matmul(x, w, use_kernel=True, **kw)
                want = kops.int_matmul(x, w, use_kernel=False, **kw)
                assert got.dtype == want.dtype and torch.equal(got, want)
            got = kops.int_matmul(x, w, s, s, use_kernel=True)
            assert torch.equal(got, kops.int_matmul(x, w, s, s,
                                                    use_kernel=False))
    elif kernel == "multithreshold":
        for dt in (np.int32, np.float32, np.float64):
            x = _t(rng.integers(-500, 500, (33, 130)).astype(dt)).to(dev)
            t = _t(np.sort(rng.integers(-400, 400, (255, 130)), 0
                           ).astype(dt)).to(dev)
            got = kops.multithreshold(x, t, out_bias=-1, use_kernel=True)
            assert torch.equal(got, kops.multithreshold(
                x, t, out_bias=-1, use_kernel=False))
    else:
        for dt in (np.float32, np.float64):
            x = _t((rng.normal(size=(257, 5)) * 3).astype(dt)).to(dev)
            s = _t(rng.uniform(.01, .3, 5).astype(np.float32)).to(dev)
            z = torch.zeros(5, device=dev)
            got = kops.quantize(x, s, z, use_kernel=True)
            assert torch.equal(got, kops.quantize(x, s, z,
                                                  use_kernel=False))


def _offset_view(a: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of ``a`` lying ``nbytes`` past a 16-byte boundary."""
    size = a.element_size()
    flat = torch.empty(a.numel() + 32 // size, dtype=a.dtype,
                       device=a.device)
    lead = (-flat.data_ptr() % 16 + nbytes) // size
    view = flat[lead:lead + a.numel()].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 == nbytes
    return view


def _mt_edge(rng, m, c, n, dt):
    """x (m, c) and ascending thresholds (n, c) with INT32_MIN/MAX or
    +-inf in both, NaN in x, a run of equal thresholds and exact ties."""
    if dt == np.int32:
        info = np.iinfo(np.int32)
        pool = np.array([info.min, info.max, info.max - 1, 0], np.int64)
        t, x, xpool = (rng.integers(-300, 300, (n, c)),
                       rng.integers(-350, 350, (m, c)), pool)
    else:
        pool = np.array([np.inf, -np.inf, 0.0, 1e30])
        t, x = (rng.integers(-1200, 1200, (n, c)) / 4,
                rng.integers(-1400, 1400, (m, c)) / 4)
        xpool = np.append(pool, np.nan)
    t = np.where(rng.random((n, c)) < 0.15, rng.choice(pool, (n, c)), t)
    x = np.where(rng.random((m, c)) < 0.15, rng.choice(xpool, (m, c)), x)
    if n > 4:
        t[:3] = t[3]
    t = np.sort(t.astype(dt), axis=0)
    x = x.astype(dt)
    if n:
        x[1], x[2] = t[n // 2], t[-1]
    return x, t


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(MT_ROUTES))
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_multithreshold_route_equals_plain_version_on_edges(dtype, route):
    """Each route, forced, over narrow and odd C, N = 0, 15, 16, 255 and
    the edge values, x contiguous and one element off 16 bytes; one
    launch of that route each, 0 differing elements."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    dt = getattr(np, dtype)
    rng = np.random.default_rng(len(dtype) + len(route))
    dev = torch.device("cuda")
    i = 0
    for n in (0, 15, 16, 255):
        for c in (1, 4, 8, 16, 17, 64, 130):
            xn, tn = _mt_edge(rng, (7, 300)[i % 2], c, n, dt)
            x, t = _t(xn).to(dev), _t(tn).to(dev)
            for view in (x, _offset_view(x, x.element_size())):
                kw = dict(out_bias=(0, -1, 3)[i % 3],
                          out_dtype=(torch.int8, torch.int16,
                                     torch.int32)[i % 3])
                _build.reset_launch_counts()
                got = kops.multithreshold(view, t, use_kernel=True,
                                          route=route, **kw)
                assert _build.LAUNCH_COUNTS[f"multithreshold:{route}"] == 1
                want = kops.multithreshold(view, t, use_kernel=False, **kw)
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (n, c, kw, view.data_ptr() % 16)
                i += 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantize_takes_misaligned_views_and_ragged_totals(dtype):
    """x one element off 16 bytes, totals not a multiple of 4, per-channel
    C not a multiple of 4, per-tensor and per-channel: equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    dt = getattr(np, dtype)
    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    for m, c in ((7, 3), (33, 7), (257, 5), (1, 1), (300, 64)):
        x = _t((rng.normal(size=(m, c)) * 3).astype(dt)).to(dev)
        s = _t(rng.uniform(.01, .3, c).astype(np.float32)).to(dev)
        z = _t(rng.integers(-2, 3, c).astype(np.float32)).to(dev)
        for view in (x, _offset_view(x, x.element_size())):
            for sc, zp in ((s, z), (s[:1], z[:1])):
                for kw in (dict(), dict(qmin=0, qmax=255,
                                        out_dtype=torch.int32)):
                    got = kops.quantize(view, sc, zp, use_kernel=True, **kw)
                    want = kops.quantize(view, sc, zp, use_kernel=False,
                                         **kw)
                    assert torch.equal(got, want), (m, c, kw)


# the main path's edge shapes: K not a multiple of 16 (no TMA for x), N
# below or off wgmma's multiple of 8 and past one 256-column tile, M
# around the 64/128-row tiles
EDGE_K = (8, 9, 16, 27, 32, 33, 49, 144, 576, 2304)
EDGE_N = (1, 8, 10, 16, 64, 256, 257)
EDGE_M = (1, 63, 65, 129, 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("k", EDGE_K)
def test_int_matmul_route_equals_plain_version_on_edge_shapes(k, route):
    """Each route, forced, over every N and M of the edge grid: wide,
    narrow (int16 wrap, to int16 and to int32) and the dequant epilogue
    with and without a bias, the weight row-major and K-major in turns;
    0 differing elements."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(k)
    dev = torch.device("cuda")
    forms = [dict(), dict(acc_bits=12), dict(acc_bits=13,
                                               out_dtype=torch.int32),
             dict(scale=True, bias=True), dict(scale=True, acc_bits=12)]
    i = 0
    for n in EDGE_N:
        w = _t(rng.integers(-8, 8, (k, n)).astype(np.int8)).to(dev)
        s = _t(rng.uniform(.01, .1, n).astype(np.float32)).to(dev)
        for m in EDGE_M:
            x = _t(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(dev)
            kw = dict(forms[i % len(forms)])
            if "scale" in kw:
                kw["scale"] = s
            if "bias" in kw:
                kw["bias"] = -s
            wl = k_major(w) if i % 2 else w
            _build.reset_launch_counts()
            got = kops.int_matmul(x, wl, use_kernel=True, route=route, **kw)
            assert _build.LAUNCH_COUNTS[f"int_matmul:{route}"] == 1
            want = kops.int_matmul(x, w, use_kernel=False, **kw)
            assert got.dtype == want.dtype and torch.equal(got, want), \
                (m, k, n, kw)
            i += 1


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_int_matmul_route_takes_views_and_wraps_like_int16(route):
    """x at an odd byte offset and with rows wider than K, an int16
    overflow in narrow mode: each route equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    for k in (64, 27):
        w = _t(rng.integers(-8, 8, (k, 24)).astype(np.int8)).to(dev)
        flat = _t(rng.integers(-128, 128, 300 * k + 1).astype(np.int8)
                  ).to(dev)
        wide = _t(rng.integers(-128, 128, (300, k + 16)).astype(np.int8)
                  ).to(dev)
        for x in (flat[1:].view(300, k), wide[:, 16:]):
            got = kops.int_matmul(x, w, use_kernel=True, route=route,
                                  acc_bits=14)
            assert torch.equal(got, kops.int_matmul(
                x, w, use_kernel=False, acc_bits=14))
    x = _t(rng.integers(-128, 128, (200, 576)).astype(np.int8)).to(dev)
    w = _t(rng.integers(-128, 128, (576, 64)).astype(np.int8)).to(dev)
    for out_dtype in (None, torch.int32):
        got = kops.int_matmul(x, w, use_kernel=True, route=route,
                              acc_bits=15, out_dtype=out_dtype)
        want = kops.int_matmul(x, w, use_kernel=False, acc_bits=15,
                               out_dtype=out_dtype)
        assert torch.equal(got, want)
        assert int((x.cpu().int() @ w.cpu().int()).abs().max()) > 2 ** 15


@pytest.mark.gpu
def test_forced_tensor_core_int_matmul_raises_on_what_it_cannot_take():
    """int32 operands or K = 0 forced onto the tensor cores raise; the
    CUDA-core kernel is not run in their place."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    dev = torch.device("cuda")
    xi = torch.ones((64, 32), dtype=torch.int32, device=dev)
    x0 = torch.ones((64, 0), dtype=torch.int8, device=dev)
    w0 = torch.ones((0, 16), dtype=torch.int8, device=dev)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="tensor-core"):
        kops.int_matmul(xi, xi.T.contiguous(), use_kernel=True,
                        route=TENSOR_CORES)
    with pytest.raises(ValueError, match="tensor-core"):
        kops.int_matmul(x0, w0, use_kernel=True, route=TENSOR_CORES)
    assert sum(_build.LAUNCH_COUNTS.values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_compiled_model_on_the_card_is_bit_exact(name):
    """``compile()`` with no arguments runs on the card through the CUDA
    kernels: integer tensors equal the numpy interpreter exactly, the
    launch counters moved."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    model = build_flow(WORKLOADS[name]()).model
    compiled = model.compile(dtype=torch.float64)
    assert compiled.device.type == "cuda"
    compiled = model.compile(dtype=torch.float64,
                             extra_outputs=compiled.int_tensors)
    feeds = next(iter(model.sample_inputs(rng=np.random.default_rng(0))))
    want = model.execute(feeds, record_all=True)
    _build.reset_launch_counts()
    got = compiled(feeds)
    assert all(_build.LAUNCH_COUNTS[k] > 0
               for k in ("int_matmul", "multithreshold", "quantize"))
    for t in compiled.int_tensors:
        np.testing.assert_array_equal(got[t].astype(np.float64), want[t])
    for o in model.graph.outputs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["TFC-w2a2", "CNV-w2a2"])
def test_affine_plan_on_the_card_is_bit_exact(name):
    """An affine-proven plan (``build_flow(..., domain="affine")``) through
    ``compile()`` on the card: integer tensors equal the numpy interpreter
    exactly, every kernel launched, and no accumulator is wider than the
    interval plan's."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    model = build_flow(WORKLOADS[name](), domain="affine").model
    assert model.domain == "affine"
    compiled = model.compile(dtype=torch.float64)
    compiled = model.compile(dtype=torch.float64,
                             extra_outputs=compiled.int_tensors)
    feeds = next(iter(model.sample_inputs(rng=np.random.default_rng(1))))
    want = model.execute(feeds, record_all=True)
    _build.reset_launch_counts()
    got = compiled(feeds)
    assert all(_build.LAUNCH_COUNTS[k] > 0
               for k in ("int_matmul", "multithreshold", "quantize"))
    for t in compiled.int_tensors:
        np.testing.assert_array_equal(got[t].astype(np.float64), want[t])
    for o in model.graph.outputs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-12, atol=1e-12)
    interval = build_flow(WORKLOADS[name]()).model.compile(
        dtype=torch.float64)
    bits_a = [op.acc_bits for op in compiled.plan if op.acc_bits is not None]
    bits_i = [op.acc_bits for op in interval.plan if op.acc_bits is not None]
    assert len(bits_a) == len(bits_i)
    assert all(a <= i for a, i in zip(bits_a, bits_i))


# (B, Sq, Sk, H, KV, hd, keywords): one case per feature, each run in
# float32 (the CUDA-core kernel) and in bfloat16 and float16 (the
# tensor-core kernel); hd 16/64/128/200/256 and lengths that no tile
# divides
FLASH_CASES = {
    "gqa": (2, 128, 128, 6, 2, 64, {}),
    "cap": (1, 100, 100, 4, 4, 32, dict(logit_cap=50.0)),
    "window": (1, 200, 200, 4, 2, 16, dict(window=37)),
    "ragged q_offset": (2, 33, 97, 4, 2, 40, dict(q_offset=64)),
    "fully masked rows": (1, 16, 32, 4, 2, 16,
                          dict(window=8, q_offset=64)),
    "not causal": (1, 40, 70, 2, 1, 16, dict(causal=False, window=12)),
    "hd 128 window": (2, 130, 130, 8, 2, 128, dict(window=50)),
    "hd 128 several tiles": (1, 150, 290, 2, 1, 128, dict(q_offset=140)),
    "hd 256": (1, 70, 70, 2, 1, 256, dict(logit_cap=30.0)),
    "hd 256 several tiles": (1, 140, 140, 2, 1, 256, dict(window=100)),
    "hd 200 gqa q_offset": (1, 90, 130, 4, 2, 200, dict(q_offset=40)),
    # the MoE and hybrid configs' layer shapes; hd 80 is a partial second
    # 64-column chunk of the 128-wide tensor-core kernel
    "zamba2 hd 80": (1, 300, 300, 32, 32, 80, {}),
    "qwen2-moe": (1, 256, 256, 16, 16, 128, {}),
    "granite-moe": (1, 256, 256, 24, 8, 64, {}),
    # glm4-9b's 32 query heads over 2 KV heads: the tensor-core dK/dV's
    # GQA sum (``flash_bwd_dkdv_sum``) adds 16 heads' partials a group
    "glm4-9b g16 ragged": (1, 200, 200, 32, 2, 128, {}),
}
FLASH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_equals_plain_version(case, dtype):
    """One launch; float32 within 2e-5; bf16/f16 within one output ulp
    plus twice the effect of rounding P (``flash_attention.tolerance``)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    B, Sq, Sk, H, KV, hd, kw = FLASH_CASES[case]
    dt = FLASH_DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(len(case))
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
               for shape in ((B, Sq, H, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
    _build.reset_launch_counts()
    got = flash_attention_fwd(q, k, v, **kw)
    assert _build.LAUNCH_COUNTS["flash_attention"] == 1
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    err = (got.double() - want.double()).abs()
    assert bool((err <= tolerance(want, v)).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_kernel_refuses_16_bit_rows_not_a_multiple_of_8(
        dtype):
    """The tensor-core kernel copies 16-byte rows: hd % 8 != 0 raises (no
    fallback), float32 takes it."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    q = torch.zeros(1, 8, 2, 12, device="cuda")
    k = torch.zeros(1, 8, 1, 12, device="cuda")
    assert flash_attention_fwd(q, k, k).shape == q.shape
    with pytest.raises(ValueError):
        flash_attention_fwd(q.to(dtype), k.to(dtype), k.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("route", BWD_ROUTES)
@pytest.mark.parametrize("dtype", list(FLASH_DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_backward_kernels_equal_plain_version(case, dtype,
                                                              route):
    """The forward's lse within 1e-5 of the plain one (rows that see no
    key aside); dq, dk, dv of the three backward kernels (one launch each,
    dK/dV and dQ on the forced route) within ``grad_tolerance`` of the
    plain backward on the same out and lse (on the ``tensor_cores`` route
    with the term for its rounding of P and dS), and bit-equal over two
    calls (no atomics).  A route the inputs cannot take raises."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    B, Sq, Sk, H, KV, hd, kw = FLASH_CASES[case]
    dt = FLASH_DTYPES[dtype]
    g = torch.Generator(device="cuda").manual_seed(len(case) + 7)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").to(dt)
                     for shape in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                   (B, Sk, KV, hd), (B, Sq, H, hd)))
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    if route == TENSOR_CORES and route_for(dt, hd) != TENSOR_CORES:
        with pytest.raises(ValueError):
            flash_attention_bwd(q, k, v, out, lse, dout, route=route, **kw)
        return
    lse_p = flash_attention_lse_ref(q, k, **kw)
    live = lse_p > DEAD_LSE
    assert torch.equal(live, lse > DEAD_LSE)
    assert bool(((lse - lse_p).abs() <= 1e-5 * lse_p.abs().clamp_min(1.0))
                [live].all())
    _build.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, dout, route=route, **kw)
    assert all(_build.LAUNCH_COUNTS[n] == 1 for n in BWD_KERNELS)
    assert all(_build.LAUNCH_COUNTS[f"{n}:{route}"] == 1
               for n in BWD_KERNELS[1:])
    again = flash_attention_bwd(q, k, v, out, lse, dout, route=route, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw) \
        if route == TENSOR_CORES else (None,) * 3
    torch.cuda.synchronize()
    for a, b, w, m in zip(got, again, want, mags):
        assert a.dtype == dt and a.shape == w.shape and torch.equal(a, b)
        err = (a.double() - w.double()).abs()
        assert bool((err <= grad_tolerance(w, m)).all()), float(err.max())


@pytest.mark.gpu
def test_flash_attention_kernel_has_a_gradient():
    """A CUDA input that needs a gradient goes through the autograd
    function: one forward launch, then one launch of each backward
    kernel, and the gradient of the plain attention's."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda")
                     for shape in ((2, 40, 4, 16), (2, 40, 2, 16),
                                   (2, 40, 2, 16), (2, 40, 4, 16)))
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _build.reset_launch_counts()
    got = torch.autograd.grad(flash_attention_fwd(*x, window=9), x, dout)
    assert _build.LAUNCH_COUNTS["flash_attention"] == 1
    assert all(_build.LAUNCH_COUNTS[n] == 1 for n in BWD_KERNELS)
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*y, window=9), y, dout)
    for a, w in zip(got, want):
        assert bool(((a - w).abs() <= 1e-5 * w.abs().max()).all())


@pytest.mark.gpu
def test_lm_prefill_on_the_card_goes_through_the_kernel():
    """A reduced gemma2 (local and global layers, soft-caps) on the card:
    one kernel launch per layer, logits equal the same model's with the
    plain attention to float32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("gemma2-2b", reduced=True)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 70), device="cuda")
    _build.reset_launch_counts()
    got = model(toks)
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    kernel = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_ref
    try:
        want = model(toks)
    finally:
        attn_mod.flash_attention = kernel
    scale = float(want[..., :cfg.vocab].abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.gpu
def test_bf16_lm_prefill_launches_the_kernel_once_per_layer():
    """The reduced qwen2-1.5b in bfloat16 (the published dtype): its
    prefill runs every layer's attention through the tensor-core kernel,
    one launch per layer, and gives finite logits."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              dtype=torch.bfloat16)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 70), device="cuda")
    _build.reset_launch_counts()
    got = model(toks)
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, 70, cfg.vocab_padded)
    assert bool(torch.isfinite(got[..., :cfg.vocab]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["glm4-9b", "internvl2-26b",
                                  "musicgen-medium"])
def test_dense_vlm_audio_prefill_on_the_card_goes_through_the_kernel(arch):
    """Reduced glm4-9b (GQA, qkv bias), internvl2-26b and musicgen-medium
    (each with a seeded frontend embedding before its tokens) on the
    card: one kernel launch per layer, logits within 1e-4 of their scale
    of the same model's with the plain attention."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 70), generator=gen,
                         device="cuda")
    fe = None
    if cfg.frontend != "none":
        fe = torch.randn((2, cfg.frontend_len, cfg.d_model), generator=gen,
                         device="cuda")
    _build.reset_launch_counts()
    got = model(toks, fe)
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert got.shape == (2, 70 + cfg.frontend_len, cfg.vocab_padded)
    kernel = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_ref
    try:
        want = model(toks, fe)
    finally:
        attn_mod.flash_attention = kernel
    scale = float(want[..., :cfg.vocab].abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


FAMILY_LAUNCHES = {"granite-moe-3b-a800m": 2, "qwen2-moe-a2.7b": 2,
                   "mamba2-780m": 0, "zamba2-2.7b": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILY_LAUNCHES))
def test_family_on_the_card_matches_the_cpu(arch):
    """A reduced MoE, Mamba2 or Zamba2 model on the card against the same
    weights on the CPU: prefill logits within 1e-4 of their scale, with
    one flash_attention launch per attention layer (the hybrid's shared
    block once per group, Mamba2 none), and 12 ``decode_step`` calls
    within 1e-3 of it."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config(arch, reduced=True)
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = get_model(cfg)
    card.params = copy.deepcopy(cpu.params).to("cuda")
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    _build.reset_launch_counts()
    got = card(toks.cuda())
    assert _build.LAUNCH_COUNTS["flash_attention"] == FAMILY_LAUNCHES[arch]
    want = cpu(toks)
    scale = float(want[..., :cfg.vocab].abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * scale)
    caches = card.init_cache(2, 12), cpu.init_cache(2, 12)
    for t in range(12):
        lg, _ = card.decode_step(toks[:, t:t + 1].cuda(), caches[0], t)
        lc, _ = cpu.decode_step(toks[:, t:t + 1], caches[1], t)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-3 * scale)


def _within_caps(model, params) -> bool:
    for i, (layer, budget) in enumerate(zip(params["layers"],
                                            model.budgets())):
        v = layer["W"].double().cpu().numpy() / model.w_scales[i]
        cap_pos, cap_neg = budget.caps()
        if cap_neg >= 0:
            ok = (np.maximum(v, 0).sum(0) <= cap_pos + 1e-3).all() and \
                (np.maximum(-v, 0).sum(0) <= cap_neg + 1e-3).all()
        else:
            ok = (np.abs(v).sum(0) <= cap_pos + 1e-3).all()
        if not ok:
            return False
    return True


@pytest.mark.gpu
def test_qat_trains_on_the_card_within_its_caps():
    """Ten QAT steps on the card: every param and master on CUDA, every
    loss finite, params and masters inside each layer's caps."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    res = run_qat(QATConfig(budget=12, steps=10, hidden=(32, 32), seed=0),
                  device="cuda")
    state = res.state
    assert all(t.is_cuda for t in leaves((state.params, state.opt.master,
                                          state.opt.m, state.opt.v)))
    assert len(res.losses) == 10 and np.isfinite(res.losses).all()
    assert _within_caps(res.model, state.params)
    assert _within_caps(res.model, state.opt.master)


@pytest.mark.gpu
def test_qat_resume_on_the_card_is_bit_exact(tmp_path, monkeypatch):
    """Six steps straight equal three, a kill after the step-3
    checkpoint and a resume in fresh objects, under deterministic
    algorithms (a nondeterministic op raises instead of passing by
    luck)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    import shutil
    # cuBLAS refuses deterministic mode without a fixed workspace
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cfg = QATConfig(budget=12, steps=6, hidden=(32, 32), seed=1,
                        ckpt_dir=str(tmp_path / "a"), ckpt_every=3)
        straight = run_qat(cfg, device="cuda")
        (tmp_path / "b").mkdir()
        shutil.copy(tmp_path / "a" / "ckpt_00000003.npz", tmp_path / "b")
        resumed = run_qat(dataclasses.replace(cfg,
                                              ckpt_dir=str(tmp_path / "b")),
                          device="cuda")
    finally:
        torch.use_deterministic_algorithms(prev)
    assert resumed.resumed_from == 3
    for a, b in zip(leaves((straight.state.params, straight.state.opt)),
                    leaves((resumed.state.params, resumed.state.opt))):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.gpu
def test_exported_qat_model_on_the_card_is_bit_exact():
    """A QAT model trained on the card, exported and built, compiled for
    the card in float64: its integer tensors equal the numpy interpreter
    on a batch of its own inputs, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    res = run_qat(QATConfig(budget=12, steps=10, hidden=(32, 32), seed=0),
                  device="cuda")
    result, bits = proven_layer_bits(res.model, res.state.params)
    check_budget_invariant(res.model, res.state.params, bits)
    model = result.model
    compiled = model.compile(dtype=torch.float64)
    assert compiled.device.type == "cuda"
    compiled = model.compile(dtype=torch.float64,
                             extra_outputs=compiled.int_tensors)
    x = res.model.synth_batch(1000, 256)["tokens"].astype(np.float64)
    want = model.execute({"X": x}, record_all=True)
    _build.reset_launch_counts()
    got = compiled({"X": x})
    assert all(_build.LAUNCH_COUNTS[k] > 0
               for k in ("int_matmul", "multithreshold", "quantize"))
    for t in compiled.int_tensors:
        np.testing.assert_array_equal(got[t].astype(np.float64), want[t])


def _lm_grads(model, toks):
    flat, spec = flatten(model.param_tree())
    live = [t.detach().requires_grad_(True) for t in flat]
    loss = model.loss(unflatten(spec, live), toks[:, :-1], toks[:, 1:])
    return torch.autograd.grad(loss, live)


def _deterministic_grads(fn, inputs, monkeypatch):
    """The gradient of ``fn(*inputs)`` (a scalar) with respect to each
    input, twice on the card under deterministic algorithms (an op
    without a deterministic form raises instead of passing by luck),
    and once more on the CPU from the same inputs."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs = []
    try:
        for dev in ("cuda", "cuda", "cpu"):
            live = [t.detach().to(dev).requires_grad_(t.is_floating_point())
                    for t in inputs]
            wrt = [t for t in live if t.requires_grad]
            runs.append(torch.autograd.grad(fn(*live), wrt))
    finally:
        torch.use_deterministic_algorithms(prev)
    return runs


def _assert_card_grads(runs):
    """Two card runs bit-equal; each gradient within 1e-5 of its largest
    element of the CPU run's."""
    first, again, cpu = runs
    for a, b, c in zip(first, again, cpu):
        assert torch.equal(a, b)
        assert float((a.cpu() - c).abs().max()) <= 1e-5 * float(
            c.abs().max())


@pytest.mark.gpu
def test_ssd_chunked_backward_is_deterministic_on_the_card(monkeypatch):
    """``ssd_chunked``'s backward (the decay's running sum a product, no
    ``torch.cumsum``, which has no deterministic CUDA form) at three
    256-step chunks under deterministic algorithms: bit-equal over two
    calls, within 1e-5 of the CPU's.  dt is drawn from the range Mamba2's
    ``dt_bias`` starts it in, [1e-3, 0.1] (with softplus'd N(0, 1) steps
    and A up to 16, float32's gradients on the CPU alone lie up to 3.6e-5
    of their max from float64's: the decays' sums cancel)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(0)
    B, S, H, P, N = 2, 768, 4, 16, 16
    xh = _t(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dt = _t(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), size=(B, S, H)))
            .astype(np.float32))
    A = _t(np.exp(np.linspace(0.0, np.log(16.0), H)).astype(np.float32))
    Bm = _t(rng.normal(size=(B, S, 1, N)).astype(np.float32))
    Cm = _t(rng.normal(size=(B, S, 1, N)).astype(np.float32))
    w = _t(rng.normal(size=(B, S, H, P)).astype(np.float32))
    w_state = _t(rng.normal(size=(B, H, P, N)).astype(np.float32))

    def f(xh, dt, A, Bm, Cm, w, w_state):
        y, state = ssd_chunked(xh, dt, A, Bm, Cm, 256)
        return (y * w).sum() + (state * w_state).sum()
    _assert_card_grads(_deterministic_grads(
        f, [xh, dt, A, Bm, Cm, w, w_state], monkeypatch))


@pytest.mark.gpu
def test_mamba2_loss_backward_is_deterministic_on_the_card(monkeypatch):
    """The reduced mamba2's ``Model.loss`` gradient on the card under
    deterministic algorithms: bit-equal over two calls, each leaf within
    1e-5 of its largest element of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("mamba2-780m", reduced=True)
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    flat, spec = flatten(model.param_tree())
    toks = torch.randint(0, cfg.vocab, (2, 2 * cfg.ssm.chunk + 1),
                         generator=torch.Generator().manual_seed(1))

    def f(toks, *leaves_):
        return model.loss(unflatten(spec, list(leaves_)), toks[:, :-1],
                          toks[:, 1:])
    _assert_card_grads(_deterministic_grads(f, [toks] + flat, monkeypatch))


@pytest.mark.gpu
def test_apply_moe_backward_is_deterministic_on_the_card(monkeypatch):
    """``apply_moe`` at 8 experts x top-4, capacity 1.0 with a shared
    input direction so slots are dropped (asserted): its backward (the
    dispatch's gather and accumulating ``index_put``, the trash row) under
    deterministic algorithms bit-equal over two calls, within 1e-5 of the
    CPU's."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from repro_torch.models.moe import apply_moe, init_moe, route
    d, E, F_, k = 32, 8, 64, 4
    p = init_moe(torch.Generator().manual_seed(0), d, E, F_, 1,
                 torch.float32)
    flat, spec = flatten(p)
    rng = np.random.default_rng(1)
    x = _t((rng.normal(size=(2, 64, d)) + 2.0 * rng.normal(size=d))
           .astype(np.float32))
    r = route(p, x, top_k=k, capacity_factor=1.0)
    assert not bool(r.in_cap.all())

    def f(x, *leaves_):
        y, aux = apply_moe(unflatten(spec, list(leaves_)), x, top_k=k,
                           capacity_factor=1.0)
        return y.square().sum() + aux["router_z"]
    _assert_card_grads(_deterministic_grads(f, [x] + flat, monkeypatch))


@pytest.mark.gpu
def test_lm_loss_on_the_card_has_a_gradient_through_the_kernels():
    """The reduced qwen2 on the card: ``Model.loss``'s gradient comes from
    the kernels (one forward and one launch of each backward kernel per
    layer) and lies within 1e-4 of each leaf's largest element of the
    gradient through the plain attention."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 33), device="cuda")
    _build.reset_launch_counts()
    got = _lm_grads(model, toks)
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert all(_build.LAUNCH_COUNTS[n] == cfg.n_layers for n in BWD_KERNELS)
    kernel = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_ref
    try:
        want = _lm_grads(model, toks)
    finally:
        attn_mod.flash_attention = kernel
    for a, w in zip(got, want):
        assert bool(((a - w).abs() <= 1e-4 * w.abs().max()).all())


@pytest.mark.gpu
def test_fake_quant_lm_loss_on_the_card_through_the_kernels():
    """The reduced qwen2 on the card under ``QuantSpec(8)``: ``Model.loss``
    through the kernels (one forward and one launch of each backward
    kernel per layer) within 1e-5 relative of the loss through the plain
    attention, its gradient finite."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 33), device="cuda")
    quant = QuantSpec(bits=8)

    def loss_and_grads():
        flat, spec = flatten(model.param_tree())
        live = [t.detach().requires_grad_(True) for t in flat]
        loss = model.loss(unflatten(spec, live), toks[:, :-1], toks[:, 1:],
                          quant=quant)
        return float(loss), torch.autograd.grad(loss, live)
    _build.reset_launch_counts()
    got, grads = loss_and_grads()
    assert _build.LAUNCH_COUNTS["flash_attention"] == cfg.n_layers
    assert all(_build.LAUNCH_COUNTS[n] == cfg.n_layers for n in BWD_KERNELS)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    kernel = attn_mod.flash_attention
    attn_mod.flash_attention = flash_attention_ref
    try:
        want, _ = loss_and_grads()
    finally:
        attn_mod.flash_attention = kernel
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.gpu
def test_bf16_lm_loss_backward_takes_only_the_tensor_core_route():
    """The reduced qwen2 in bfloat16: every dK/dV and dQ launch of
    ``Model.loss``'s backward is on the ``tensor_cores`` route (one per
    layer), none on ``cuda_cores``, and the gradient is finite."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True),
                              dtype=torch.bfloat16)
    assert route_for(torch.bfloat16, cfg.hd) == TENSOR_CORES
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 65), device="cuda")
    _build.reset_launch_counts()
    got = _lm_grads(model, toks)
    for n in BWD_KERNELS[1:]:
        assert _build.LAUNCH_COUNTS[n] == cfg.n_layers
        assert _build.LAUNCH_COUNTS[f"{n}:{TENSOR_CORES}"] == cfg.n_layers
        assert _build.LAUNCH_COUNTS[f"{n}:{CUDA_CORES}"] == 0
    assert all(bool(torch.isfinite(a).all()) for a in got)


@pytest.mark.gpu
def test_bf16_gemma2_hd256_loss_backward_takes_only_the_tensor_core_route():
    """The reduced gemma2 with gemma2's own head dim (256) in bfloat16,
    its local layer's window cutting: every dK/dV and dQ launch of
    ``Model.loss``'s backward is on the ``tensor_cores`` route (the
    tiling for 128 < hd <= 256; one per layer), none on ``cuda_cores``,
    and the gradient is finite."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = dataclasses.replace(get_config("gemma2-2b", reduced=True),
                              head_dim=256, dtype=torch.bfloat16)
    assert cfg.hd == 256
    assert route_for(torch.bfloat16, cfg.hd) == TENSOR_CORES
    model = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 65), device="cuda")
    _build.reset_launch_counts()
    got = _lm_grads(model, toks)
    for n in BWD_KERNELS[1:]:
        assert _build.LAUNCH_COUNTS[n] == cfg.n_layers
        assert _build.LAUNCH_COUNTS[f"{n}:{TENSOR_CORES}"] == cfg.n_layers
        assert _build.LAUNCH_COUNTS[f"{n}:{CUDA_CORES}"] == 0
    assert all(bool(torch.isfinite(a).all()) for a in got)


@pytest.mark.gpu
def test_lm_train_step_with_remat_on_the_card():
    """``make_train_step``'s default ``remat=True`` recomputes each layer
    in the backward pass: two forward launches per layer, one of each
    backward kernel, and the loss of a step without remat."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from repro_torch.optim import AdamW
    from repro_torch.train import init_train_state, make_train_step
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=2)
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(1))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _build.reset_launch_counts()
    _, m_remat = make_train_step(model, opt)(state, batch)
    assert _build.LAUNCH_COUNTS["flash_attention"] == 2 * cfg.n_layers
    assert all(_build.LAUNCH_COUNTS[n] == cfg.n_layers for n in BWD_KERNELS)
    _, m_plain = make_train_step(model, opt, remat=False)(state, batch)
    assert float(m_remat["loss"]) == float(m_plain["loss"])
    assert abs(float(m_remat["grad_norm"]) - float(m_plain["grad_norm"])) \
        <= 1e-5 * float(m_plain["grad_norm"])


@pytest.mark.gpu
def test_train_main_on_the_card_resumes_bit_exact(tmp_path, monkeypatch,
                                                  capsys):
    """``launch.train.main`` on the card, reduced qwen2: six steps with a
    checkpoint every three; the last checkpoint deleted, the same command
    resumes at step 3 and saves a step-6 checkpoint equal to the first,
    under deterministic algorithms."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "6", "--batch",
            "4", "--seq", "32", "--ckpt-every", "3", "--ckpt-dir",
            str(tmp_path)]
    last = tmp_path / "ckpt_00000006.npz"
    try:
        _build.reset_launch_counts()
        assert launch_train.main(argv) == 0
        assert _build.LAUNCH_COUNTS["flash_attention_bwd_dq"] == 6 * 2
        with np.load(last) as x:
            first = {f: x[f] for f in x.files}
        last.unlink()
        capsys.readouterr()
        assert launch_train.main(argv) == 0
    finally:
        torch.use_deterministic_algorithms(prev)
    assert capsys.readouterr().out.startswith(
        f"resumed from {tmp_path / 'ckpt_00000003.npz'} at step 3")
    with np.load(last) as y:
        assert sorted(y.files) == sorted(first)
        assert all(np.array_equal(first[f], y[f]) for f in y.files)


def test_run_qat_without_a_card_raises():
    """``device=None`` means the card: on a machine without one,
    ``run_qat`` raises instead of training on the CPU.  (It needs no
    card, so it has no ``gpu`` marker; with a card it skips.)"""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_qat(QATConfig(steps=1))


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_paged_attention_on_the_card_matches_the_cpu(int8):
    """The serving attention (plain PyTorch, no kernel) on the card
    against the CPU: three slots (one idle on the trash page, one running
    past its table), T = 5, outputs of the live slots within 1e-5 of
    their scale; the pools' rows outside the trash page within 1e-6 of
    the pool's scale (fp) or at most one step apart (int8)."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("qwen2-1.5b", reduced=True)
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    attn = model.params["layers"][0]["attn"]
    rng = np.random.default_rng(0)
    shape = (10, 4, cfg.n_kv_heads, cfg.hd)
    if int8:
        kp = _t(rng.integers(-127, 128, size=shape).astype(np.int8))
        vp = _t(rng.integers(-127, 128, size=shape).astype(np.int8))
        scales = dict(k_scale=rng.uniform(0.02, 0.05, cfg.n_kv_heads),
                      v_scale=rng.uniform(0.02, 0.05, cfg.n_kv_heads))
    else:
        kp = _t(rng.normal(size=shape).astype(np.float32))
        vp = _t(rng.normal(size=shape).astype(np.float32))
        scales = {}
    table = torch.tensor([[1, 2, 3], [0, 0, 0], [4, 5, 6]],
                         dtype=torch.int32)
    lengths = torch.tensor([2, 0, 10])
    x = _t(rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32))
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              theta=cfg.rope_theta, page_size=4, **scales)
    card_attn = copy.deepcopy(attn).to("cuda")
    kc, vc = kp.cuda(), vp.cuda()
    y, _, _ = attn_mod.paged_attention(card_attn, x.cuda(), kc, vc,
                                       table.cuda(), lengths.cuda(), **kw)
    want, _, _ = attn_mod.paged_attention(attn, x, kp, vp, table, lengths,
                                          **kw)
    live = [0, 2]
    scale = float(want[live].abs().max())
    torch.testing.assert_close(y.cpu()[live], want[live], rtol=0,
                               atol=1e-5 * scale)
    for got, ref in ((kc, kp), (vc, vp)):
        got, ref = got.cpu()[1:], ref[1:]
        if int8:
            assert int((got.int() - ref.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-6 * float(ref.abs().max()))


def _equal_or_near_tie(cpu_model, prompt, got, want):
    """Two greedy streams of one prompt agree, or first differ where the
    CPU forward of their common prefix has its top two logits within
    1e-5 of the logit scale (float32 sums in another order may flip a
    near-tie; everything after it is not compared)."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if n is None:
        return got == want
    seq = torch.as_tensor(np.concatenate([prompt, want[:n]]))[None]
    with torch.inference_mode():
        logits = cpu_model(seq)[0, -1, :cpu_model.cfg.vocab]
    top = torch.topk(logits, 2)
    return set(top.indices.tolist()) == {got[n], want[n]} and \
        float(top.values[0] - top.values[1]) < \
        1e-5 * float(logits.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [
    dict(), dict(kv_cache="sira-int8"), dict(spec_decode="ngram"),
    dict(prefix_cache=True)], ids=["fp", "int8", "ngram", "prefix"])
def test_serving_engine_on_the_card_matches_the_cpu(variant):
    """The reduced qwen2-1.5b engine on the card against the same engine
    and weights on the CPU: greedy streams equal (a near-tie flip
    allowed), prefill chunks, decode steps and pools on their devices."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("qwen2-1.5b", reduced=True)
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = get_model(cfg)
    card.params = copy.deepcopy(cpu.params).to("cuda")
    rng = np.random.default_rng(3)
    pat = rng.integers(0, cfg.vocab, size=(4,))
    prompts = [np.concatenate([np.tile(pat, 3),
                               rng.integers(0, cfg.vocab, size=(n,))])
               for n in (2, 5, 9, 1)]
    sc = ServingConfig(batch_slots=2, max_seq=48, page_size=4,
                       prefill_chunk=8, **variant)
    outs = []
    for model in (card, cpu):
        eng = ServingEngine(model, sc)
        assert eng.cache.pages[0]["k"].device.type == model.device.type
        outs.append(eng.generate([Request(prompt=p, max_new_tokens=8,
                                          request_id=i)
                                  for i, p in enumerate(prompts)]))
        if variant.get("kv_cache"):
            assert eng.kv_spec.n_int8 == cfg.n_layers
    for p, got, want in zip(prompts, *outs):
        assert _equal_or_near_tie(cpu, p, got, want), (got, want)


@pytest.mark.gpu
def test_kv_spec_on_the_card_equals_the_cpu():
    """derive_kv_spec reads the weights from the card to the host: the
    same spec as from the CPU model, calibration included."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    cfg = get_config("qwen2-1.5b", reduced=True)
    cpu = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = get_model(cfg)
    card.params = copy.deepcopy(cpu.params).to("cuda")
    toks = [np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 16))]
    for kw in (dict(), dict(calib_token_batches=toks)):
        a, b = derive_kv_spec(card, **kw), derive_kv_spec(cpu, **kw)
        for la, lb in zip(a.layers, b.layers):
            assert la.int8 == lb.int8
            np.testing.assert_allclose(la.k_amax, lb.k_amax, rtol=1e-5)
            np.testing.assert_allclose(la.v_amax, lb.v_amax, rtol=1e-5)


@pytest.mark.gpu
def test_two_ranks_on_one_card_shard_the_forward(tmp_path):
    """Reduced qwen2 over two gloo ranks on ``cuda:0`` (one process each,
    ``launch/ranks.py``): the sharded forward within 1e-4 of the logit
    scale of the whole model on the same card, the same logits on both
    ranks, ``flash_attention`` launched once per layer by each rank, and
    the sharded engine's greedy streams equal the whole engine's."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from repro_torch.launch.ranks import run_ranks
    cfg = get_config("qwen2-1.5b", reduced=True)
    ranks = run_ranks(2, dict(
        layout=[1, 2], device="cuda", arch="qwen2-1.5b", reduced=True,
        seed=0, branch_gain=64.0, tol=1e-4, exact=False, variants=["fp"],
        tasks=["prefill", "serve"], pg_timeout=60.0), tmp_path,
        timeout_s=180)
    for res in ranks:
        assert res["backend"] == "gloo" and res["device"].startswith("cuda")
        pre = res["prefill"]
        assert pre["max_abs_err"] <= 1e-4 * pre["logit_scale"]
        assert pre["flash_launches"] == cfg.n_layers
        run = res["serve"]["fp"]
        assert 2 * run["pool_bytes"] == run["whole_pool_bytes"]
    assert ranks[0]["prefill"]["digest"] == ranks[1]["prefill"]["digest"]
    assert ranks[0]["serve"]["fp"]["streams"] == \
        ranks[1]["serve"]["fp"]["streams"]


@pytest.mark.gpu
def test_two_ranks_on_one_card_train_split(tmp_path):
    """Reduced qwen2 trained over two gloo ranks on ``cuda:0``: float32
    under (1, 2) and (2, 1) with ZeRO, against the whole model's step
    computed in each rank (losses 1e-5, gradient 1e-4 of each leaf's max,
    masters 1e-5 of the largest); bf16 under (1, 2) with every rank's
    backward on the ``tensor_cores`` route, once per layer and
    microbatch."""
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    from repro_torch.launch.ranks import run_ranks
    cfg = get_config("qwen2-1.5b", reduced=True)
    base = dict(arch="qwen2-1.5b", reduced=True, seed=0, batch=[4, 64])
    ranks = run_ranks(2, dict(
        layout=[1, 2], device="cuda", pg_timeout=60.0,
        tasks=["train", "train_timed"],
        train=dict(base, dtype="float32", steps=2, microbatches=[1, 2],
                   layouts=[[1, 2], [2, 1]], tol_loss=1e-5, tol_grad=1e-4,
                   tol_master=1e-5),
        train_timed=dict(base, dtype="bfloat16", steps=2, microbatches=[2],
                         layouts=[[1, 2]], oracle=False)), tmp_path,
        timeout_s=300)
    for res in ranks:
        for case in ("1x2_mb1", "1x2_mb2", "2x1_mb1", "2x1_mb2"):
            cmp, = res["train"][case]["vs"]
            assert cmp["loss_rel_err"] <= 1e-5 and cmp["grad_err"] <= 1e-4
        launches = res["train_timed"]["1x2_mb2"]["launches"]
        for k in ("dkdv", "dq"):
            assert launches[f"flash_attention_bwd_{k}:tensor_cores"] == \
                2 * cfg.n_layers
            assert f"flash_attention_bwd_{k}:cuda_cores" not in launches
    assert ranks[0]["train"]["2x1_mb2"]["digest"] == \
        ranks[1]["train"]["2x1_mb2"]["digest"]
