"""Tests that need a CUDA device: each hand-written kernel against its
plain PyTorch version, one compiled model against the numpy interpreter,
and a reduced LM prefill through the flash-attention kernel, on the card.
They skip elsewhere (decided inside each test, never at import).  This file imports neither ``jax`` nor ``repro``, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -q

``python3 chip_smoke.py`` makes the same comparisons at the main path's
real shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import build_flow
from repro_torch.core.workloads import WORKLOADS
from repro_torch.kernels import _build, ops as kops
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 tolerance)
from repro_torch.kernels.int_matmul import ROUTES, TENSOR_CORES, k_major
from repro_torch.kernels.multithreshold import ROUTES as MT_ROUTES
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import attention as attn_mod, get_model

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


# (B, Sq, Sk, H, KV, hd, keywords): one case per feature, each run in
# float32 (the CUDA-core kernel) and in bfloat16 and float16 (the
# tensor-core kernel); hd 16/64/128/256 and lengths that no tile divides
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
def test_flash_attention_kernel_refuses_gradients():
    if not torch.cuda.is_available():
        pytest.skip(NEEDS_CARD)
    q = torch.zeros(1, 8, 2, 16, device="cuda", requires_grad=True)
    k = torch.zeros(1, 8, 1, 16, device="cuda")
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, k, k)


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
