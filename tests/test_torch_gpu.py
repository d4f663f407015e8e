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
