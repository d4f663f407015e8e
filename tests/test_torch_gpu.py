"""Tests that need a CUDA device: each hand-written kernel against its
plain PyTorch version, and one compiled model against the numpy
interpreter, on the card.  They skip elsewhere (decided inside each test,
never at import).  This file imports neither ``jax`` nor ``repro``, so it
runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py -q

``python3 chip_smoke.py`` makes the same comparisons at the main path's
real shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_flow
from repro_torch.core.workloads import WORKLOADS
from repro_torch.kernels import _build, ops as kops

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
