"""The port's ``int_matmul`` on the CPU: the route function on every
main-path shape, the K-major weight layout the tensor-core kernel reads
(``k_major``) against the JAX package's oracle and its Pallas kernel in
interpret mode, and the lowered models with K-major weights against the
numpy interpreter.

Tolerances: integers exactly; the float32 dequant epilogue at
``rtol=1e-6`` plus ``atol=1e-6·max|want|`` against JAX (XLA may contract
its multiply-add into one FMA, the port rounds twice) and exactly against
the port's own plain version on a row-major weight.

The two CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``python3 chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.core import build_flow
from repro_torch.core.workloads import WORKLOADS, make_cnv, make_tfc
from repro_torch.kernels import ops as tops
from repro_torch.kernels.int_matmul import (CUDA_CORES, ROUTES, TENSOR_CORES,
                                            int_matmul as t_int_matmul,
                                            is_k_major, k_major, route_for)

B = 256   # the batch every main-path M below is given at

# Every distinct int_matmul call of the six chip_smoke configurations at
# batch 256, (M, K, N), and the route it takes: int8 operands throughout.
MAIN_PATH = {
    "TFC-w2a2": [((B, 49, 64), TENSOR_CORES), ((B, 64, 64), TENSOR_CORES),
                 ((B, 64, 10), TENSOR_CORES)],
    "TFC(784)": [((B, 784, 64), TENSOR_CORES)],
    "CNV-w2a2": [((256 * B, 27, 16), TENSOR_CORES),
                 ((256 * B, 144, 16), TENSOR_CORES),
                 ((64 * B, 144, 32), TENSOR_CORES),
                 ((64 * B, 288, 32), TENSOR_CORES),
                 ((16 * B, 288, 64), TENSOR_CORES),
                 ((16 * B, 576, 64), TENSOR_CORES),
                 ((B, 32, 10), TENSOR_CORES)],
    "RN8-w3a3": [((64 * B, 16, 32), CUDA_CORES),
                 ((16 * B, 32, 64), CUDA_CORES)],
    "MNv1-w4a4": [((64 * B, 27, 8), TENSOR_CORES),
                  ((64 * B, 9, 1), TENSOR_CORES),
                  ((64 * B, 8, 8), TENSOR_CORES),
                  ((64 * B, 8, 16), CUDA_CORES),
                  ((64 * B, 16, 16), CUDA_CORES),
                  ((64 * B, 16, 32), CUDA_CORES)],
    "CNV(64,32)": [((1024 * B, 27, 64), TENSOR_CORES),
                   ((1024 * B, 576, 64), TENSOR_CORES),
                   ((256 * B, 576, 128), TENSOR_CORES),
                   ((256 * B, 1152, 128), TENSOR_CORES),
                   ((64 * B, 1152, 256), TENSOR_CORES),
                   ((64 * B, 2304, 256), TENSOR_CORES),
                   ((B, 128, 10), TENSOR_CORES)],
}
SHAPES = [(cfg, mkn, route) for cfg, calls in MAIN_PATH.items()
          for mkn, route in calls]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "cfg,mkn,route", SHAPES,
    ids=[f"{c}-{m}x{k}x{n}" for c, (m, k, n), _ in SHAPES])
def test_route_for_main_path_shape(cfg, mkn, route):
    """The route of each main-path call (int8 operands); a pure function
    of the shape and the operand type."""
    m, k, n = mkn
    assert route_for(m, k, n, torch.int8) == route
    assert route_for(m, k, n, torch.int8) == route


@pytest.mark.parametrize("m,k,n", [(256, 784, 64), (16384, 2304, 256),
                                   (16384, 9, 1), (1, 0, 4)])
def test_int32_operands_and_empty_k_take_the_cuda_cores(m, k, n):
    assert route_for(m, k, n, torch.int32) == CUDA_CORES
    assert route_for(m, 0, n, torch.int8) == CUDA_CORES


@pytest.mark.parametrize("m,k,n,route", [
    (8192, 32, 64, CUDA_CORES),          # M * N = 2^19: still small
    (8193, 32, 64, TENSOR_CORES),        # one row more
    (16384, 33, 32, TENSOR_CORES),       # deeper than one MMA step
    (16384, 32, 15, TENSOR_CORES),       # fewer than 16 columns
    (1, 1, 1, TENSOR_CORES)])
def test_route_for_edges_of_the_cuda_core_region(m, k, n, route):
    assert route_for(m, k, n, torch.int8) == route


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("k,n", [(1, 1), (9, 1), (27, 10), (64, 16),
                                 (49, 257)])
def test_k_major_is_a_padded_view_of_the_same_values(k, n, dtype):
    """``k_major(w)`` is (K, N) with the same values, unit stride along K,
    a 16-byte row pitch and zeros past K in its storage; it returns a view
    that already has that layout unchanged."""
    rng = np.random.default_rng(k * n)
    w = _t(rng.integers(-128, 128, (k, n))).to(dtype)
    km = k_major(w)
    assert km.shape == w.shape and km.dtype == dtype
    assert torch.equal(km, w)
    assert is_k_major(km) and (k <= 1 or km.stride(0) == 1)
    assert (km.stride(1) * km.element_size()) % 16 == 0
    assert km.stride(1) >= k
    assert k_major(km) is km
    storage = km.T.as_strided((n, km.stride(1)), (km.stride(1), 1))
    assert not storage[:, k:].any()


FORMS = {
    "wide": dict(),
    "narrow int16": dict(acc_bits=12),
    "narrow to int32": dict(acc_bits=13, out_dtype="int32"),
    "dequant with bias": dict(scale=True, bias=True),
    "dequant no bias narrow": dict(scale=True, acc_bits=12),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("m,k,n", [(65, 27, 10), (129, 144, 64),
                                   (7, 49, 1), (64, 64, 257)])
def test_k_major_weight_matches_jax_reference_and_pallas(m, k, n, form):
    """The wrapper given ``w`` as a K-major (N, K).T view on the CPU equals
    ``repro.kernels.ref.int_matmul_ref`` and the Pallas ``int_matmul`` in
    interpret mode, and the port's plain version on the row-major weight;
    narrow forms overflow int16 so the wrap is exercised."""
    rng = np.random.default_rng(m + 7 * k + 13 * n)
    kw = dict(FORMS[form])
    # narrow forms: non-negative operands, so every sum overflows int16
    lo = 0 if "narrow" in form else -128
    x = rng.integers(lo, 128, (m, k)).astype(np.int8)
    w = rng.integers(lo, 128, (k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    jkw = dict(acc_bits=kw.get("acc_bits", 32))
    tkw = dict(jkw)
    if kw.get("out_dtype") == "int32":
        jkw["out_dtype"], tkw["out_dtype"] = jnp.int32, torch.int32
    jargs, targs = [], []
    if kw.get("scale"):
        jargs.append(jnp.asarray(s))
        targs.append(_t(s))
        if kw.get("bias"):
            jargs.append(jnp.asarray(b))
            targs.append(_t(b))
    wk = k_major(_t(w))
    assert is_k_major(wk)
    got = t_int_matmul(_t(x), wk, *targs, **tkw)
    plain = t_int_matmul(_t(x), _t(w), *targs, **tkw)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    want = np.asarray(jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                          *jargs, **jkw))
    pal = np.asarray(jops.int_matmul(jnp.asarray(x), jnp.asarray(w), *jargs,
                                     use_pallas=True, interpret=True,
                                     **jkw))
    for ref in (want, pal):
        assert got.numpy().dtype == ref.dtype
        if kw.get("scale"):
            np.testing.assert_allclose(
                got.numpy(), ref, rtol=1e-6,
                atol=1e-6 * float(np.abs(ref).max()))
        else:
            np.testing.assert_array_equal(got.numpy(), ref)
    if "narrow" in form:
        assert int(np.abs(x.astype(np.int64) @ w.astype(np.int64)).max()) \
            > 2 ** 15


def test_route_keyword_is_for_the_card_and_checked():
    x = torch.ones((4, 16), dtype=torch.int8)
    w = torch.ones((16, 8), dtype=torch.int8)
    for route in ROUTES:
        with pytest.raises(RuntimeError, match="CUDA device"):
            t_int_matmul(x, w, route=route)
    with pytest.raises(ValueError, match="not one of"):
        t_int_matmul(x, w, route="mma")
    # the public wrapper runs the plain version on the CPU as before
    assert torch.equal(tops.int_matmul(x, w), torch.full((4, 8), 16,
                                                         dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _optimized(name):
    factory = {"CNV(ch=64,img=32)": functools.partial(make_cnv, ch=64,
                                                      img=32),
               "TFC(in_dim=784)": functools.partial(make_tfc, in_dim=784),
               **WORKLOADS}[name]
    return build_flow(factory()).model


@pytest.mark.parametrize("name", list(WORKLOADS) + ["CNV(ch=64,img=32)",
                                                    "TFC(in_dim=784)"])
def test_lowered_model_passes_k_major_int8_weights_and_stays_exact(
        name, monkeypatch):
    """Every int8 weight the lowering hands to ``int_matmul`` is a K-major
    view (stored once, no copy per call); the integer tensors stay
    bit-exact against ``Graph.execute`` and the outputs within 1e-12 in
    float64 mode."""
    model = _optimized(name)
    seen = []
    kernel = tops.int_matmul

    def recorder(x, w, *a, **kw):
        if w.dtype == torch.int8:
            seen.append((is_k_major(w), w.data_ptr()))
        return kernel(x, w, *a, **kw)
    monkeypatch.setattr(tops, "int_matmul", recorder)
    compiled = model.compile(dtype=torch.float64, device="cpu")
    compiled = model.compile(dtype=torch.float64, device="cpu",
                             extra_outputs=compiled.int_tensors)
    feeds = next(iter(model.sample_inputs(rng=np.random.default_rng(0))))
    want = model.execute(feeds, record_all=True)
    got = compiled(feeds)
    first = list(seen)
    compiled(feeds)
    assert seen and all(k for k, _ in seen)
    # the second call reads the very same weight storage
    assert [p for _, p in seen[len(first):]] == [p for _, p in first]
    for t in compiled.int_tensors:
        np.testing.assert_array_equal(got[t].astype(np.float64), want[t])
    for o in model.graph.outputs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-12, atol=1e-12)
