"""The two ``multithreshold`` routes of the port, held to the JAX package
on the CPU, and the 8-bit-activation CNV whose tails take the search.

The CUDA kernels cannot run without a card, so their algorithms are
transcribed here in plain PyTorch, step for step as
``csrc/multithreshold.cu`` computes them, and held against the JAX
package's ``repro.kernels.ref.multithreshold_ref`` (a linear count) on an
edge grid: N = 0..255 around the powers of two, INT32_MIN/MAX, +-inf, NaN
in x, runs of equal thresholds and exact ties.

- the search route pads each column's thresholds to 2^k - 1 with the
  type's largest value, runs k branch-free steps
  (``pos += h if x >= slab[pos + h - 1]``) and clamps the count to N;
- the compare-count route with thresholds in registers pads them to 3, 7
  or 15 with the same value and clamps the count to N.

Every comparison is exact (integer counts).  ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold the kernels themselves against the plain
version on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.workloads import make_cnv as j_make_cnv
from repro.kernels import ref as jref
from repro_torch.core import build_flow
from repro_torch.core.workloads import make_cnv
from repro_torch.kernels import ops as tops
from repro_torch.kernels.multithreshold import (
    COMPARE_COUNT, ROUTES, SEARCH, SEARCH_FROM_N, multithreshold,
    route_for, slab_bytes)
from test_torch_analysis import _name_map

DTYPES = {"int32": np.int32, "float32": np.float32, "float64": np.float64}
EDGE_N = (0, 1, 2, 3, 4, 7, 8, 15, 16, 17, 31, 32, 63, 64, 127, 128, 255)


def _top(dtype: torch.dtype):
    return torch.iinfo(dtype).max if dtype == torch.int32 else float("inf")


def search_count(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The search route: #{i : x >= T[i, c]} by a branch-free binary
    search over T padded to 2^k - 1 rows, the count clamped to N."""
    n, c = t.shape
    k = n.bit_length()                       # 2^k - 1 >= N, least k
    slab = torch.full(((1 << k) - 1, c), _top(t.dtype), dtype=t.dtype)
    slab[:n] = t
    pos = torch.zeros(x.shape, dtype=torch.int64)
    for b in reversed(range(k)):
        h = 1 << b
        if slab.shape[0]:
            probe = torch.gather(slab, 0, pos + h - 1)
            pos = pos + torch.where(x >= probe, h, 0)
    return pos.clamp(max=n)


def register_count(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The compare-count route with thresholds in registers: T padded to
    3, 7 or 15 rows, a linear count clamped to N."""
    n, c = t.shape
    assert n <= 15
    rows = 3 if n <= 3 else 7 if n <= 7 else 15
    pad = torch.full((rows, c), _top(t.dtype), dtype=t.dtype)
    pad[:n] = t
    cnt = sum((x >= pad[i]).to(torch.int64) for i in range(rows))
    return cnt.clamp(max=n)


def edge_case(rng, m, c, n, dt):
    """x (m, c), thresholds (n, c) ascending per column, with the edge
    values of both routes."""
    if dt == np.int32:
        info = np.iinfo(np.int32)
        pool = np.array([info.min, info.min + 1, info.max - 1, info.max, 0,
                         -1, 1], np.int64)
        t = rng.integers(-300, 300, (n, c))
        x = rng.integers(-350, 350, (m, c))
        xpool = pool
    else:
        pool = np.array([np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30])
        t = rng.integers(-1200, 1200, (n, c)) / 4
        x = rng.integers(-1400, 1400, (m, c)) / 4
        xpool = np.append(pool, np.nan)
    t = np.where(rng.random((n, c)) < 0.15, rng.choice(pool, (n, c)), t)
    x = np.where(rng.random((m, c)) < 0.15, rng.choice(xpool, (m, c)), x)
    if n > 4:
        t[:3] = t[3]                      # a run of equal thresholds
    t = np.sort(t.astype(dt), axis=0)
    x = x.astype(dt)
    if n and m > 3:
        x[1] = t[n // 2]                  # exact ties
        x[2] = t[-1]
        x[3] = t[0]
    return x, t


def _jax_count(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    with jax.enable_x64(True):
        return np.asarray(jref.multithreshold_ref(
            jnp.asarray(x), jnp.asarray(t), out_dtype=jnp.int32))


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_search_transcription_matches_reference(dtype, n):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(n * 7 + len(dtype))
    x, t = edge_case(rng, 41, 6, n, dt)
    want = _jax_count(x, t)
    got = search_count(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's plain version (what the wrappers run on the CPU) agrees
    np.testing.assert_array_equal(
        multithreshold(torch.from_numpy(x), torch.from_numpy(t),
                       out_dtype=torch.int32).numpy(), want)


@pytest.mark.parametrize("n", [n for n in EDGE_N if n <= 15])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_register_count_transcription_matches_reference(dtype, n):
    dt = DTYPES[dtype]
    rng = np.random.default_rng(n * 11 + len(dtype))
    x, t = edge_case(rng, 41, 6, n, dt)
    got = register_count(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), _jax_count(x, t))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_padding_is_not_counted_at_the_top_value(dtype):
    """x equal to the padding value (INT32_MAX, +inf) counts every real
    threshold and no padding; NaN counts nothing."""
    dt = DTYPES[dtype]
    top = np.iinfo(np.int32).max if dt == np.int32 else np.inf
    t = np.sort(np.array([[-5], [0], [3], [9], [top]], dt), axis=0)
    x = np.array([[top], [9], [-6]] + ([] if dt == np.int32
                                       else [[np.nan]]), dt)
    want = _jax_count(x, t)
    assert want[0, 0] == 5 and want[-1, 0] == 0
    for fn in (search_count, register_count):
        got = fn(torch.from_numpy(x), torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,c,n,dtype,route", [
    (262144, 64, 3, torch.int32, COMPARE_COUNT),     # CNV(64,32) tails
    (65536, 16, 7, torch.int32, COMPARE_COUNT),      # RN8
    (16384, 8, 15, torch.int32, COMPARE_COUNT),      # MobileNet
    (256, 64, SEARCH_FROM_N - 1, torch.float32, COMPARE_COUNT),
    (256, 64, SEARCH_FROM_N, torch.float32, SEARCH),
    (65536, 16, 255, torch.int32, SEARCH),           # CNV-w2a8 tails
    (256, 32, 255, torch.float32, SEARCH),
    (4096, 64, 255, torch.float64, SEARCH),
    (100, 8, 511, torch.float64, SEARCH),            # 128 KB slab fits
    (100, 8, 1023, torch.int32, SEARCH),
    (100, 8, 1024, torch.int32, COMPARE_COUNT),      # 256 KB does not
    (100, 8, 1023, torch.float64, COMPARE_COUNT),
])
def test_route_for_at_the_crossover(m, c, n, dtype, route):
    assert route_for(m, c, n, dtype) == route
    assert (slab_bytes(n, dtype) <= 227 * 1024) == (
        n < SEARCH_FROM_N or route == SEARCH)


def test_route_keyword_is_checked():
    x = torch.zeros((4, 8), dtype=torch.int32)
    t = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="route"):
        tops.multithreshold(x, t, route="linear")
    with pytest.raises(ValueError, match="slab"):
        tops.multithreshold(x, torch.zeros((1024, 8), dtype=torch.int32),
                            route=SEARCH)
    for r in ROUTES:      # on the CPU every route is the plain version
        np.testing.assert_array_equal(
            tops.multithreshold(x, t, route=r).numpy(),
            np.full((4, 8), 3, np.int8))


@functools.lru_cache(maxsize=None)
def _cnv_w2a8():
    return (build_flow(make_cnv(wbits=2, abits=8)).model,
            jcore.build_flow(j_make_cnv(wbits=2, abits=8)).model)


def _feeds(model, batch, seed=0):
    shape = (batch,) + tuple(model.metadata["input_shape"][1:])
    (inp,) = model.graph.inputs
    r = model.input_ranges[inp]
    lo = np.broadcast_to(np.asarray(r.lo, np.float64), shape)
    hi = np.broadcast_to(np.asarray(r.hi, np.float64), shape)
    return {inp: np.random.default_rng(seed).uniform(lo, hi, size=shape)}


def test_cnv_w2a8_is_bit_exact_against_the_reference_interpreter():
    """CNV-w2a8 (8-bit unsigned activations) compiled by the port on the
    CPU in float64: every integer tensor equals the JAX package's
    ``Graph.execute`` of its own ``build_flow`` of the same workload.
    Tensors are paired by topological position (``_name_map``): each
    package draws generated names from its own process-global counter,
    which the tests run before this one in the same process move apart
    (reference fault 5)."""
    model, ref_model = _cnv_w2a8()
    compiled = model.compile(dtype=torch.float64, device="cpu")
    compiled = model.compile(dtype=torch.float64, device="cpu",
                             extra_outputs=compiled.int_tensors)
    assert compiled.kernel_calls["multithreshold"] == 7
    tmap, _ = _name_map(ref_model.graph.copy(), model.graph.copy())
    ref_name = {t: r for r, t in tmap.items()}
    feeds = _feeds(model, 2)
    want = ref_model.execute(feeds, record_all=True)
    got = compiled(feeds)
    assert compiled.int_tensors
    for t in compiled.int_tensors:
        np.testing.assert_array_equal(got[t].astype(np.float64),
                                      want[ref_name[t]],
                                      err_msg=f"integer tensor {t}")
    for o in model.graph.outputs:
        np.testing.assert_allclose(got[o], want[ref_name[o]], rtol=1e-12,
                                   atol=1e-12)


def test_cnv_w2a8_tails_take_the_search_route_at_batch_256():
    """The seven tails of CNV-w2a8 have N = 255; at the main path's batch
    every one of them goes to the search route."""
    model, _ = _cnv_w2a8()
    calls = []
    kernel = tops.multithreshold

    def recorder(x, t, **kw):
        calls.append((x.shape[0], x.shape[1], t.shape[0], x.dtype))
        return kernel(x, t, **kw)
    tops.multithreshold = recorder
    try:
        model.compile(device="cpu")(_feeds(model, 256))
    finally:
        tops.multithreshold = kernel
    assert sorted(set((m, c, n) for m, c, n, _ in calls)) == [
        (256, 32, 255), (4096, 64, 255), (16384, 32, 255),
        (65536, 16, 255)]
    assert len(calls) == 7
    assert all(route_for(*call) == SEARCH for call in calls)
