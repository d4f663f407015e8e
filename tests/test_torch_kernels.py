"""Port parity for the three kernels: the plain PyTorch versions of
``repro_torch.kernels`` (what the wrappers run for CPU tensors) against the
JAX package's ``repro.kernels.ref`` oracles **and** against its Pallas
kernels run in interpret mode, on the same numpy inputs.

Tolerances: every integer result is compared exactly; the float32 dequant
epilogue at ``rtol=1e-6`` plus ``atol=1e-6·max|want|`` (XLA may contract
its multiply-add into one FMA, the port rounds twice).

The CUDA kernels themselves cannot run without a card:
``tests/test_torch_gpu.py`` and ``python3 chip_smoke.py`` hold each against
its plain version there.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels.multithreshold import infer_out_dtype as j_infer_out_dtype
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.kernels.int_matmul import int_matmul as t_int_matmul
from repro_torch.kernels.multithreshold import (
    infer_out_dtype as t_infer_out_dtype, multithreshold as t_multithreshold)
from repro_torch.kernels.quantize import quantize as t_quantize

_TORCH_OF = {jnp.int8: torch.int8, jnp.int16: torch.int16,
             jnp.int32: torch.int32}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# int_matmul
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (1, 49, 10), (7, 3, 5),
                                   (130, 200, 10), (8, 64, 100)])
def test_int_matmul_matches_reference(m, k, n, dtype):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-128, 128, size=(m, k)).astype(dtype)
    w = rng.integers(-8, 8, size=(k, n)).astype(dtype)
    got = tops.int_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32
    _same(got, jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    _same(got, jops.int_matmul(jnp.asarray(x), jnp.asarray(w),
                               use_pallas=True, interpret=True))
    # the kernel module's wrapper takes the plain version for CPU tensors
    _same(t_int_matmul(_t(x), _t(w)), got.numpy())


@pytest.mark.parametrize("acc_bits,amp,out", [
    (12, 3, torch.int16),      # |acc| <= 128*3*3 < 2^14: lossless
    (12, 100, torch.int16),    # |acc| reaches ~1e6: the int16 wrap must match
    (20, 100, torch.int32),
])
def test_int_matmul_accumulator_width(acc_bits, amp, out):
    rng = np.random.default_rng(acc_bits + amp)
    x = rng.integers(-amp, amp + 1, size=(128, 128)).astype(np.int8)
    w = rng.integers(-amp, amp + 1, size=(128, 128)).astype(np.int8)
    full = x.astype(np.int64) @ w.astype(np.int64)
    if amp == 100 and acc_bits <= 15:
        assert np.abs(full).max() > 2 ** 15, "case must overflow int16"
    got = tops.int_matmul(_t(x), _t(w), acc_bits=acc_bits)
    assert got.dtype == out
    _same(got, jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                   acc_bits=acc_bits))
    _same(got, jops.int_matmul(jnp.asarray(x), jnp.asarray(w),
                               acc_bits=acc_bits, use_pallas=True,
                               interpret=True))
    # wrap once at the end == what the lowering asks: int32 out, narrow acc
    got32 = tops.int_matmul(_t(x), _t(w), acc_bits=acc_bits,
                            out_dtype=torch.int32)
    _same(got32, jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                     acc_bits=acc_bits,
                                     out_dtype=jnp.int32))


def test_int_matmul_int32_products_wrap():
    """int32 operands whose products exceed 32 bits wrap modulo 2^32 in both
    packages."""
    rng = np.random.default_rng(11)
    x = rng.integers(-2 ** 20, 2 ** 20, size=(9, 33)).astype(np.int32)
    w = rng.integers(-2 ** 20, 2 ** 20, size=(33, 6)).astype(np.int32)
    want = (x.astype(np.int64) @ w.astype(np.int64)).astype(np.int32)
    got = tops.int_matmul(_t(x), _t(w))
    np.testing.assert_array_equal(got.numpy(), want)
    _same(got, jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("m,k,n", [(6, 49, 10), (128, 128, 128)])
def test_int_matmul_fused_dequant(m, k, n, with_bias):
    rng = np.random.default_rng(m + n)
    x = rng.integers(-8, 8, size=(m, k)).astype(np.int8)
    w = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    got = tops.int_matmul(_t(x), _t(w), _t(s),
                          None if b is None else _t(b))
    assert got.dtype == torch.float32
    jb = None if b is None else jnp.asarray(b)
    want = jref.int_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(s), jb)
    # atol: where acc*scale and the bias cancel, one rounding (FMA) and two
    # differ by an ulp of the *operands*, not of the small result
    atol = 1e-6 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=atol)
    pal = jops.int_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                          jb, use_pallas=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), rtol=1e-6,
                               atol=atol)


def test_int_matmul_scalar_scale_broadcasts_to_all_columns():
    x = torch.ones((4, 8), dtype=torch.int8)
    w = torch.ones((8, 10), dtype=torch.int8)
    s = torch.tensor([0.5], dtype=torch.float32)
    got = tops.int_matmul(x, w, s)
    np.testing.assert_array_equal(got.numpy(),
                                  np.full((4, 10), 4.0, np.float32))
    want = jops.int_matmul(jnp.ones((4, 8), jnp.int8),
                           jnp.ones((8, 10), jnp.int8),
                           jnp.asarray([0.5], jnp.float32),
                           use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# multithreshold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,c,n_thr", [(5, 3, 3), (1, 10, 15), (33, 130, 7),
                                       (256, 128, 255)])
def test_multithreshold_int_matches_reference(m, c, n_thr):
    rng = np.random.default_rng(m + c + n_thr)
    x = rng.integers(-500, 500, size=(m, c)).astype(np.int32)
    thr = np.sort(rng.integers(-400, 400, size=(n_thr, c)), axis=0
                  ).astype(np.int32)
    got = tops.multithreshold(_t(x), _t(thr), out_bias=-1,
                              out_dtype=torch.int32)
    _same(got, jref.multithreshold_ref(jnp.asarray(x), jnp.asarray(thr),
                                       out_bias=-1, out_dtype=jnp.int32))
    _same(got, jops.multithreshold(jnp.asarray(x), jnp.asarray(thr),
                                   out_bias=-1, out_dtype=jnp.int32,
                                   use_pallas=True, interpret=True))
    _same(t_multithreshold(_t(x), _t(thr), out_bias=-1,
                           out_dtype=torch.int32), got.numpy())
    _same(tref.multithreshold_searchsorted_ref(
        _t(x), _t(thr), out_bias=-1, out_dtype=torch.int32), got.numpy())
    # default dtype: derived from the output range, as in the reference
    dflt = tops.multithreshold(_t(x), _t(thr), out_bias=-1)
    _same(dflt, jref.multithreshold_ref(jnp.asarray(x), jnp.asarray(thr),
                                        out_bias=-1))


@pytest.mark.parametrize("ftype", [np.float32, np.float64])
@pytest.mark.parametrize("m,c,n_thr", [(5, 3, 3), (33, 130, 7),
                                       (64, 16, 255)])
def test_multithreshold_float_compare(m, c, n_thr, ftype):
    """Scaled-entry tails compare in float; quarter-grid values make exact
    ties likely, one row is all ties, and ties count (``>=``)."""
    rng = np.random.default_rng(m * c + n_thr)
    x = (rng.integers(-2000, 2000, size=(m, c)) / 4).astype(ftype)
    thr = np.sort(rng.integers(-1600, 1600, size=(n_thr, c)) / 4, axis=0
                  ).astype(ftype)
    x[0] = thr[n_thr // 2]        # a row of exact ties
    got = tops.multithreshold(_t(x), _t(thr), out_dtype=torch.int32)
    with jax.enable_x64(True):
        _same(got, jref.multithreshold_ref(
            jnp.asarray(x), jnp.asarray(thr), out_dtype=jnp.int32))
        _same(got, jops.multithreshold(
            jnp.asarray(x), jnp.asarray(thr), out_dtype=jnp.int32,
            use_pallas=True, interpret=True))


def test_infer_out_dtype_matches_reference():
    for n, b in [(3, -2), (255, -128), (255, 0), (2 ** 16, 0), (127, 0),
                 (128, 0), (2 ** 15 - 1, 0), (2 ** 15, 0), (1, -129)]:
        assert t_infer_out_dtype(n, b) == _TORCH_OF[j_infer_out_dtype(n, b)]


def test_multithreshold_default_dtype_no_overflow():
    """8-bit unsigned tail: count reaches 255 and must not wrap negative
    under the default output dtype."""
    x = torch.full((8, 4), 10_000, dtype=torch.int32)
    thr = _t(np.tile(np.arange(255, dtype=np.int32)[:, None], (1, 4)))
    for out in (tops.multithreshold(x, thr), tref.multithreshold_ref(x, thr),
                tref.multithreshold_searchsorted_ref(x, thr)):
        assert out.dtype == torch.int16
        assert int(out.min()) >= 0, "8-bit unsigned tail wrapped negative"
        assert int(out.max()) == 255


# --------------------------------------------------------------------------
# quantize
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qmin,qmax,odt", [(-128, 127, jnp.int8),
                                           (-8, 7, jnp.int8),
                                           (0, 15, jnp.int8),
                                           (0, 255, jnp.int32)])
@pytest.mark.parametrize("m,c", [(1, 1), (3, 10), (257, 5), (256, 128)])
def test_quantize_matches_reference(m, c, qmin, qmax, odt):
    rng = np.random.default_rng(m + c + qmax)
    x = rng.normal(size=(m, c)).astype(np.float32) * 3
    s = rng.uniform(0.01, 0.3, size=(c,)).astype(np.float32)
    z = rng.integers(-2, 3, size=(c,)).astype(np.float32)
    got = tops.quantize(_t(x), _t(s), _t(z), qmin=qmin, qmax=qmax,
                        out_dtype=_TORCH_OF[odt])
    _same(got, jref.quantize_ref(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(z), qmin=qmin, qmax=qmax,
                                 out_dtype=odt))
    _same(got, jops.quantize(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z),
                             qmin=qmin, qmax=qmax, out_dtype=odt,
                             use_pallas=True, interpret=True))
    _same(t_quantize(_t(x), _t(s), _t(z), qmin=qmin, qmax=qmax,
                     out_dtype=_TORCH_OF[odt]), got.numpy())


@pytest.mark.parametrize("ftype", [np.float32, np.float64])
def test_quantize_halfway_rounds_to_even(ftype):
    """x / s lands exactly on k + 0.5 (power-of-two scale): both packages
    round half to even; a scalar scale broadcasts over the channels."""
    k = np.arange(-12, 12)
    x = ((k + 0.5) * 0.25).astype(ftype).reshape(4, 6)
    s = np.asarray([0.25], np.float32)
    z = np.asarray([0.0], np.float32)
    want = np.clip(np.round(k + 0.5), -8, 7).reshape(4, 6)   # numpy: to even
    got = tops.quantize(_t(x), _t(s), _t(z), qmin=-8, qmax=7,
                        out_dtype=torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        _same(got, jops.quantize(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(z), qmin=-8, qmax=7,
                                 out_dtype=jnp.int32, use_pallas=True,
                                 interpret=True))
        _same(got, jref.quantize_ref(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(z), qmin=-8, qmax=7,
                                     out_dtype=jnp.int32))


def test_quantize_float64_keeps_float32_parameters():
    """In float64 mode scale and zero point are still rounded to float32
    and then promoted, as the reference kernel does (quantize.py:35-38)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 7)) * 3
    s = rng.uniform(0.01, 0.3, size=(7,))          # float64 on purpose
    z = np.zeros((7,))
    got = t_quantize(_t(x), _t(s), _t(z), out_dtype=torch.int32)
    with jax.enable_x64(True):
        _same(got, jops.quantize(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(z), out_dtype=jnp.int32,
                                 use_pallas=True, interpret=True))
    want = np.clip(np.round(x / s.astype(np.float32).astype(np.float64)),
                   -128, 127)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the device rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["int_matmul", "multithreshold", "quantize"])
def test_use_kernel_true_on_cpu_tensor_raises(call):
    xi = torch.ones((4, 8), dtype=torch.int32)
    xf = torch.ones((4, 8), dtype=torch.float32)
    one = torch.ones((1,), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if call == "int_matmul":
            tops.int_matmul(xi, xi.T.contiguous(), use_kernel=True)
        elif call == "multithreshold":
            tops.multithreshold(xi, xi[:3], use_kernel=True)
        else:
            tops.quantize(xf, one, one, use_kernel=True)


@pytest.mark.parametrize("call", ["int_matmul", "multithreshold", "quantize"])
def test_wrappers_reject_what_the_kernel_does_not_take(call):
    xi = torch.ones((4, 8), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if call == "int_matmul":       # mixed operand types
            t_int_matmul(xi, torch.ones((8, 3), dtype=torch.int8))
        elif call == "multithreshold":  # compare types differ
            t_multithreshold(xi, torch.ones((3, 8), dtype=torch.float32))
        else:                           # integer input
            t_quantize(xi, torch.ones(1), torch.zeros(1))


def test_build_without_nvcc_raises_and_nothing_falls_back(tmp_path,
                                                          monkeypatch):
    """Where there is no CUDA compiler the loader raises — it never hands
    back a substitute for the kernels."""
    import shutil
    from repro_torch.kernels import _build
    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc"
                                            ).exists():
        pytest.skip("this machine has nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None and not list(tmp_path.iterdir())


def test_oversized_launch_grid_is_refused_with_a_clear_message():
    from repro_torch.kernels import _build
    _build.check_grid("int_matmul", _build.MAX_GRID_X, _build.MAX_GRID_Y)
    with pytest.raises(ValueError, match="int_matmul kernel.*grid limit"):
        _build.check_grid("int_matmul", 4, _build.MAX_GRID_Y + 1)
    with pytest.raises(ValueError, match="multithreshold kernel"):
        _build.check_grid("multithreshold", _build.MAX_GRID_X + 1, 1)
