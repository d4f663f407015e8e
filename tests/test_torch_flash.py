"""Port parity for the fourth kernel, flash attention: the port's
``flash_attention_fwd`` on CPU tensors (its plain version,
``ref.flash_attention_ref``) against the JAX package's Pallas kernel in
interpret mode, its ``flash_attention_ref`` oracle, and the model's own
chunked scan ``repro.models.attention.flash_attention`` (ragged lengths,
``window``, ``q_offset``), on the same numpy inputs.

Tolerance: float32 at ``rtol=atol=2e-5``, the reference's own bound for
its kernel against its oracle (the sums run in another order: chunked
online softmax against one materialised softmax).  bfloat16 outputs: one
bf16 ulp of the reference's output.

The CUDA kernel itself runs only on a card: ``tests/test_torch_gpu.py``
and ``python3 chip_smoke.py`` hold it against this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    flash_attention_fwd as j_flash_fwd, flash_attention_ref as j_flash_ref)
from repro.models.attention import flash_attention as j_model_fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models.attention import flash_attention as t_model_fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, Sq, Sk, H, KV, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(dtype),
            rng.normal(size=(B, Sk, KV, hd)).astype(dtype),
            rng.normal(size=(B, Sk, KV, hd)).astype(dtype))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("B,Sq,H,KV,hd,cap", [(2, 128, 4, 2, 64, 0.0),
                                              (1, 256, 8, 8, 64, 50.0),
                                              (2, 128, 6, 2, 32, 0.0)])
def test_matches_pallas_kernel_and_its_oracle(B, Sq, H, KV, hd, cap):
    """The grid of the reference's own kernel test."""
    q, k, v = _qkv(Sq + H, B, Sq, Sq, H, KV, hd)
    got = flash_attention_fwd(_t(q), _t(k), _t(v), logit_cap=cap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = j_flash_fwd(jq, jk, jv, bq=64, bk=64, logit_cap=cap,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_flash_ref(jq, jk, jv, logit_cap=cap)),
        **TOL)


# (B, Sq, Sk, H, KV, hd, causal, window, q_offset, cap, chunk)
MODEL_CASES = {
    "ragged 100": (2, 100, 100, 4, 2, 32, True, 0, 0, 0.0, 32),
    "ragged gqa3 hd24": (1, 37, 37, 6, 2, 24, True, 0, 0, 0.0, 16),
    "window": (2, 96, 96, 4, 2, 16, True, 24, 0, 0.0, 16),
    "window ragged cap": (1, 100, 100, 4, 4, 32, True, 7, 0, 50.0, 10),
    "q_offset (chunked prefill)": (2, 24, 88, 4, 2, 32, True, 0, 64, 0.0,
                                   22),
    "q_offset window": (1, 33, 97, 4, 2, 16, True, 16, 64, 30.0, 97),
    "not causal": (2, 40, 70, 4, 2, 16, False, 0, 0, 0.0, 35),
    "not causal window": (1, 40, 70, 2, 1, 16, False, 12, 0, 0.0, 14),
    "fully masked rows": (1, 16, 32, 4, 2, 16, True, 8, 64, 0.0, 8),
    "hd 256": (1, 40, 40, 2, 1, 256, True, 0, 0, 0.0, 40),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_matches_model_attention(case):
    """The model-level function of both packages (the port's is the
    kernel's wrapper) on what the Pallas kernel does not take: lengths no
    block divides, ``window``, ``q_offset``, non-causal, rows that see no
    key (every key masked: the finite -1e30 makes them a uniform average,
    never NaN)."""
    B, Sq, Sk, H, KV, hd, causal, window, q_offset, cap, chunk = \
        MODEL_CASES[case]
    q, k, v = _qkv(sum(map(ord, case)), B, Sq, Sk, H, KV, hd)
    got = t_model_fa(_t(q), _t(k), _t(v), causal=causal, window=window,
                     q_offset=q_offset, logit_cap=cap)
    want = j_model_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, window=window, logit_cap=cap,
                      chunk=chunk, q_offset=q_offset)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "fully masked rows":      # q_pos - k_pos >= 33 > window
        np.testing.assert_allclose(
            got.numpy(), np.broadcast_to(
                np.repeat(v.mean(1, keepdims=True), H // KV, axis=2),
                got.shape), **TOL)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_bfloat16_within_one_output_ulp():
    """bf16 in, bf16 out, float32 inside: the port and the reference each
    round one float32 result to bf16, so they differ by at most one ulp."""
    q, k, v = _qkv(5, 2, 64, 64, 4, 2, 32)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_fwd(tq, tk, tv, window=16, logit_cap=20.0)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(j_model_fa(jq, jk, jv, window=16, logit_cap=20.0,
                                 chunk=16), np.float32)
    diff = np.abs(got.to(torch.float32).numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), float(diff.max())


def test_plain_version_is_what_cpu_tensors_get():
    q, k, v = map(_t, _qkv(1, 1, 20, 20, 2, 1, 16))
    np.testing.assert_array_equal(
        flash_attention_fwd(q, k, v, window=5).numpy(),
        tref.flash_attention_ref(q, k, v, window=5).numpy())


@pytest.mark.parametrize("bad", ["dtype", "kv shapes", "heads", "window",
                                 "no keys", "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = map(_t, _qkv(2, 1, 8, 8, 4, 2, 16))
    kw = {}
    if bad == "dtype":
        k = k.double()
    elif bad == "kv shapes":
        v = v[:, :4]
    elif bad == "heads":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "window":
        kw = dict(window=-1)
    elif bad == "no keys":
        k, v = k[:, :0], v[:, :0]
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, k, v, **kw)
