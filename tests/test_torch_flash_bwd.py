"""The attention backward of the port on the CPU: the plain backward
``ref.flash_attention_bwd_ref`` (the backward kernels' formulas), the
plain log-sum-exp ``ref.flash_attention_lse_ref``, the autograd function
``flash_attention.FlashAttention`` and the bar ``grad_tolerance``, on
numpy inputs made from a seed.

- The plain backward against autograd through ``flash_attention_ref``,
  float64, within 1e-10: the same function, differentiated two ways.
- The plain backward against ``jax.vjp`` of the reference's own scanned
  attention (``repro.models.attention.flash_attention``), float32, within
  1e-5 of each gradient's largest element (float32 sums in another
  order: an online softmax over chunks against one materialised
  softmax).
- The plain lse against ``jax.nn.logsumexp`` of the reference's scores.
- ``FlashAttention`` through ``torch.utils.checkpoint`` on CPU tensors,
  where it runs the plain forward and backward: this holds the wiring,
  not the kernels, which run only on a card (``tests/test_torch_gpu.py``,
  ``python3 chip_smoke.py``).
- The tensor-core backward's arithmetic (P and dS rounded to 16 bits
  before the three products), emulated in plain PyTorch, within
  ``grad_tolerance`` with its rounding term of the plain backward and of
  ``jax.vjp``; ``ref.flash_attention_bwd_magnitudes`` against float64;
  ``route_for``.
- gemma2's head dim 256 (``HD256_CASES``: B=1, S=96, H=4, KV=2; window,
  soft-cap, q_offset), which the tensor-core route takes with its second
  tiling: the same checks at that head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.attention import flash_attention as j_model_fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (
    CUDA_CORES, FlashAttention, TENSOR_CORES, bwd_dkdv, flash_attention_bwd,
    flash_attention_fwd, flash_attention_fwd_lse, grad_tolerance, route_for,
    ulp)

# (B, Sq, Sk, H, KV, hd, keywords): causal, window, q_offset, logit_cap,
# GQA groups 1 and 3, lengths that no chunk divides
CASES = {
    "causal g3": (2, 13, 13, 6, 2, 8, {}),
    "g1 cap": (1, 17, 17, 2, 2, 8, dict(logit_cap=3.0)),
    "window": (1, 21, 21, 3, 1, 8, dict(window=5)),
    "q_offset": (2, 9, 29, 3, 1, 8, dict(q_offset=20)),
    "q_offset window cap": (1, 11, 37, 6, 2, 16,
                            dict(q_offset=26, window=7, logit_cap=2.5)),
    "not causal window": (1, 10, 23, 2, 1, 8,
                          dict(causal=False, window=6)),
}
# rows that see no key (every row of the first case, the rows before
# position 0 in the second): their forward averages v over all keys (the
# reference's finite mask)
DEAD_CASES = {
    "rows that see no key": (1, 6, 10, 4, 2, 8, dict(q_offset=30,
                                                      window=4)),
    "some rows see no key": (1, 8, 12, 2, 1, 8, dict(q_offset=-4)),
}
# gemma2's head (hd 256; its window and soft-cap scaled to S=96), the
# tensor_cores route's tiling for 128 < hd <= 256
HD256_CASES = {
    "hd256 causal": (1, 96, 96, 4, 2, 256, {}),
    "hd256 window cap": (1, 96, 96, 4, 2, 256,
                         dict(window=40, logit_cap=50.0)),
    "hd256 q_offset window cap": (1, 96, 160, 4, 2, 256,
                                  dict(q_offset=64, window=40,
                                       logit_cap=50.0)),
}
DEFAULTS = dict(causal=True, window=0, q_offset=0, logit_cap=0.0)
ALL_CASES = {**CASES, **DEAD_CASES, **HD256_CASES}


def _inputs(seed, B, Sq, Sk, H, KV, hd, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                          (B, Sq, H, hd))]


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _autograd(q, k, v, dout, kw):
    x = [_t(a, grad=True) for a in (q, k, v)]
    out = tref.flash_attention_ref(*x, **kw)
    return out.detach(), torch.autograd.grad(out, x, _t(dout))


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_plain_backward_equals_autograd_float64(case):
    B, Sq, Sk, H, KV, hd, kw = ALL_CASES[case]
    q, k, v, dout = _inputs(len(case), B, Sq, Sk, H, KV, hd)
    out, want = _autograd(q, k, v, dout, kw)
    lse = tref.flash_attention_lse_ref(_t(q), _t(k), **kw)
    assert lse.dtype == torch.float64 and lse.shape == (B, H, Sq)
    got = tref.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                       _t(dout), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-10)


def test_rows_that_see_no_key_spread_dv_over_every_key():
    """The forward averages v over all keys for such a row, so each key
    gets 1/Sk of that row's dout; dq and dk get nothing."""
    B, Sq, Sk, H, KV, hd, kw = DEAD_CASES["rows that see no key"]
    q, k, v, dout = map(_t, _inputs(0, B, Sq, Sk, H, KV, hd))
    out = tref.flash_attention_ref(q, k, v, **kw)
    lse = tref.flash_attention_lse_ref(q, k, **kw)
    assert bool((lse < tref.DEAD_LSE).all())
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                              **kw)
    assert not dq.any() and not dk.any()
    per_kv = dout.reshape(B, Sq, KV, H // KV, hd).sum(dim=(1, 3)) / Sk
    np.testing.assert_allclose(dv.numpy(), per_kv[:, None].expand(
        B, Sk, KV, hd).numpy(), rtol=0, atol=1e-12)


def _j_scores(q, k, *, causal, window, q_offset, logit_cap):
    """The reference's scores (``repro.models.attention.flash_attention``'s
    expression), masked, as (B, Sq, KV, g, Sk)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = (q * hd ** -0.5).reshape(B, Sq, KV, H // KV, hd)
    s = jnp.einsum("bqkgh,bckh->bqkgc", qf, k)
    if logit_cap:
        s = logit_cap * jnp.tanh(s / logit_cap)
    q_pos = q_offset + jnp.arange(Sq)
    k_pos = jnp.arange(Sk)
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return jnp.where(mask[None, :, None, None, :], s, -1e30)


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_plain_lse_matches_jax_logsumexp(case):
    B, Sq, Sk, H, KV, hd, kw = ALL_CASES[case]
    q, k, _, _ = _inputs(len(case), B, Sq, Sk, H, KV, hd, np.float32)
    got = tref.flash_attention_lse_ref(_t(q), _t(k), **kw)
    assert got.dtype == torch.float32
    s = _j_scores(jnp.asarray(q), jnp.asarray(k), **{**DEFAULTS, **kw})
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(
        B, Sq, H).transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES) + list(HD256_CASES))
def test_plain_backward_matches_jax_vjp(case):
    """float32: the plain backward (fed the port's plain out and lse)
    against ``jax.vjp`` of the reference's scanned attention, chunked by
    a chunk that divides no length given (the scan takes the largest
    divisor below it), within 1e-5 of each gradient's largest element
    (float32 sums in another order); at hd 256 too."""
    B, Sq, Sk, H, KV, hd, kw = {**CASES, **HD256_CASES}[case]
    q, k, v, dout = _inputs(len(case) + 1, B, Sq, Sk, H, KV, hd,
                            np.float32)
    full = {**DEFAULTS, **kw}
    _, vjp = jax.vjp(lambda a, b, c: j_model_fa(a, b, c, chunk=4, **full),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = tref.flash_attention_ref(tq, tk, tv, **kw)
    lse = tref.flash_attention_lse_ref(tq, tk, **kw)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, _t(dout),
                                       **kw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _apply(kw):
    full = {**DEFAULTS, **kw}
    return lambda q, k, v: FlashAttention.apply(
        q, k, v, full["causal"], full["window"], full["q_offset"],
        full["logit_cap"])


@pytest.mark.parametrize("case", list(CASES) + list(DEAD_CASES))
def test_autograd_function_through_checkpoint_on_cpu(case):
    """``FlashAttention`` under ``checkpoint(use_reentrant=False)`` (the
    train step's remat): the forward equals the plain one and the
    gradient equals autograd through the plain forward, float32."""
    B, Sq, Sk, H, KV, hd, kw = {**CASES, **DEAD_CASES}[case]
    q, k, v, dout = _inputs(len(case) + 2, B, Sq, Sk, H, KV, hd,
                            np.float32)
    x = [_t(a, grad=True) for a in (q, k, v)]
    out = checkpoint(_apply(kw), *x, use_reentrant=False)
    got = torch.autograd.grad(out, x, _t(dout))
    want_out, want = _autograd(q, k, v, dout, kw)
    assert torch.equal(out.detach(), want_out)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("case", ["causal g3", "q_offset window cap"])
def test_cpu_wrappers_are_the_plain_versions(case):
    """On CPU tensors the wrappers run the plain versions, bit for bit,
    and ``flash_attention_fwd`` stays differentiable through them."""
    B, Sq, Sk, H, KV, hd, kw = CASES[case]
    q, k, v, dout = map(_t, _inputs(3, B, Sq, Sk, H, KV, hd, np.float32))
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    assert torch.equal(out, tref.flash_attention_ref(q, k, v, **kw))
    assert torch.equal(lse, tref.flash_attention_lse_ref(q, k, **kw))
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(flash_attention_fwd(*x, **kw), x, dout)
    assert all(g is not None and g.shape == t.shape
               for g, t in zip(grads, x))


def _tiled_dkdv(q, k, v, out, lse, dout, tile, kw):
    """dk, dv summed over query tiles of ``tile`` rows one after the
    other, as the dK/dV kernel does (float32)."""
    dk = dv = 0.0
    for i in range(0, q.shape[1], tile):
        sl = slice(i, i + tile)
        part = tref.flash_attention_bwd_ref(
            q[:, sl], k, v, out[:, sl], lse[:, :, sl], dout[:, sl],
            **{**kw, "q_offset": kw.get("q_offset", 0) + i})
        dk = dk + part[1].float()
        dv = dv + part[2].float()
    return dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", ["causal g3", "q_offset window cap"])
def test_grad_tolerance_covers_another_summation_order(case, dtype):
    """Summing dk and dv over query tiles (the kernel's order) instead of
    in one product moves them by float32 rounding only, within
    ``grad_tolerance``; in 16 bits the bar is at least one ulp."""
    B, Sq, Sk, H, KV, hd, kw = CASES[case]
    q, k, v, dout = (_t(a).to(dtype) for a in _inputs(
        4, B, Sq, Sk, H, KV, hd, np.float32))
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    _, dk, dv = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    f32 = [t.float() for t in (q, k, v, out, dout)]
    tk, tv = _tiled_dkdv(f32[0], f32[1], f32[2], f32[3], lse, f32[4], 4,
                         kw)
    for plain, tiled in ((dk, tk), (dv, tv)):
        bar = grad_tolerance(plain)
        assert bool(((tiled.to(dtype).double() - plain.double()).abs()
                     <= bar).all())
        if dtype != torch.float32:
            assert bool((bar >= ulp(plain)).all())


_16BIT = (torch.bfloat16, torch.float16)


def _rounded_bwd(q, k, v, out, lse, dout, kw):
    """The tensor-core backward's arithmetic in plain PyTorch: P and dS
    of the plain backward (float32) rounded to q's 16-bit type before
    dV = Pᵀ dO, dK = dSᵀ q and dQ = dS k, whose float32 sums are scaled
    by hd^-0.5 after the dot (dK, dQ), then rounded once."""
    B, Sq, H, hd = q.shape
    full = {**DEFAULTS, **kw}
    _, p, ds, do = tref._bwd_factors(q, k, v, out, lse, dout, **full)
    r16 = [x.to(q.dtype).float() for x in (p, ds)]
    dv = torch.einsum("bqkgs,bqkgh->bskh", r16[0], do)
    dk = torch.einsum("bqkgs,bqkgh->bskh", r16[1], q.float().reshape(
        do.shape)) * hd ** -0.5
    dq = torch.einsum("bqkgs,bskh->bqkgh", r16[1], k.float()) * hd ** -0.5
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("dtype", _16BIT)
@pytest.mark.parametrize("case", list(ALL_CASES))
def test_p_and_ds_rounding_stays_within_the_tensor_core_tolerance(case,
                                                                  dtype):
    """The ``tensor_cores`` route is held to ``grad_tolerance(plain,
    magnitude)``.  The plain backward with P and dS rounded to 16 bits
    stays within that bar of the unrounded plain backward on the same out
    and lse (what the kernel is compared with on the card), and of the
    reference's ``jax.vjp`` gradient of the same 16-bit values (fed the
    float32 forward's out and lse, as the reference differentiates its
    float32 arithmetic), so the bar follows from the rounding and is no
    fit to the kernel.  At hd 256 (``HD256_CASES``) the bar of the
    route's second tiling, which rounds P and dS the same way."""
    B, Sq, Sk, H, KV, hd, kw = ALL_CASES[case]
    q, k, v, dout = (_t(a).to(dtype) for a in _inputs(
        len(case) + 5, B, Sq, Sk, H, KV, hd, np.float32))
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    got = _rounded_bwd(q, k, v, out, lse, dout, kw)
    plain = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    mags = tref.flash_attention_bwd_magnitudes(q, k, v, out, lse, dout,
                                               **kw)
    for g, w, m in zip(got, plain, mags):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        err = (g.double() - w.double()).abs()
        assert bool((err <= grad_tolerance(w, m)).all()), float(err.max())

    f32 = [t.float() for t in (q, k, v, dout)]
    out32, lse32 = flash_attention_fwd_lse(*f32[:3], **kw)
    got = _rounded_bwd(q, k, v, out32, lse32, dout, kw)
    mags = tref.flash_attention_bwd_magnitudes(q, k, v, out32, lse32, dout,
                                               **kw)
    full = {**DEFAULTS, **kw}
    _, vjp = jax.vjp(lambda a, b, c: j_model_fa(a, b, c, chunk=4, **full),
                     *(jnp.asarray(t.numpy()) for t in f32[:3]))
    want = vjp(jnp.asarray(f32[3].numpy()))
    for g, w, m in zip(got, want, mags):
        w = _t(np.array(w, np.float32)).to(dtype)
        err = (g.double() - w.double()).abs()
        assert bool((err <= grad_tolerance(w, m)).all()), float(err.max())


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_bwd_magnitudes_match_float64(case):
    """``flash_attention_bwd_magnitudes`` in float32 within 1e-5 relative
    of the same in float64 (sums of non-negative terms), and in float64
    each one bounds its gradient (|dq| <= |dS||k|·hd^-0.5, ...)."""
    B, Sq, Sk, H, KV, hd, kw = ALL_CASES[case]
    x64 = [_t(a) for a in _inputs(len(case) + 6, B, Sq, Sk, H, KV, hd)]
    out64 = tref.flash_attention_ref(*x64[:3], **kw)
    lse64 = tref.flash_attention_lse_ref(*x64[:2], **kw)
    m64 = tref.flash_attention_bwd_magnitudes(*x64[:3], out64, lse64,
                                              x64[3], **kw)
    grads = tref.flash_attention_bwd_ref(*x64[:3], out64, lse64, x64[3],
                                         **kw)
    x32 = [t.float() for t in (*x64[:3], out64, lse64, x64[3])]
    m32 = tref.flash_attention_bwd_magnitudes(*x32, **kw)
    for a, b, g in zip(m32, m64, grads):
        assert a.dtype == torch.float32 and a.shape == g.shape
        assert b.dtype == torch.float64 and bool((b >= 0).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.max()))
        assert bool((g.abs() <= b * (1 + 1e-12) + 1e-300).all())


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route_for(dtype, hd):
    """bfloat16/float16 with hd <= 256 take the tensor cores (hd 256 with
    the tiling that splits the head between the warpgroups); float32
    (exact float32 has no tensor-core path) the CUDA cores."""
    want = TENSOR_CORES if dtype != torch.float32 and hd <= 256 \
        else CUDA_CORES
    assert route_for(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.float32, 64, TENSOR_CORES), (torch.bfloat16, 320, TENSOR_CORES),
    (torch.bfloat16, 64, "warp_specialized")])
def test_a_forced_route_the_inputs_cannot_take_raises(dtype, hd, route):
    """Before any launch (so also without a card): no silent fallback."""
    q = torch.zeros((1, 4, 2, hd), dtype=dtype)
    k = torch.zeros((1, 4, 1, hd), dtype=dtype)
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError):
        bwd_dkdv(q, k, k, q, lse, lse, causal=True, window=0, q_offset=0,
                 logit_cap=0.0, route=route)
