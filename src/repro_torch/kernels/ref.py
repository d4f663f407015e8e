"""Plain PyTorch versions of the kernels (correctness references).

They run on any device.  The tests and the CPU device use them; on the
card they are only what a kernel is held against, never a route of the
main path.
"""
from __future__ import annotations

from typing import Optional

import torch


def _int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the integers modulo 2^32, as int32."""
    if not x.is_cuda:
        # the CPU integer matmul wraps in two's complement
        return torch.matmul(x.to(torch.int32), w.to(torch.int32))
    # the card has no integer matmul in PyTorch: a float64 product is exact
    # while every partial sum stays below 2^53 ...
    K = x.shape[1]
    if K == 0:
        return torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32,
                           device=x.device)

    def mag(t: torch.Tensor) -> int:
        lo, hi = torch.aminmax(t)
        return max(-int(lo), int(hi))
    if mag(x) * mag(w) * K < 2 ** 53:
        acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
        return acc.to(torch.int64).to(torch.int32)   # int64->int32 wraps
    # ... beyond that, multiply and sum in int64 (which wraps modulo 2^64,
    # consistent with 2^32), a slice of rows at a time
    w64 = w.to(torch.int64)
    rows = max(1, (1 << 24) // max(1, K * w.shape[1]))
    parts = [(x[i:i + rows].to(torch.int64)[:, :, None] * w64[None]).sum(1)
             for i in range(0, x.shape[0], rows)]
    return torch.cat(parts).to(torch.int32)


def int_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   acc_bits: int = 32, out_dtype=None) -> torch.Tensor:
    acc_dtype = torch.int16 if acc_bits <= 15 else torch.int32
    acc = _int_dot(x, w).to(acc_dtype)   # emulate narrow accumulation
    #                                      (lossless if the SIRA bound holds)
    if scale is None:
        return acc.to(out_dtype or acc_dtype)
    y = acc.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)
    y = y + (0.0 if bias is None
             else bias.reshape(1, -1).to(torch.float32))
    return y.to(out_dtype or torch.float32)


def multithreshold_ref(x: torch.Tensor, thresholds: torch.Tensor,
                       out_bias: int = 0, out_dtype=None) -> torch.Tensor:
    """x (M, C); thresholds (N, C). out = out_bias + sum_i(x >= T_i).

    out_dtype defaults to the smallest dtype holding [out_bias,
    out_bias + N] (see ``multithreshold.infer_out_dtype``)."""
    from .multithreshold import infer_out_dtype
    if out_dtype is None:
        out_dtype = infer_out_dtype(thresholds.shape[0], out_bias)
    # one compare per threshold row: N passes over x, never an (M, N, C)
    # intermediate
    cnt = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for t in thresholds:
        cnt += x >= t
    return (cnt + out_bias).to(out_dtype)


def multithreshold_searchsorted_ref(x: torch.Tensor,
                                    thresholds: torch.Tensor,
                                    out_bias: int = 0,
                                    out_dtype=None) -> torch.Tensor:
    """Bisection formulation (the paper's Fig 17 search tree, as a
    per-column searchsorted) — same function, O(log N) comparisons."""
    from .multithreshold import infer_out_dtype
    if out_dtype is None:
        out_dtype = infer_out_dtype(thresholds.shape[0], out_bias)
    cnt = torch.searchsorted(thresholds.T.contiguous(), x.T.contiguous(),
                             right=True).T
    return (cnt + out_bias).to(out_dtype)


def quantize_ref(x: torch.Tensor, scale: torch.Tensor,
                 zero_point: torch.Tensor, qmin: int = -128, qmax: int = 127,
                 out_dtype=torch.int8) -> torch.Tensor:
    q = torch.round(x / scale.reshape(1, -1) + zero_point.reshape(1, -1))
    return torch.clamp(q, qmin, qmax).to(out_dtype)


#: the reference's finite mask value (never -inf: a fully masked row or
#: tile must stay finite)
NEG_INF = -1e30
#: an lse below this marks a query row that sees no key: its lse is
#: -1e30 + ln Sk, which float32 (and float64) round to -1e30
DEAD_LSE = -1e29


def _work_dtype(q: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (the float64 oracle)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, *, causal, window, q_offset, logit_cap):
    """(q scaled by hd^-0.5 as (B, Sq, KV, g, hd), the capped scores
    (B, Sq, KV, g, Sk) before the mask, tanh(s/cap) or None, the (Sq, Sk)
    mask of visible pairs), in the working type."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    wt = _work_dtype(q)
    qf = (q.to(wt) * hd ** -0.5).reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qf, k.to(wt))
    t = None
    if logit_cap:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return qf, s, t, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """Materialised-softmax attention, q (B, Sq, H, hd), k/v (B, Sk, KV,
    hd), H = KV·g; query h reads KV head h // g.  All arithmetic in
    float32 (float64 for float64 inputs; q cast and scaled by hd^-0.5
    before the dot), output in q's dtype.  Query i sits at position
    ``q_offset + i``, key j at j; ``causal`` keeps keys at or before the
    query, ``window > 0`` keeps keys less than ``window`` positions behind
    it."""
    B, Sq, H, hd = q.shape
    _, s, _, mask = _scores(q, k, causal=causal, window=window,
                            q_offset=q_offset, logit_cap=logit_cap)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p, v.to(_work_dtype(q)))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0,
                            logit_cap: float = 0.0) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled, capped, masked scores,
    (B, H, Sq) in float32 (float64 for float64 inputs): what the forward
    kernel writes beside its output for the backward."""
    B, Sq, H, _ = q.shape
    _, s, _, mask = _scores(q, k, causal=causal, window=window,
                            q_offset=q_offset, logit_cap=logit_cap)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(B, Sq, H).permute(0, 2, 1)


def _bwd_factors(q, k, v, out, lse, dout, *, causal, window, q_offset,
                 logit_cap):
    """The backward's factors in the working type: q·hd^-0.5 (B, Sq, KV,
    g, hd), P and dS (B, Sq, KV, g, Sk), dout (B, Sq, KV, g, hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    wt = _work_dtype(q)
    qf, s, t, mask = _scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, logit_cap=logit_cap)
    rows = lse.to(wt).permute(0, 2, 1).reshape(B, Sq, KV, H // KV)[..., None]
    m = mask[None, :, None, None, :]
    p = torch.where(m, torch.exp(s - rows), (rows < DEAD_LSE).to(wt) / Sk)
    do = dout.to(wt).reshape(B, Sq, KV, H // KV, hd)
    d = (do * out.to(wt).reshape(B, Sq, KV, H // KV, hd)).sum(-1)
    dp = torch.einsum("bqkgh,bskh->bqkgs", do, v.to(wt))
    ds = torch.where(m, p * (dp - d[..., None]), 0.0)
    if t is not None:
        ds = ds * (1.0 - t * t)
    return qf, p, ds, do


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0, logit_cap: float = 0.0):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at q, k,
    v for the output gradient ``dout``, from the forward's ``out`` and
    ``lse`` (B, H, Sq), by the backward kernel's formulas, in float32
    (float64 for float64 inputs), each in its input's dtype:
    P = exp(s - lse) on visible pairs, D = rowsum(dout·out),
    dS = P·(dout·vᵀ - D) (times 1 - tanh²(s_raw/cap) with a cap),
    dv = Pᵀ·dout, dk = dSᵀ·(q·hd^-0.5), dq = dS·k·hd^-0.5.  A masked pair
    has dS = 0 and P = 0, but in a row that sees no key (lse below
    ``DEAD_LSE``) P = 1/Sk: its forward averaged v over every key."""
    B, Sq, H, hd = q.shape
    qf, p, ds, do = _bwd_factors(q, k, v, out, lse, dout, causal=causal,
                                 window=window, q_offset=q_offset,
                                 logit_cap=logit_cap)
    wt = qf.dtype
    dv = torch.einsum("bqkgs,bqkgh->bskh", p, do)
    dk = torch.einsum("bqkgs,bqkgh->bskh", ds, qf)
    dq = torch.einsum("bqkgs,bskh->bqkgh", ds, k.to(wt)) * hd ** -0.5
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_magnitudes(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True, window: int = 0,
                                   q_offset: int = 0,
                                   logit_cap: float = 0.0):
    """The products of :func:`flash_attention_bwd_ref` taken over absolute
    values, (|dS|·|k|·hd^-0.5, |dS|ᵀ·|q·hd^-0.5|, Pᵀ·|dout|), shaped like
    (dq, dk, dv), in the working type (float32, float64 for float64
    inputs): rounding P and dS by at most a relative r before the three
    products moves each gradient by at most r times its entry here (what
    ``flash_attention.grad_tolerance`` allows the tensor-core backward)."""
    B, Sq, H, hd = q.shape
    qf, p, ds, do = _bwd_factors(q, k, v, out, lse, dout, causal=causal,
                                 window=window, q_offset=q_offset,
                                 logit_cap=logit_cap)
    ads = ds.abs()
    mag_v = torch.einsum("bqkgs,bqkgh->bskh", p, do.abs())
    mag_k = torch.einsum("bqkgs,bqkgh->bskh", ads, qf.abs())
    mag_q = torch.einsum("bqkgs,bskh->bqkgh", ads,
                         k.to(qf.dtype).abs()) * hd ** -0.5
    return mag_q.reshape(B, Sq, H, hd), mag_k, mag_v
