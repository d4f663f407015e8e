"""Plain PyTorch versions of the four kernels (correctness references).

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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """Materialised-softmax attention, q (B, Sq, H, hd), k/v (B, Sk, KV,
    hd), H = KV·g; query h reads KV head h // g.  All arithmetic in
    float32 (q cast and scaled by hd^-0.5 before the dot), output in q's
    dtype.  Query i sits at position ``q_offset + i``, key j at j;
    ``causal`` keeps keys at or before the query, ``window > 0`` keeps
    keys less than ``window`` positions behind it."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    g = H // KV
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(B, Sq, KV, g, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qf, k.to(torch.float32))
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)
