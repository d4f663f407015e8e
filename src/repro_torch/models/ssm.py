"""Mamba2 block: SSD (state-space duality) in its chunked form
(arXiv:2405.21060).

Counterpart of ``src/repro/models/ssm.py``.  Prefill takes the chunked
dual algorithm: a quadratic, attention-like product *within* chunks and a
linear recurrence over per-chunk states *between* them (a Python loop
over the chunks, the reference's ``lax.scan``).  Decode is the O(1)
stateful update, written **in place** into the caller's state, as the
port's KV cache is.  The reference has no Pallas kernel here, so the
products are PyTorch matrix products; every three-operand einsum of the
reference is written as two explicit pairwise contractions, so that no
contraction order materialises a (B, nc, c, c, H, P) tensor.

Layout: x (B, S, d) → in_proj → [z (d_in), x (d_in), B (G·N), C (G·N),
dt (H)]; causal depthwise conv over (x, B, C); SSD over H heads of P =
d_in/H channels with state N; gated RMSNorm; out_proj.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import SSMConfig
from .common import TensorParallel, dense_init, linear, rms_norm


def init_mamba2(gen: torch.Generator, d: int, ssm: SSMConfig, dtype
                ) -> Dict[str, Any]:
    d_in = ssm.expand * d
    H = d_in // ssm.head_dim
    G, N = ssm.n_groups, ssm.d_state
    d_proj = 2 * d_in + 2 * G * N + H
    d_conv_ch = d_in + 2 * G * N
    dev = gen.device
    # A_log, D and dt_bias stay float32 in a bf16 model, as in the reference
    dt0 = torch.linspace(1e-3, 0.1, H, dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, d_proj), dtype=dtype),
        "conv_w": dense_init(gen, (ssm.d_conv, d_conv_ch), scale=0.5,
                             dtype=dtype),
        "conv_b": torch.zeros((d_conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": torch.zeros((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_in, d), scale=d_in ** -0.5,
                               dtype=dtype),
    }


def _split_proj(proj, d_in, G, N, H):
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * G * N]
    dt = proj[..., -H:]
    return z, xbc, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  xbc (B, S, Ch), w (K, Ch); state,
    when given, is the last K-1 inputs before ``xbc``.  Returns
    (silu(y), the last K-1 inputs), the products summed in the
    reference's order."""
    K, S = w.shape[0], xbc.shape[1]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)     # (B, S+K-1, Ch)
    y = xp[:, :S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y + b), xp[:, S:]


def ssd_chunked(xh, dt, A, B_, C_, chunk: int):
    """SSD dual-form scan, in float32.

    xh (B,S,H,P), dt (B,S,H) softplus'd, A (H,) > 0 decay rates, B_/C_
    (B,S,G,N) with G = 1 broadcast over H.  Returns (y (B,S,H,P), the
    final state (B,H,P,N))."""
    Bb, S, H, P = xh.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    lam = (dt * A).to(f32)                                  # (B,S,H) decay
    xw = xh.to(f32) * dt[..., None]                         # dt-weighted x
    lam_c = lam.reshape(Bb, nc, chunk, H)
    x_c = xw.reshape(Bb, nc, chunk, H, P)
    B_c = B_.to(f32).reshape(Bb, nc, chunk, N)              # G = 1
    C_c = C_.to(f32).reshape(Bb, nc, chunk, N)

    # lam >= 0 is the *negative* log decay: step decay = exp(-lam).  The
    # running sum over the chunk is a product with a lower-triangular
    # ones matrix, not torch.cumsum: CUDA's float cumsum has no
    # deterministic form (torch.use_deterministic_algorithms raises)
    tri = torch.ones((chunk, chunk), dtype=f32, device=xh.device).tril()
    csum = torch.matmul(tri, lam_c)                         # (B,nc,c,H)
    # decay matrix L[i, j] = exp(-(csum_i - csum_j)) for j <= i, else 0:
    # seg is masked to +inf *before* the exp, which then gives 0 (for
    # j > i, exp(-seg) would overflow to inf at full width, and inf * 0
    # is NaN)
    seg = csum[:, :, :, None, :] - csum[:, :, None, :, :]   # (B,nc,c,c,H)
    idx = torch.arange(chunk, device=xh.device)
    seg.masked_fill_((idx[:, None] < idx[None, :])[:, :, None], math.inf)

    # intra-chunk (quadratic, attention-like):
    # y[c,h,p] = sum_m (C_c . B_m) L[c,m,h] x[m,h,p]
    scores = torch.matmul(C_c, B_c.transpose(-1, -2))       # (B,nc,c,m)
    W = torch.exp(-seg) * scores[..., None]                 # (B,nc,c,m,H)
    del seg
    y = torch.matmul(W.permute(0, 1, 4, 2, 3),              # (B,nc,H,c,m)
                     x_c.permute(0, 1, 3, 2, 4))            # (B,nc,H,m,P)
    del W

    # per-chunk input → state: S_n = sum_m exp(-(csum_end - csum_m)) x_m B_m
    decay_to_end = torch.exp(-(csum[:, :, -1:, :] - csum))  # (B,nc,c,H)
    xd = x_c * decay_to_end[..., None]                      # (B,nc,c,H,P)
    state_in = torch.matmul(xd.permute(0, 1, 3, 4, 2),      # (B,nc,H,P,c)
                            B_c[:, :, None])                # (B,nc,1,c,N)
    chunk_decay = torch.exp(-csum[:, :, -1, :])             # (B,nc,H)

    # the carry across chunks: s_prev[n] is the state before chunk n
    s = xh.new_zeros((Bb, H, P, N), dtype=f32)
    s_prev = torch.empty_like(state_in)                     # (B,nc,H,P,N)
    for n in range(nc):
        s_prev[:, n] = s
        s = s * chunk_decay[:, n, :, None, None] + state_in[:, n]

    # inter-chunk: y_i += exp(-csum_i) C_i . S_prev (inclusive decay)
    y_inter = torch.matmul(C_c[:, :, None],                 # (B,nc,1,c,N)
                           s_prev.transpose(-1, -2))        # (B,nc,H,N,P)
    y = y + y_inter * torch.exp(-csum).permute(0, 1, 3, 2)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(Bb, S, H, P), s


def apply_mamba2(params, x, ssm: SSMConfig, *, quant=None,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 decode: bool = False, tp: Optional[TensorParallel] = None):
    """x (B, S, d).  Prefill (``state=None``, ``decode=False``) → (y, the
    final states, new tensors).  Decode: S == 1 with a state dict {"conv",
    "ssd"} → (y, that dict, updated in place).

    Under tensor parallelism (``tp`` over a "model" axis > 1, the params
    a rank's blocks: ``launch/shardings.py``) the rank runs its H/m heads:
    ``in_proj`` holds the z, x and dt columns of those heads and the
    whole B and C (``n_groups`` = 1), ``conv_w``/``conv_b`` the x
    channels of its heads and B, C, and ``A_log``, ``D``, ``dt_bias`` and
    ``norm_scale`` its heads' entries.  B and C are computed alike on
    every rank and enter the split SSD through ``tp.copy``; the gated
    RMSNorm's sum of squares is summed over "model"; ``out_proj`` is
    split by row and its products summed.  The state is the rank's:
    conv (B, K-1, d_in/m + 2N), SSD (B, H/m, P, N)."""
    Bb, S, d = x.shape
    H = params["A_log"].shape[0]            # this rank's heads
    G, N, P = ssm.n_groups, ssm.d_state, ssm.head_dim
    d_in = H * P
    split = tp is not None and tp.size > 1

    if not split:
        proj = linear(x, params["in_proj"], quant=quant)
        z, xbc, dt_raw = _split_proj(proj, d_in, G, N, H)
    else:
        w = params["in_proj"]
        if not isinstance(w, torch.Tensor):  # packed int8 weights {q, s}
            w = w["q"].to(x.dtype) * w["s"].to(x.dtype)
        xc = tp.copy(x)
        zx = linear(xc, w[:, :2 * d_in], quant=quant)
        bc = linear(x, w[:, 2 * d_in:2 * d_in + 2 * G * N], quant=quant)
        dt_raw = linear(xc, w[:, 2 * d_in + 2 * G * N:], quant=quant)
        z, xbc = zx[..., :d_in], torch.cat([zx[..., d_in:], bc], dim=-1)
    xbc, new_conv = causal_conv(xbc, params["conv_w"], params["conv_b"],
                                state.get("conv") if state else None)
    xs = xbc[..., :d_in]
    bc = xbc[..., d_in:]
    if split:
        bc = tp.copy(bc)
    B_ = bc[..., :G * N].reshape(Bb, S, G, N)
    C_ = bc[..., G * N:].reshape(Bb, S, G, N)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (B,S,H)
    A = torch.exp(params["A_log"])                                   # (H,)
    xh = xs.reshape(Bb, S, H, P)

    if decode:
        if S != 1 or state is None:
            raise ValueError("apply_mamba2: decode takes one token and a "
                             "state")
        dec = torch.exp(-(dt[:, 0, :] * A))                  # (B,H)
        xw = xh[:, 0].to(torch.float32) * dt[:, 0, :, None]  # (B,H,P)
        ssd = state["ssd"]                                   # (B,H,P,N)
        ssd.mul_(dec[:, :, None, None]).add_(
            xw[..., None] * B_[:, 0, 0].to(torch.float32)[:, None, None, :])
        y = torch.matmul(ssd, C_[:, 0, 0].to(torch.float32)[:, None, :,
                                                              None])
        y = y[..., 0][:, None]                               # (B,1,H,P)
        state["conv"].copy_(new_conv)
        new_state = state
    else:
        y, s_final = ssd_chunked(xh, dt, A, B_, C_, min(ssm.chunk, S))
        new_state = {"conv": new_conv, "ssd": s_final}

    y = y + params["D"][:, None] * xh.to(torch.float32)
    y = y.reshape(Bb, S, d_in).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    if not split:
        y = rms_norm(y * F.silu(z), params["norm_scale"])
        return linear(y, params["out_proj"], quant=quant), new_state
    y = _split_rms_norm(y * F.silu(z), params["norm_scale"], tp)
    return tp.reduce(linear(y, params["out_proj"], quant=quant,
                            row_split=True)), new_state


def _split_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                    tp: TensorParallel, eps: float = 1e-6) -> torch.Tensor:
    """``rms_norm`` of a tensor whose last dim is split over "model": the
    sum of squares is summed over the axis (and its gradient too: every
    rank's part depends on it) before the mean."""
    dt = x.dtype
    x = x.to(torch.float32)
    ss = tp.copy(tp.reduce(torch.sum(torch.square(x), dim=-1,
                                     keepdim=True)))
    x = x * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def init_mamba_state(batch: int, d: int, ssm: SSMConfig, dtype,
                     device=None, n_heads: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Zero conv and SSD states; ``n_heads``: a rank's heads under tensor
    parallelism (default: all of them)."""
    H = n_heads or ssm.expand * d // ssm.head_dim
    ch = H * ssm.head_dim + 2 * ssm.n_groups * ssm.d_state
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, ch), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, H, ssm.head_dim, ssm.d_state),
                           dtype=torch.float32, device=device),
    }
