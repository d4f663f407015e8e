"""GQA attention: prefill through the flash-attention kernel, KV-cached
decode in plain PyTorch.

Counterpart of ``src/repro/models/attention.py``: grouped KV heads, RoPE,
optional QKV bias, logit soft-capping (gemma2), sliding-window masking for
local layers.  The reference's prefill is an online-softmax scan over KV
chunks; here every prefill attention call goes to ``flash_attention``,
the wrapper of the CUDA kernel (its plain version for CPU tensors).  The
reference's ``chunk`` only orders the reduction and has no counterpart.
Decode has no kernel in the reference either and stays plain PyTorch; it
writes the new key/value into the cache **in place** and returns the same
cache.  ``paged_attention`` is not ported yet (serving).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention_fwd as flash_attention
from ..kernels.ref import NEG_INF
from .common import apply_rope, dense_init, linear

# int8 KV-cache scale (SIRA-style scaled-integer cache): k/v values are
# stored as round(x / KV_SCALE) in int8
KV_SCALE = 1.0 / 16.0


def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   hd: int, qkv_bias: bool, dtype) -> Dict[str, Any]:
    p = {
        "wq": dense_init(gen, (d, n_heads * hd), dtype=dtype),
        "wk": dense_init(gen, (d, n_kv * hd), dtype=dtype),
        "wv": dense_init(gen, (d, n_kv * hd), dtype=dtype),
        "wo": dense_init(gen, (n_heads * hd, d),
                         scale=(n_heads * hd) ** -0.5, dtype=dtype),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads * hd), ("bk", n_kv * hd),
                            ("bv", n_kv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=gen.device)
    return p


def _qkv(params, x, n_heads, n_kv, hd, positions, theta, quant=None):
    B, S, _ = x.shape
    q = linear(x, params["wq"], params.get("bq"), quant)
    k = linear(x, params["wk"], params.get("bk"), quant)
    v = linear(x, params["wv"], params.get("bv"), quant)
    q = apply_rope(q.reshape(B, S, n_heads, hd), positions, theta)
    k = apply_rope(k.reshape(B, S, n_kv, hd), positions, theta)
    return q, k, v.reshape(B, S, n_kv, hd)


def attention_prefill(params, x, *, n_heads, n_kv, hd, theta,
                      qkv_bias=False, logit_cap=0.0, window=0, quant=None,
                      return_kv=False):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(params, x, n_heads, n_kv, hd, positions, theta, quant)
    out = flash_attention(q, k, v, causal=True, window=window,
                          logit_cap=logit_cap)
    y = linear(out.reshape(B, S, n_heads * hd), params["wo"], quant=quant)
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(params, x, cache: Dict[str, torch.Tensor],
                     cache_index: int, *, n_heads, n_kv, hd, theta,
                     qkv_bias=False, logit_cap=0.0, window=0, quant=None,
                     rolling: bool = False,
                     valid_from: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode against a (B, S_max, KV, hd) cache, written in
    place at ``cache_index``.

    rolling=True treats the cache as a circular buffer of length S_max
    (sliding-window local attention): writes go to ``index mod S_max``;
    once the buffer has wrapped, every slot is a valid in-window key.

    valid_from (B,) marks each row's first valid cache slot (left-padded
    prompts); earlier slots are masked out and RoPE positions shifted per
    row.  Not supported for rolling caches."""
    B, S1, _ = x.shape  # S1 == 1
    S_max = cache["k"].shape[1]
    idx = int(cache_index)
    if valid_from is not None and rolling:
        raise NotImplementedError("valid_from with a rolling cache")
    if valid_from is None:
        positions = torch.full((B, S1), idx, device=x.device)
    else:
        positions = torch.clamp(idx - valid_from, min=0)[:, None]
    q, k, v = _qkv(params, x, n_heads, n_kv, hd, positions, theta, quant)
    # the reference's dynamic_update_slice clamps the slot into the buffer
    slot = idx % S_max if rolling else min(max(idx, 0), S_max - 1)
    int_cache = cache["k"].dtype == torch.int8
    if int_cache:
        k_st = torch.clamp(torch.round(k.to(torch.float32) / KV_SCALE),
                           -127, 127).to(torch.int8)
        v_st = torch.clamp(torch.round(v.to(torch.float32) / KV_SCALE),
                           -127, 127).to(torch.int8)
    else:
        k_st, v_st = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    cache["k"][:, slot:slot + S1] = k_st
    cache["v"][:, slot:slot + S1] = v_st
    kv_deq = KV_SCALE if int_cache else 1.0
    groups = n_heads // n_kv
    qf = (q.to(torch.float32) * hd ** -0.5 * kv_deq).reshape(
        B, S1, n_kv, groups, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qf,
                     cache["k"].to(torch.float32))
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(S_max, device=x.device)
    mask = k_pos <= idx
    if rolling:
        mask = mask | (idx >= S_max)
    if window:
        mask &= k_pos > idx - window
    if valid_from is not None:
        mask = mask[None, :] & (k_pos[None, :] >= valid_from[:, None])
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    else:
        s = torch.where(mask[None, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskh->bqkgh", p,
                       cache["v"].to(torch.float32) * kv_deq)
    out = out.reshape(B, S1, n_heads * hd).to(x.dtype)
    y = linear(out, params["wo"], quant=quant)
    return y, cache


def init_kv_cache(batch: int, s_max: int, n_kv: int, hd: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros((batch, s_max, n_kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, s_max, n_kv, hd), dtype=dtype,
                             device=device)}


def quantize_kv(x: torch.Tensor, scale) -> torch.Tensor:
    """Scaled-integer KV storage: round(x / scale) saturated to int8, with
    a per-KV-head (KV,) ``scale``."""
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=x.device).reshape(1, 1, -1, 1)
    q = torch.round(x.to(torch.float32) / s)
    return torch.clamp(q, -127, 127).to(torch.int8)
