"""GQA attention: prefill through the flash-attention kernel, KV-cached
decode in plain PyTorch.

Counterpart of ``src/repro/models/attention.py``: grouped KV heads, RoPE,
optional QKV bias, logit soft-capping (gemma2), sliding-window masking for
local layers.  The reference's prefill is an online-softmax scan over KV
chunks; here every prefill attention call goes to ``flash_attention``,
the wrapper of the CUDA kernel (its plain version for CPU tensors); when
the call needs a gradient, the wrapper's autograd function adds the
backward kernels.  The reference's ``chunk`` only orders the reduction
and has no counterpart.
Decode has no kernel in the reference either and stays plain PyTorch; it
writes the new key/value into the cache **in place** and returns the same
cache.  ``paged_attention`` (the serving path, ``serve/engine.py``) is
plain PyTorch as in the reference, and writes its page pools in place.
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
    y = linear(out.reshape(B, S, n_heads * hd), params["wo"], quant=quant,
               row_split=True)
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
    y = linear(out, params["wo"], quant=quant, row_split=True)
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


def paged_attention(params, x, k_pages, v_pages, page_table, lengths, *,
                    n_heads, n_kv, hd, theta, page_size,
                    logit_cap=0.0, quant=None, k_scale=None, v_scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token attention against a paged KV cache.

    One function covers all three serving phases: chunked prefill is a
    call with B=1, T=chunk; batched decode is B=slots, T=1; speculative
    verification is B=slots, T=spec_k+1, each slot's window at its own
    offset ``lengths[b]``.  The position mask makes token t attend exactly
    to the cache plus the tokens before it in the window, so
    ``logits[:, t]`` equals what t sequential single-token calls give.

      x          (B, T, d)    chunk of new tokens per slot
      k_pages    (P, page_size, KV, hd)   shared physical page pool
      v_pages    (P, page_size, KV, hd)   (int8: scaled-integer storage)
      page_table (B, n_pages) int physical page per logical page; page 0
                 is the trash page (idle slots write there, never read live)
      lengths    (B,) tokens already cached per slot; the chunk occupies
                 logical positions [lengths[b], lengths[b] + T)

    The chunk's K/V are written (quantized if the pool is int8) into the
    pools **in place**, *before* the read, so queries attend to the same
    storage round trip the next step will see; keys at k_pos <= own
    position (causal within the chunk falls out of the position mask).
    Dequantization is folded into the query scaling (K) and the PV output
    (V), per KV head.  Returns (y, k_pages, v_pages), the pools the same
    tensors that were passed.

    Scatter-before-gather is also the speculative-rollback contract: a
    rejected draft's K/V stay in the pool as garbage past the slot's
    committed length, unreadable (every mask is position <= query, and
    queries never precede the length pointer) until the next call's
    scatter overwrites them; rolling back is just not advancing the
    pointer (``serve/kv_cache.py rollback``).
    """
    B, T, _ = x.shape
    table = page_table.to(device=x.device, dtype=torch.long)
    n_pages = table.shape[1]
    S_v = n_pages * page_size
    positions = lengths.to(device=x.device, dtype=torch.long)[:, None] + \
        torch.arange(T, device=x.device)[None, :]                # (B, T)
    q, k, v = _qkv(params, x, n_heads, n_kv, hd, positions, theta, quant)

    int_cache = k_pages.dtype == torch.int8
    if int_cache:
        k_st, v_st = quantize_kv(k, k_scale), quantize_kv(v, v_scale)
    else:
        k_st = k.to(k_pages.dtype)
        v_st = v.to(v_pages.dtype)

    # scatter the chunk into its pages: position p lives in physical page
    # table[b, p // page_size] at row p % page_size.  Positions past the
    # table (the pad tail of a prefill chunk at max_seq) go to the trash
    # page: an indexed gather would clamp them onto the last live page and
    # corrupt it.  Several rows may write trash page 0, row 0, in one call
    # (idle slots, pad tails), and which write lands is undefined on CUDA;
    # that is harmless only because page 0 is never read at a live
    # position: the cache never maps it to a slot.
    in_range = positions < S_v
    page_ids = torch.gather(
        table, 1, torch.where(in_range, positions // page_size, 0))
    page_ids = torch.where(in_range, page_ids, 0)                # (B, T)
    offs = torch.where(in_range, positions % page_size, 0)
    flat_p, flat_o = page_ids.reshape(-1), offs.reshape(-1)
    k_pages.index_put_((flat_p, flat_o), k_st.reshape(B * T, n_kv, hd))
    v_pages.index_put_((flat_p, flat_o), v_st.reshape(B * T, n_kv, hd))

    # gather each slot's logical view (trash and garbage rows masked below)
    kc = k_pages[table].reshape(B, S_v, n_kv, hd).to(torch.float32)
    vc = v_pages[table].reshape(B, S_v, n_kv, hd).to(torch.float32)

    groups = n_heads // n_kv
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(B, T, n_kv, groups, hd)
    if int_cache:  # fold K's dequantization into q, per KV head
        qf = qf * _head_scale(k_scale, n_kv, x.device)
    s = torch.einsum("btkgh,bskh->btkgs", qf, kc)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(S_v, device=x.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]        # (B, T, S_v)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("btkgs,bskh->btkgh", p, vc)
    if int_cache:
        out = out * _head_scale(v_scale, n_kv, x.device)
    out = out.reshape(B, T, n_heads * hd).to(x.dtype)
    y = linear(out, params["wo"], quant=quant, row_split=True)
    return y, k_pages, v_pages


def _head_scale(scale, n_kv: int, device) -> torch.Tensor:
    """A per-KV-head (KV,) scale as float32, shaped to scale (B, T, KV,
    groups, hd)."""
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=device).reshape(1, 1, n_kv, 1, 1)
