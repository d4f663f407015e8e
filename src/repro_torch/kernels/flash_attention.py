"""Flash attention (forward, GQA, causal / sliding window, soft-cap) —
wrapper of the CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention.py`` (``_fa_kernel`` /
``flash_attention_fwd``) and covers the model's own chunked attention
(``src/repro/models/attention.py flash_attention``): ``window``,
``q_offset`` and lengths that no block divides.  Bound by operations at
the LM prefill's shapes; see the note at the head of the source.  The
plain PyTorch version is ``ref.flash_attention_ref``; the wrapper uses it
only for tensors that lie on the CPU.  There is no backward kernel yet,
so a CUDA input that requires a gradient raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

_KIND = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BQ = 64                  # query rows per thread block in the source
MAX_HEAD_DIM = 256


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) with H = KV·g → out like q,
    in q's dtype (float32, float16 or bfloat16; all arithmetic float32).

    Query i sits at position ``q_offset + i``; ``causal`` keeps keys at or
    before it, ``window > 0`` keeps keys less than ``window`` behind it;
    ``logit_cap > 0`` applies ``cap·tanh(s/cap)`` to the scores."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"(B, Sq, H, hd) and two equal (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree (batch, head dim, or "
                         f"H not a multiple of KV)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KIND:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"float32/float16/bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    window, q_offset = int(window), int(q_offset)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, logit_cap=logit_cap)

    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention kernel: no backward kernel yet (the training "
            "slice's work); run the forward under torch.no_grad()")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    if B * Sq * H == 0:
        return torch.empty_like(q)
    _build.check_grid("flash_attention", -(-Sq // _BQ), B * H)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.sira_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, hd, q_offset, window, int(bool(causal)),
            float(logit_cap), hd ** -0.5, _KIND[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", err)
    _build.LAUNCH_COUNTS["flash_attention"] += 1
    return out
