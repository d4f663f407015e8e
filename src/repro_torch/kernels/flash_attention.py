"""Flash attention (forward, GQA, causal / sliding window, soft-cap) —
wrapper of the CUDA kernels in ``csrc/flash_attention.cu``.

Replaces ``src/repro/kernels/flash_attention.py`` (``_fa_kernel`` /
``flash_attention_fwd``) and covers the model's own chunked attention
(``src/repro/models/attention.py flash_attention``): ``window``,
``q_offset`` and lengths that no block divides.  One launch per call, of
one of two kernels: bfloat16/float16 inputs go to a Hopper tensor-core
kernel (wgmma for both products, TMA loads through an mbarrier ring;
needs ``hd % 8 == 0``), float32 inputs to a CUDA-core kernel (exact
float32 has no tensor-core path).  Both are bound by operations at the LM
prefill's shapes; see the note at the head of the source.  The 16-bit
kernel rounds the softmax weights P to the input's type before ``P·V``,
which :func:`tolerance` bounds.  The plain PyTorch version is
``ref.flash_attention_ref``; the wrapper uses it only for tensors that lie
on the CPU.  There is no backward kernel yet, so a CUDA input that
requires a gradient raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import flash_attention_ref

_KIND = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BQ = {torch.float32: 64, torch.float16: 128, torch.bfloat16: 128}
MAX_HEAD_DIM = 256
#: half an ulp of one softmax weight P in the 16-bit kernel: the largest
#: relative rounding of P before P·V
P_ROUNDING = {torch.bfloat16: 2.0 ** -9, torch.float16: 2.0 ** -11}


def ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 / float16 numbers at |x| (in float64)."""
    bits = {torch.bfloat16: 7, torch.float16: 10}[x.dtype]
    e = torch.floor(torch.log2(x.double().abs().clamp_min(2.0 ** -14)))
    return torch.exp2(e - bits)


def tolerance(plain: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """How far, per element, the kernel's output may lie from the plain
    version's output ``plain`` (float64).

    float32: ``2e-5 + 2e-5·|plain|`` (the sums run in another order).
    bfloat16/float16: ``ulp(plain) + 2·P_ROUNDING·max|v|`` — rounding each
    weight P by at most ``P_ROUNDING`` relative moves the output by at most
    ``P_ROUNDING·max|v|`` (the weights sum to one); twice that, plus one
    ulp for the two roundings of the output."""
    if plain.dtype == torch.float32:
        return 2e-5 + 2e-5 * plain.double().abs()
    vmax = float(v.double().abs().max()) if v.numel() else 0.0
    return ulp(plain) + 2.0 * P_ROUNDING[plain.dtype] * vmax


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) with H = KV·g → out like q,
    in q's dtype (float32, float16 or bfloat16; scores and softmax in
    float32; on the card, bfloat16/float16 need ``hd % 8 == 0``).

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
            "flash_attention kernel: no backward kernel yet (ROADMAP B4); "
            "run the forward under torch.no_grad(), or differentiate on "
            "the CPU, where the plain attention runs")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    if q.dtype != torch.float32 and hd % 8:
        raise ValueError(f"flash_attention kernel: {q.dtype} needs a head "
                         f"dim that is a multiple of 8 (16-byte rows for "
                         f"the tensor-core kernel's copies), got {hd}")
    if B * Sq * H == 0:
        return torch.empty_like(q)
    _build.check_grid("flash_attention", -(-Sq // _BQ[q.dtype]), B * H)
    # contiguous, on 16-byte aligned bases (the tensor-core kernel's
    # copies need them): anything else is copied to fresh storage
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
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
