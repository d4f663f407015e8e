"""Integer matmul with SIRA-minimised accumulation and a fused scale/bias
dequantisation epilogue — wrapper of the CUDA kernel
``csrc/int_matmul.cu``.

Replaces ``src/repro/kernels/int_matmul.py`` (``_matmul_kernel`` /
``int_matmul``).  The kernel is bound by bytes at the main path's shapes
(tall-skinny im2col products and tiny dense layers); see the note at the
head of the source for the design and the arithmetic contract.  The plain
PyTorch version is ``ref.int_matmul_ref``; the wrapper uses it only for
tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import int_matmul_ref

_IN_KIND = {torch.int8: 0, torch.int32: 1}
_OUT_KIND = {torch.int16: 0, torch.int32: 1, torch.float32: 2}
_TILE = 64               # BM = BN of csrc/int_matmul.cu


def _vec(t: torch.Tensor, n: int, what: str, like: torch.Tensor
         ) -> torch.Tensor:
    if t.device != like.device:
        raise ValueError(f"{what} lies on {t.device}, x on {like.device}")
    t = t.reshape(-1).to(torch.float32)
    if t.numel() != n:
        raise ValueError(f"{what} has {t.numel()} entries, expected {n}")
    return t.contiguous()


def int_matmul(x: torch.Tensor, w: torch.Tensor,
               scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *,
               acc_bits: int = 32, out_dtype=None) -> torch.Tensor:
    """x (M, K) @ w (K, N), both int8 or both int32 → int accumulate →
    optional dequant.

    acc_bits: SIRA-minimised accumulator width; ≤15 wraps the sum to int16.
    scale/bias: per-output-channel (N,) aggregated layer-tail parameters;
    if ``scale`` is given the output is float32 (dequantised), else the raw
    accumulator as int16 (narrow) or int32.
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply")
    if x.dtype != w.dtype or x.dtype not in _IN_KIND:
        raise TypeError(f"int_matmul: operands must both be int8 or both "
                        f"int32, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"int_matmul: x on {x.device}, w on {w.device}")
    if bias is not None and scale is None:
        raise ValueError("int_matmul: a bias needs a scale")
    M, K = x.shape
    N = w.shape[1]
    narrow = acc_bits <= 15
    if out_dtype is None:
        out_dtype = torch.float32 if scale is not None else \
            (torch.int16 if narrow else torch.int32)
    if scale is not None:
        scale = _vec(scale, N, "scale", x)
        bias = None if bias is None else _vec(bias, N, "bias", x)
    if not x.is_cuda:
        return int_matmul_ref(x, w, scale, bias, acc_bits=acc_bits,
                              out_dtype=out_dtype)

    dequant = scale is not None
    if out_dtype not in _OUT_KIND or \
            dequant != (out_dtype == torch.float32):
        raise TypeError(
            f"int_matmul kernel: out_dtype {out_dtype} not supported "
            f"{'with' if dequant else 'without'} a scale (float32 with, "
            f"int16/int32 without)")
    if M == 0 or N == 0:
        return torch.empty((M, N), dtype=out_dtype, device=x.device)
    _build.check_grid("int_matmul", -(-M // _TILE), -(-N // _TILE))
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.sira_int_matmul(
            x.data_ptr(), w.data_ptr(),
            scale.data_ptr() if dequant else None,
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), M, K, N, _IN_KIND[x.dtype],
            _OUT_KIND[out_dtype], int(narrow),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("int_matmul", err)
    _build.LAUNCH_COUNTS["int_matmul"] += 1
    return out
