"""Fused activation quantisation (scale → round → clip) — wrapper of the
CUDA kernel ``csrc/quantize.cu``.

Replaces ``src/repro/kernels/quantize.py`` (``_quant_kernel`` /
``quantize``): one pass from float activations to integers, the Quant
node of the streamlined graph (paper §3.2.1) with per-channel or
per-tensor scales.  Bound by bytes.  As in the reference kernel, scale
and zero point are rounded to float32 whatever the type of x, then
promoted.  The plain PyTorch version is ``ref.quantize_ref``; the wrapper
uses it only for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .ref import quantize_ref

_X_KIND = {torch.float32: 0, torch.float64: 1}
_OUT_KIND = {torch.int8: 0, torch.int32: 1}


def work(M: int, C: int, dtype: torch.dtype, out_dtype: torch.dtype,
         n_params: int = 1) -> Tuple[float, float]:
    """(operations, HBM bytes) of one call on x (M, C) with ``n_params``
    scales and zero points (1 or C): a divide, an add, a round and two
    clamps per element; x read once, the float32 scales and zero points
    read once, the output written once.  What a count records for a
    launch and what ``chip_smoke.py`` bounds the kernel's time by."""
    size = dtype.itemsize
    out = out_dtype.itemsize
    return 5.0 * M * C, float(M * C * size + 8 * n_params + M * C * out)


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             *, qmin: int = -128, qmax: int = 127,
             out_dtype=torch.int8) -> torch.Tensor:
    """x (M, C) float32/float64; scale/zero_point (C,) or one entry."""
    if x.dim() != 2:
        raise ValueError(f"quantize: x must be (M, C), got {tuple(x.shape)}")
    if x.dtype not in _X_KIND:
        raise TypeError(f"quantize: x must be float32 or float64, "
                        f"got {x.dtype}")
    M, C = x.shape
    params = []
    for what, t in (("scale", scale), ("zero_point", zero_point)):
        if t.device != x.device:
            raise ValueError(f"quantize: {what} on {t.device}, "
                             f"x on {x.device}")
        t = t.reshape(-1).to(torch.float32).contiguous()
        if t.numel() not in (1, C):
            raise ValueError(f"quantize: {what} has {t.numel()} entries, "
                             f"expected 1 or {C}")
        params.append(t)
    s32, z32 = params
    if s32.numel() != z32.numel():      # one launch argument says which
        s32, z32 = s32.expand(C).contiguous(), z32.expand(C).contiguous()
    qmin, qmax = int(qmin), int(qmax)
    if not _build.on_card(x):
        return quantize_ref(x, s32, z32, qmin=qmin, qmax=qmax,
                            out_dtype=out_dtype)

    if out_dtype not in _OUT_KIND:
        raise TypeError(f"quantize kernel: out_dtype {out_dtype} not "
                        f"supported (int8/int32)")
    if M == 0 or C == 0:
        return torch.empty((M, C), dtype=out_dtype, device=x.device)
    x = x.contiguous()
    out = torch.empty((M, C), dtype=out_dtype, device=x.device)
    if _build.counted("quantize", lambda: work(M, C, x.dtype, out_dtype,
                                               s32.numel()), x):
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.sira_quantize(
            x.data_ptr(), s32.data_ptr(), z32.data_ptr(), out.data_ptr(),
            M, C, int(s32.numel() == C and C > 1), qmin, qmax,
            _X_KIND[x.dtype], _OUT_KIND[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("quantize", err)
    _build.LAUNCH_COUNTS["quantize"] += 1
    return out
