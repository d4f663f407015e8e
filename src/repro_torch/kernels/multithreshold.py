"""Fused MultiThreshold layer tail (paper §4.1.3/§5.3) — wrapper of the
CUDA kernel ``csrc/multithreshold.cu``.

Replaces ``src/repro/kernels/multithreshold.py`` (``_mt_kernel`` /
``multithreshold``): the dequant → BN → activation → requant elementwise
chain becomes one pass; for each activation x and its channel's sorted
threshold vector T (length N = 2^n_o − 1),

    out = out_bias + sum_i (x >= T_i)

Thresholds are stored transposed (N, C) so the channel index is the
fastest one for x, T and out alike.  Bound by bytes for small N and by the
M·C·N compares at N = 255; see the note at the head of the source.  The
plain PyTorch version is ``ref.multithreshold_ref``; the wrapper uses it
only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from . import _build

_X_KIND = {torch.int32: 0, torch.float32: 1, torch.float64: 2}
_OUT_KIND = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
_COLS_PER_BLOCK = 32     # BC of csrc/multithreshold.cu
_ROWS_PER_BLOCK = 64     # BY * ROWS of csrc/multithreshold.cu


def infer_out_dtype(n_thresholds: int, out_bias: int):
    """Smallest signed dtype that holds every possible output level.

    The count runs over [0, N], so the output range is
    [out_bias, out_bias + N].  A fixed int8 default silently wraps for
    8-bit unsigned tails (out_bias=0, N=255 → count 255 → -1), so the
    dtype must be derived from the actual range (or passed explicitly).
    """
    lo, hi = int(out_bias), int(out_bias) + int(n_thresholds)
    for dt, dmin, dmax in ((torch.int8, -128, 127),
                           (torch.int16, -2**15, 2**15 - 1)):
        if dmin <= lo and hi <= dmax:
            return dt
    return torch.int32


def multithreshold(x: torch.Tensor, thresholds: torch.Tensor, *,
                   out_bias: int = 0, out_dtype=None) -> torch.Tensor:
    """x (M, C) accumulators; thresholds (N, C) ascending per column, same
    dtype as x (int32, float32 or float64).

    Returns out (M, C): out_bias + #{i : x >= T[i, c]} as out_dtype
    (default: derived from the [out_bias, out_bias + N] output range).
    """
    from .ref import multithreshold_ref
    if x.dim() != 2 or thresholds.dim() != 2 or \
            x.shape[1] != thresholds.shape[1]:
        raise ValueError(f"multithreshold: x {tuple(x.shape)} and "
                         f"thresholds {tuple(thresholds.shape)} do not match")
    if x.dtype != thresholds.dtype or x.dtype not in _X_KIND:
        raise TypeError(f"multithreshold: x and thresholds must share one of "
                        f"int32/float32/float64, got {x.dtype} and "
                        f"{thresholds.dtype}")
    if thresholds.device != x.device:
        raise ValueError(f"multithreshold: x on {x.device}, thresholds on "
                         f"{thresholds.device}")
    M, C = x.shape
    N = thresholds.shape[0]
    out_bias = int(out_bias)
    if out_dtype is None:
        out_dtype = infer_out_dtype(N, out_bias)
    if not x.is_cuda:
        return multithreshold_ref(x, thresholds, out_bias=out_bias,
                                  out_dtype=out_dtype)

    if out_dtype not in _OUT_KIND:
        raise TypeError(f"multithreshold kernel: out_dtype {out_dtype} not "
                        f"supported (int8/int16/int32)")
    if M == 0 or C == 0:
        return torch.empty((M, C), dtype=out_dtype, device=x.device)
    _build.check_grid("multithreshold", -(-M // _ROWS_PER_BLOCK),
                      -(-C // _COLS_PER_BLOCK))
    x, thresholds = x.contiguous(), thresholds.contiguous()
    out = torch.empty((M, C), dtype=out_dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.sira_multithreshold(
            x.data_ptr(), thresholds.data_ptr(), out.data_ptr(), M, C, N,
            out_bias, _X_KIND[x.dtype], _OUT_KIND[out_dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("multithreshold", err)
    _build.LAUNCH_COUNTS["multithreshold"] += 1
    return out
