"""Integer matmul with SIRA-minimised accumulation and a fused scale/bias
dequantisation epilogue — wrapper of the CUDA kernels
``csrc/int_matmul.cu``.

Replaces ``src/repro/kernels/int_matmul.py`` (``_matmul_kernel`` /
``int_matmul``).  Two kernels compute the function on the card, bit for
bit alike: int8 operands on the tensor cores (``wgmma`` with TMA loads),
and a CUDA-core kernel for int32 operands and for the shapes where the
tensor cores do not pay.  :func:`route_for` picks one from the shape and
the operand type alone; see the note at the head of the
source for the designs and the arithmetic contract.  The plain PyTorch
version is ``ref.int_matmul_ref``; the wrapper uses it only for tensors
that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .ref import int_matmul_ref

TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
ROUTES = (TENSOR_CORES, CUDA_CORES)

_IN_KIND = {torch.int8: 0, torch.int32: 1}
_OUT_KIND = {torch.int16: 0, torch.int32: 1, torch.float32: 2}
_ROUTE_CODE = {CUDA_CORES: 0, TENSOR_CORES: 1}
_TILE = 64               # BM = BN of the CUDA-core kernel
#: the CUDA cores keep int8 products this shallow and this small (below)
SHALLOW_K = 32
SMALL_OUT = 1 << 19


def route_for(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel that computes an (M, K) @ (K, N) product on the card.

    int32 operands have no tensor-core path.  int8 operands go to the
    tensor cores, except a product that one 32-byte MMA step finishes
    (K <= 32) with at least 16 output columns and a small output
    (M * N <= 2^19): there a tensor-core launch, whose TMA load, MMA and
    staged store of one tile per block take 3-5 us, loses 0.3-0.8 us to
    the CUDA cores.  The tensor cores win or tie at every other main-path
    call, the 48 depthwise (16384, 9, 1) groups of MobileNet included
    (times of both kernels at every main-path call on an H100: PERF.md,
    ``chip_smoke.py`` ``kernel_times``).  Whether x's rows lie on 16-byte
    boundaries (TMA loads them) or not (a bulk copy does) moved no
    main-path call across the line, so alignment plays no part.  Never
    chosen on failure.
    """
    if dtype != torch.int8 or K == 0:
        return CUDA_CORES
    if K <= SHALLOW_K and N >= 16 and M * N <= SMALL_OUT:
        return CUDA_CORES
    return TENSOR_CORES


def work(M: int, K: int, N: int, dtype: torch.dtype,
         out_dtype: torch.dtype, *, scale: bool = False,
         bias: bool = False) -> Tuple[float, float]:
    """(operations, HBM bytes) of one (M, K) @ (K, N) call: 2·M·K·N
    multiply-adds; x and w read once, the output written once, the
    float32 scale and bias read once.  What a count records for a launch
    and what ``chip_smoke.py`` bounds the kernel's time by."""
    size = dtype.itemsize
    out = out_dtype.itemsize
    nbytes = (M * K + K * N) * size + M * N * out + 4 * N * (int(scale)
                                                           + int(bias))
    return 2.0 * M * K * N, float(nbytes)


def is_k_major(w: torch.Tensor) -> bool:
    """``w`` (K, N) is a view the tensor-core kernel reads without a copy:
    each of its N columns contiguous along K, on a 16-byte boundary and
    16 bytes apart (a multiple)."""
    K, N = w.shape
    size = w.element_size()
    pitch = w.stride(1)
    return ((K <= 1 or w.stride(0) == 1) and pitch >= K
            and (pitch * size) % 16 == 0 and w.data_ptr() % 16 == 0)


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` (K, N) as a (K, N) view of an (N, K) matrix with rows padded
    to 16 bytes (zeros past K): the layout the tensor-core kernel reads.
    Returns ``w`` itself when it already is such a view; else copies it
    once.  ``core/lower.py`` stores every int8 weight this way when it
    lowers a model, so no call of the main path copies a weight."""
    if is_k_major(w):
        return w
    K, N = w.shape
    per = 16 // w.element_size()
    pitch = max(per, -(-K // per) * per)
    buf = torch.zeros((N, pitch), dtype=w.dtype, device=w.device)
    buf[:, :K] = w.T
    return buf[:, :K].T


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
               acc_bits: int = 32, out_dtype=None,
               route: Optional[str] = None, stages: int = 0
               ) -> torch.Tensor:
    """x (M, K) @ w (K, N), both int8 or both int32 → int accumulate →
    optional dequant.

    acc_bits: SIRA-minimised accumulator width; ≤15 wraps the sum to int16.
    scale/bias: per-output-channel (N,) aggregated layer-tail parameters;
    if ``scale`` is given the output is float32 (dequantised), else the raw
    accumulator as int16 (narrow) or int32.
    route: internal, for tests and measurements: force one kernel
    (``"tensor_cores"`` or ``"cuda_cores"``) instead of
    :func:`route_for`'s choice; a shape the forced kernel cannot take
    raises.  stages: internal, the tensor-core kernel's ring depth
    (0 = four, or as many as fit).
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
    if route is not None and route not in ROUTES:
        raise ValueError(f"int_matmul: route {route!r} is not one of "
                         f"{ROUTES}")
    M, K = x.shape
    N = w.shape[1]
    narrow = acc_bits <= 15
    if out_dtype is None:
        out_dtype = torch.float32 if scale is not None else \
            (torch.int16 if narrow else torch.int32)
    if scale is not None:
        scale = _vec(scale, N, "scale", x)
        bias = None if bias is None else _vec(bias, N, "bias", x)
    if not _build.on_card(x):
        if route is not None:
            raise RuntimeError(f"int_matmul: route {route!r} needs tensors "
                               f"on a CUDA device, got {x.device}")
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
    # rows of x with unit stride, at least K apart
    if (K > 1 and x.stride(1) != 1) or (M > 1 and x.stride(0) < K):
        x = x.contiguous()
    ldx = x.stride(0) if M > 1 else K
    if route is None:
        route = route_for(M, K, N, x.dtype)
    if route == TENSOR_CORES:
        if x.dtype != torch.int8 or K == 0:
            raise ValueError(
                f"int_matmul: the tensor-core kernel takes int8 operands "
                f"and K >= 1, got {x.dtype} ({M}x{K}x{N})")
        w = k_major(w)
        wsk, wsn = 1, w.stride(1)
    else:
        _build.check_grid("int_matmul", -(-M // _TILE), -(-N // _TILE))
        wsk, wsn = w.stride()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if _build.counted("int_matmul", lambda: work(
            M, K, N, x.dtype, out_dtype, scale=dequant,
            bias=bias is not None), x, route):
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.sira_int_matmul(
            x.data_ptr(), w.data_ptr(),
            scale.data_ptr() if dequant else None,
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), M, K, N, ldx, wsk, wsn, _IN_KIND[x.dtype],
            _OUT_KIND[out_dtype], int(narrow), _ROUTE_CODE[route],
            int(stages), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("int_matmul", err)
    _build.LAUNCH_COUNTS["int_matmul"] += 1
    _build.LAUNCH_COUNTS[f"int_matmul:{route}"] += 1
    return out
