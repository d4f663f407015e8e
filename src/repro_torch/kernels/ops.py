"""Public wrappers around the CUDA kernels, with the keyword surface of
the reference's ``kernels/ops.py`` (``use_pallas`` → ``use_kernel``; no
block sizes and no ``interpret``: the CUDA kernels bound-check their edges,
so nothing is padded to a block).

The device is taken from the inputs.  ``use_kernel=None`` means "the CUDA
kernel for a tensor on the card, the plain version for a tensor on the
CPU"; ``True`` demands the kernel and raises for a CPU tensor; ``False``
runs the plain version wherever the tensors lie (what a kernel is compared
with).  Nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, ref
from .int_matmul import int_matmul as _int_matmul_kernel
from .multithreshold import infer_out_dtype  # noqa: F401  (re-exported)
from .multithreshold import multithreshold as _multithreshold_kernel
from .quantize import quantize as _quantize_kernel


def _wants_kernel(use_kernel: Optional[bool], x: torch.Tensor,
                  name: str) -> bool:
    if use_kernel and not _build.on_card(x):
        raise RuntimeError(
            f"{name}: use_kernel=True needs tensors on a CUDA device, "
            f"got {x.device}")
    return use_kernel is None or bool(use_kernel)


def _per_channel(v, n: int, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-tensor (size-1) parameter to all n columns."""
    return torch.as_tensor(v, device=like.device).reshape(-1).expand(n)


def int_matmul(x, w, scale=None, bias=None, *, acc_bits: int = 32,
               out_dtype=None, use_kernel: Optional[bool] = None,
               route: Optional[str] = None):
    """``route`` (internal: tests and measurements) forces one of the two
    CUDA kernels; see ``kernels/int_matmul.py``."""
    if _wants_kernel(use_kernel, x, "int_matmul"):
        N = w.shape[1]
        sp = None if scale is None else _per_channel(scale, N, x)
        bp = None if bias is None else _per_channel(bias, N, x)
        return _int_matmul_kernel(x, w, sp, bp, acc_bits=acc_bits,
                                  out_dtype=out_dtype, route=route)
    return ref.int_matmul_ref(x, w, scale, bias, acc_bits=acc_bits,
                              out_dtype=out_dtype)


def multithreshold(x, thresholds, *, out_bias: int = 0, out_dtype=None,
                   use_kernel: Optional[bool] = None,
                   route: Optional[str] = None):
    """``route`` (internal: tests and measurements) forces one of the two
    CUDA kernels; see ``kernels/multithreshold.py``."""
    if _wants_kernel(use_kernel, x, "multithreshold"):
        return _multithreshold_kernel(x, thresholds, out_bias=out_bias,
                                      out_dtype=out_dtype, route=route)
    return ref.multithreshold_ref(x, thresholds, out_bias=out_bias,
                                  out_dtype=out_dtype)


def quantize(x, scale, zero_point, *, qmin: int = -128, qmax: int = 127,
             out_dtype=torch.int8, use_kernel: Optional[bool] = None):
    if _wants_kernel(use_kernel, x, "quantize"):
        return _quantize_kernel(x, torch.as_tensor(scale, device=x.device),
                                torch.as_tensor(zero_point, device=x.device),
                                qmin=qmin, qmax=qmax, out_dtype=out_dtype)
    return ref.quantize_ref(x, scale, zero_point, qmin=qmin, qmax=qmax,
                            out_dtype=out_dtype)
