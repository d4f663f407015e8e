"""Fused MultiThreshold layer tail (paper §4.1.3/§5.3) — wrapper of the
CUDA kernels ``csrc/multithreshold.cu``.

Replaces ``src/repro/kernels/multithreshold.py`` (``_mt_kernel`` /
``multithreshold``): the dequant → BN → activation → requant elementwise
chain becomes one pass; for each activation x and its channel's sorted
threshold vector T (length N = 2^n_o − 1),

    out = out_bias + sum_i (x >= T_i)

Thresholds are stored transposed (N, C) so the channel index is the
fastest one for x, T and out alike.  Two kernels compute the function on
the card, bit for bit alike: a compare-count (bound by bytes at small N)
and a per-column binary search (for large N, where N compares per element
would bound the count by integer issue).  :func:`route_for` picks one
from the shape and type alone; see the note at the head of the source.
The plain PyTorch version is ``ref.multithreshold_ref``; the wrapper uses
it only for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_X_KIND = {torch.int32: 0, torch.float32: 1, torch.float64: 2}
_OUT_KIND = {torch.int8: 0, torch.int16: 1, torch.int32: 2}

COMPARE_COUNT = "compare_count"
SEARCH = "search"
ROUTES = (COMPARE_COUNT, SEARCH)
_ROUTE_CODE = {COMPARE_COUNT: 0, SEARCH: 1}
#: columns per tile (grid y) of csrc/multithreshold.cu, and the pitch of
#: the search route's threshold slab; grid x is a persistent grid the
#: launcher sizes to the SMs
_TILE_COLS = 32
#: shared memory one block may use on an H100 (the search route's slab)
_MAX_SLAB_BYTES = 227 * 1024
#: the search route from this many thresholds on
SEARCH_FROM_N = 16


def slab_bytes(n_thresholds: int, dtype: torch.dtype) -> int:
    """Shared memory of the search route's slab: 2^k - 1 rows (the least
    that hold N thresholds) of 32 columns."""
    rows = (1 << int(n_thresholds).bit_length()) - 1
    return rows * _TILE_COLS * (8 if dtype == torch.float64 else 4)


def route_for(M: int, C: int, N: int, dtype: torch.dtype) -> str:
    """The kernel that computes a multithreshold of x (M, C) against N
    thresholds on the card: the compare-count below ``SEARCH_FROM_N``
    thresholds, the search from there on where its slab fits a block.

    On an H100 (``chip_smoke.py`` ``kernel_times`` sweeps both routes over
    N = 3..255; the table is in PERF.md) the count wins at N <= 7, the
    search from N = 31 on, by several times.  At N = 15 the two are
    within 10% of each other: the search ahead at the large int32 shapes,
    the count at float64 and at the main path's N = 15 tails (MobileNet's
    16384 x 8/16/32, where one step of a 1024-thread search block does
    not pay for its slab), so the count keeps N = 15.  Never chosen on
    failure."""
    if N >= SEARCH_FROM_N and slab_bytes(N, dtype) <= _MAX_SLAB_BYTES:
        return SEARCH
    return COMPARE_COUNT


def work(M: int, C: int, N: int, dtype: torch.dtype,
         out_dtype: torch.dtype) -> Tuple[float, float]:
    """(operations, HBM bytes) of one call on x (M, C) against N
    thresholds: x and T read once, the output written once; the compares
    of a binary search, M·C·ceil(log2(N + 1)) (the least work of the
    function, not the M·C·N of a linear count).  What a count records for
    a launch and what ``chip_smoke.py`` bounds the kernel's time by."""
    size = dtype.itemsize
    out = out_dtype.itemsize
    return (float(M) * C * int(N).bit_length(),
            float(M * C * size + N * C * size + M * C * out))


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
                   out_bias: int = 0, out_dtype=None,
                   route: Optional[str] = None) -> torch.Tensor:
    """x (M, C) accumulators; thresholds (N, C) ascending per column, same
    dtype as x (int32, float32 or float64).

    Returns out (M, C): out_bias + #{i : x >= T[i, c]} as out_dtype
    (default: derived from the [out_bias, out_bias + N] output range).
    ``route`` (internal: tests and measurements) forces one of
    :data:`ROUTES`; by default :func:`route_for` picks it.
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
    if route is not None and route not in ROUTES:
        raise ValueError(f"multithreshold: route {route!r} is not one of "
                         f"{ROUTES}")
    if route == SEARCH and slab_bytes(N, x.dtype) > _MAX_SLAB_BYTES:
        raise ValueError(f"multithreshold search route: the slab of N = {N} "
                         f"{x.dtype} thresholds exceeds one block's shared "
                         f"memory")
    out_bias = int(out_bias)
    if out_dtype is None:
        out_dtype = infer_out_dtype(N, out_bias)
    if not _build.on_card(x):
        return multithreshold_ref(x, thresholds, out_bias=out_bias,
                                  out_dtype=out_dtype)

    if out_dtype not in _OUT_KIND:
        raise TypeError(f"multithreshold kernel: out_dtype {out_dtype} not "
                        f"supported (int8/int16/int32)")
    if M == 0 or C == 0:
        return torch.empty((M, C), dtype=out_dtype, device=x.device)
    if route is None:
        route = route_for(M, C, N, x.dtype)
    # grid x is capped by the launcher; grid y is one block column per tile
    _build.check_grid("multithreshold", 1, -(-C // _TILE_COLS))
    x, thresholds = x.contiguous(), thresholds.contiguous()
    out = torch.empty((M, C), dtype=out_dtype, device=x.device)
    if _build.counted("multithreshold",
                      lambda: work(M, C, N, x.dtype, out_dtype),
                      x, route):
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.sira_multithreshold(
            x.data_ptr(), thresholds.data_ptr(), out.data_ptr(), M, C, N,
            out_bias, _X_KIND[x.dtype], _OUT_KIND[out_dtype],
            _ROUTE_CODE[route], torch.cuda.current_stream().cuda_stream)
    _build.check_launch("multithreshold", err)
    _build.LAUNCH_COUNTS["multithreshold"] += 1
    _build.LAUNCH_COUNTS[f"multithreshold:{route}"] += 1
    return out
