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
on the CPU, where autograd differentiates it.

On the card, a call that needs a gradient goes through
:class:`FlashAttention`: its forward is the same kernel, which then also
writes each query row's log-sum-exp, and its backward is three kernels of
``csrc/flash_attention_bwd.cu`` (D = rowsum(dO·out), dK/dV, dQ; the
tensor-core dK/dV and dQ in ``csrc/flash_attention_bwd_tc.cu`` for
``hd <= 128`` and ``csrc/flash_attention_bwd_tc256.cu`` for
``128 < hd <= 256``), whose plain version is
``ref.flash_attention_bwd_ref``; :func:`grad_tolerance` bounds them
against it.  dK/dV and dQ have two routes, which :func:`route_for` picks
from the type: ``tensor_cores`` (bfloat16/float16: wgmma and TMA, P and
dS rounded to 16 bits before their products) and ``cuda_cores``
(float32: float32 FMAs).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import _build
from .ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                  flash_attention_ref)

TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
#: the routes of the dK/dV and dQ kernels
ROUTES = (TENSOR_CORES, CUDA_CORES)

_KIND = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_BQ = {torch.float32: 64, torch.float16: 128, torch.bfloat16: 128}
MAX_HEAD_DIM = 256
#: half an ulp of one softmax weight P in the 16-bit kernel: the largest
#: relative rounding of P before P·V
P_ROUNDING = {torch.bfloat16: 2.0 ** -9, torch.float16: 2.0 ** -11}
#: the widest head the tensor-core backward takes.  Up to
#: :data:`TC_BWD_SPLIT_HEAD_DIM` each consumer warpgroup of a block owns
#: 64 keys (dK/dV) or 64 query rows (dQ) over the whole head, its
#: accumulators of hd floats a thread in registers
#: (``csrc/flash_attention_bwd_tc.cu``); above it, up to 256 (gemma2's
#: head), the two warpgroups split the head dim instead: a block of 64
#: keys or rows, each warpgroup holding dK and dV (128 floats a thread) or
#: dQ (64) of its 128 columns, P and dS handed between them through
#: shared memory (``csrc/flash_attention_bwd_tc256.cu``)
TC_BWD_MAX_HEAD_DIM = 256
TC_BWD_SPLIT_HEAD_DIM = 128


def _tc_bk(hd: int) -> int:
    """Keys a block of the tensor-core dK/dV kernel for head dim ``hd``."""
    return 128 if hd <= TC_BWD_SPLIT_HEAD_DIM else 64


def route_for(dtype: torch.dtype, hd: int) -> str:
    """The route of the backward's dK/dV and dQ kernels for inputs of
    ``dtype`` and head dim ``hd`` on the card: ``tensor_cores`` for
    bfloat16/float16 with ``hd <= 256`` (:data:`TC_BWD_MAX_HEAD_DIM`; up
    to 128 a block's two warpgroups split its keys or rows, above 128 the
    head dim, since dK and dV of 64 keys x 256 dims would need 256 float32
    registers a thread); ``cuda_cores`` for float32 (exact float32 has no
    tensor-core path, and TF32 would miss the float32 bar of
    :func:`grad_tolerance`) and for heads past 256, which no kernel of the
    backward takes.  Never chosen on failure."""
    if dtype in P_ROUNDING and hd <= TC_BWD_MAX_HEAD_DIM:
        return TENSOR_CORES
    return CUDA_CORES


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True,
                  window: int = 0, q_offset: int = 0) -> int:
    """Query-key pairs the kernels compute: query i sits at position
    ``q_offset + i`` and sees keys at or before it (``causal``) and less
    than ``window`` behind it (``window > 0``), among the ``Sk`` keys."""
    q0, q1, w = int(q_offset), int(q_offset) + int(Sq), int(window)

    def seen(p):                     # keys the query at position p sees
        hi = min(p, Sk - 1) if causal else Sk - 1
        lo = max(p - w + 1, 0) if w else 0
        return max(hi - lo + 1, 0)
    # seen is linear between its kinks (0, Sk, w) and its last zero
    # (Sk + w - 1): each stretch sums as an arithmetic series
    cuts = sorted({q0, q1} | {c for c in (0, Sk, w, Sk + w - 1)
                              if q0 < c < q1})
    return sum((seen(a) + seen(b - 1)) * (b - a) // 2
               for a, b in zip(cuts, cuts[1:]))


def _sizes(q_shape: Sequence[int], k_shape: Sequence[int], dtype):
    B, Sq, H, hd = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    size = dtype.itemsize
    return B, Sq, H, hd, Sk, KV, size


def work(q_shape: Sequence[int], k_shape: Sequence[int], dtype, *,
         causal: bool = True, window: int = 0, q_offset: int = 0,
         lse: bool = False) -> Tuple[float, float]:
    """(operations, HBM bytes) of one forward launch: the two products
    over the pairs :func:`visible_pairs` counts, 4·B·H·hd a pair; q, k, v
    read once, out (and the float32 log-sum-exp, ``lse``) written once,
    no S² traffic.  What a count records for a launch and what
    ``chip_smoke.py`` bounds the kernel's time by."""
    B, Sq, H, hd, Sk, KV, size = _sizes(q_shape, k_shape, dtype)
    pairs = visible_pairs(Sq, Sk, causal=causal, window=window,
                          q_offset=q_offset)
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * size
    return 4.0 * B * H * hd * pairs, float(nbytes + (4 * B * H * Sq
                                                      if lse else 0))


def bwd_work(kernel: str, q_shape: Sequence[int], k_shape: Sequence[int],
             dtype, *, causal: bool = True, window: int = 0,
             q_offset: int = 0) -> Tuple[float, float]:
    """(operations, HBM bytes) of one launch of a backward kernel
    (:data:`BWD_KERNELS`): D = rowsum(dO·out) reads out and dO and writes
    D; dK/dV computes four products of the forward's size (S, dP, dV, dK)
    and dQ three (S, dP, dQ), each reading q, k, v, dO, the log-sum-exp
    and D once and writing its gradients once."""
    B, Sq, H, hd, Sk, KV, size = _sizes(q_shape, k_shape, dtype)
    n, nk = B * Sq * H * hd, B * Sk * KV * hd
    if kernel == BWD_KERNELS[0]:
        return 2.0 * n, float(2 * n * size + 4 * B * H * Sq)
    half = 2.0 * B * H * hd * visible_pairs(
        Sq, Sk, causal=causal, window=window, q_offset=q_offset)
    reads = (2 * n + 2 * nk) * size + 8 * B * H * Sq
    if kernel == BWD_KERNELS[1]:
        return 4.0 * half, float(reads + 2 * nk * size)
    if kernel == BWD_KERNELS[2]:
        return 3.0 * half, float(reads + n * size)
    raise ValueError(f"bwd_work: {kernel!r} is not one of {BWD_KERNELS}")


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


def grad_tolerance(plain: torch.Tensor,
                   magnitude: torch.Tensor = None) -> torch.Tensor:
    """How far, per element, a gradient of the backward kernels (dq, dk or
    dv) may lie from the plain backward's ``plain``
    (``ref.flash_attention_bwd_ref`` on the same inputs, the same ``out``
    and ``lse``), in float64.

    float32: ``2e-5·(|plain| + max|plain|)``.  Both sum the same float32
    products in another order: over the query rows of the whole GQA group
    for dk/dv (24576 terms at S = 4096, g = 6) and over the keys for dq,
    with dS = P·(dP - D) cancelling; the rounding error of such a sum
    grows as the root of its length times the size of its partial sums,
    which the largest gradient bounds: about 5e-6·max|plain| at that
    length.  The relative term covers the products of one element.
    bfloat16/float16: ``ulp(plain)`` plus the float32 term.  The
    ``cuda_cores`` kernels widen the 16-bit inputs and compute every
    product and sum in float32, like the plain backward, and round each
    gradient once: two float32 values that differ by the float32 term
    round to 16-bit values at most one ulp apart.  The forward's rounding
    of P before P·V does not enter: both backwards read the same ``out``
    and ``lse``.

    ``magnitude`` (the ``tensor_cores`` route): the gradient's entry of
    ``ref.flash_attention_bwd_magnitudes``, for which the bar grows by
    ``2·P_ROUNDING·magnitude``.  That route rounds P and dS to the input's
    16-bit type before the products dV = Pᵀ dO, dK = dSᵀ q and dQ = dS k;
    rounding each factor by at most ``P_ROUNDING`` relative moves each
    gradient by at most ``P_ROUNDING`` times the same product of absolute
    values, which the helper returns; the bar allows twice that.  (A
    float16 P or dS below 2^-14 rounds by at most 2^-25 absolutely: the
    float32 term covers that.)"""
    a = plain.double().abs()
    f32 = 2e-5 * (a + (float(a.max()) if a.numel() else 0.0))
    if plain.dtype == torch.float32:
        return f32
    bar = ulp(plain) + f32
    if magnitude is not None:
        bar = bar + 2.0 * P_ROUNDING[plain.dtype] * magnitude.double()
    return bar


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
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
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not _build.on_card(q):
        return
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head dim {hd} > "
                         f"{MAX_HEAD_DIM}")
    if q.dtype != torch.float32 and hd % 8:
        raise ValueError(f"flash_attention kernel: {q.dtype} needs a head "
                         f"dim that is a multiple of 8 (16-byte rows for "
                         f"the tensor-core kernel's copies), got {hd}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous on a 16-byte aligned base (the tensor-core
    kernel's copies need both), else a contiguous copy."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 \
        else t.clone(memory_format=torch.contiguous_format)


def _forward_kernel(q, k, v, causal, window, q_offset, logit_cap,
                    with_lse: bool):
    """One launch of the forward kernel → (out, lse or None); q, k, v
    contiguous and checked."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    _build.check_grid("flash_attention", -(-Sq // _BQ[q.dtype]), B * H)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if _build.counted("flash_attention", lambda: work(
            q.shape, k.shape, q.dtype, causal=causal, window=window,
            q_offset=q_offset, lse=with_lse), q):
        return out, lse
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.sira_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, H, KV, hd, q_offset, window, int(bool(causal)),
            float(logit_cap), hd ** -0.5, _KIND[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", err)
    _build.LAUNCH_COUNTS["flash_attention"] += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        logit_cap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) with H = KV·g → out like q,
    in q's dtype (float32, float16 or bfloat16; scores and softmax in
    float32; on the card, bfloat16/float16 need ``hd % 8 == 0``).

    Query i sits at position ``q_offset + i``; ``causal`` keeps keys at or
    before it, ``window > 0`` keeps keys less than ``window`` behind it;
    ``logit_cap > 0`` applies ``cap·tanh(s/cap)`` to the scores.  On the
    card, a call under grad mode with an input that requires a gradient
    goes through :class:`FlashAttention` (the backward kernels)."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window)
    if not _build.on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, logit_cap=logit_cap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    logit_cap)
    if q.shape[0] * q.shape[1] * q.shape[2] == 0:
        return torch.empty_like(q)
    out, _ = _forward_kernel(_dense(q), _dense(k), _dense(v), causal,
                             window, q_offset, logit_cap, with_lse=False)
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            logit_cap: float = 0.0):
    """The forward with its log-sum-exp: → (out, lse (B, H, Sq) float32),
    what :class:`FlashAttention` saves for the backward (on the card no
    gradient flows through it); the plain versions for CPU tensors."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              logit_cap=logit_cap)
    if not _build.on_card(q):
        return (flash_attention_ref(q, k, v, **kw),
                flash_attention_lse_ref(q, k, **kw))
    if q.shape[0] * q.shape[1] * q.shape[2] == 0:
        return (torch.empty_like(q), torch.empty(
            (q.shape[0], q.shape[2], q.shape[1]), device=q.device))
    with torch.no_grad():
        return _forward_kernel(_dense(q), _dense(k), _dense(v), causal,
                               window, q_offset, logit_cap, with_lse=True)


def _bwd_args(q, k, causal, window, q_offset, logit_cap):
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    return (B, Sq, Sk, H, KV, hd, q_offset, window, int(bool(causal)),
            float(logit_cap), hd ** -0.5, _KIND[q.dtype],
            torch.cuda.current_stream().cuda_stream)


def bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Kernel (a): D = rowsum(dout·out), (B, H, Sq) float32; out and
    dout contiguous CUDA tensors (B, Sq, H, hd) of one type."""
    B, Sq, H, hd = out.shape
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=out.device)
    if _build.counted("flash_attention_bwd_delta", lambda: bwd_work(
            "flash_attention_bwd_delta", out.shape, out.shape, out.dtype),
            out):
        return delta
    with torch.cuda.device(out.device):
        err = _build.load().sira_flash_bwd_delta(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, Sq, H, hd,
            _KIND[out.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention_bwd_delta", err)
    _build.LAUNCH_COUNTS["flash_attention_bwd_delta"] += 1
    return delta


def _bwd_route(q, route):
    """``route``, or :func:`route_for`'s choice when None; raises for a
    route the inputs cannot take."""
    hd = q.shape[3]
    if route is None:
        return route_for(q.dtype, hd)
    if route not in ROUTES:
        raise ValueError(f"flash_attention backward: route {route!r} is "
                         f"not one of {ROUTES}")
    if route == TENSOR_CORES and route_for(q.dtype, hd) != TENSOR_CORES:
        raise ValueError(f"flash_attention backward: the tensor_cores route "
                         f"takes bfloat16/float16 with hd <= "
                         f"{TC_BWD_MAX_HEAD_DIM}, got {q.dtype}, hd {hd}")
    return route


def _count(name, route):
    _build.LAUNCH_COUNTS[name] += 1
    _build.LAUNCH_COUNTS[f"{name}:{route}"] += 1


def _bwd_counted(name, q, k, causal, window, q_offset, route) -> bool:
    return _build.counted(name, lambda: bwd_work(
        name, q.shape, k.shape, q.dtype, causal=causal, window=window,
        q_offset=q_offset), q, route)


def bwd_dkdv(q, k, v, dout, lse, delta, *, causal, window, q_offset,
             logit_cap, route=None):
    """Kernel (b): → (dk, dv) like k, from contiguous CUDA q, k, v, dout
    and the float32 (B, H, Sq) lse and D.  ``route`` (internal: tests and
    measurements) forces one of :data:`ROUTES`; by default
    :func:`route_for` picks it.  On the ``tensor_cores`` route with GQA
    (H > KV) each query head's float32 partials go to a scratch of
    2 x (B, Sk, H, hd), which a second launch sums per group."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    route = _bwd_route(q, route)
    scratch = None
    if route == TENSOR_CORES:
        _build.check_grid("flash_attention_bwd_dkdv", B * H,
                          -(-Sk // _tc_bk(hd)))
        if H != KV:
            scratch = torch.empty((2, B, Sk, H, hd), dtype=torch.float32,
                                  device=q.device)
    else:
        _build.check_grid("flash_attention_bwd_dkdv", 1, B * KV)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _bwd_counted("flash_attention_bwd_dkdv", q, k, causal, window,
                    q_offset, route):
        if scratch is not None:
            # the second launch: the GQA sum of the per-head partials,
            # which the first wrote to the scratch and this one reads
            _build.counted("flash_attention_bwd_dkdv_sum", lambda: (
                float(scratch.numel() - 2 * k.numel()),
                2.0 * scratch.numel() * 4), q, call=False)
        return dk, dv
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    args = _bwd_args(q, k, causal, window, q_offset, logit_cap)
    with torch.cuda.device(q.device):
        lib = _build.load()
        if route == TENSOR_CORES:
            fn = lib.sira_flash_bwd_dkdv_tc \
                if hd <= TC_BWD_SPLIT_HEAD_DIM \
                else lib.sira_flash_bwd_dkdv_tc256
            err = fn(*ptrs, None if scratch is None
                     else scratch.data_ptr(), *args)
        else:
            err = lib.sira_flash_bwd_dkdv(*ptrs, *args)
    _build.check_launch("flash_attention_bwd_dkdv", err)
    _count("flash_attention_bwd_dkdv", route)
    return dk, dv


def bwd_dq(q, k, v, dout, lse, delta, *, causal, window, q_offset,
           logit_cap, route=None):
    """Kernel (c): → dq like q, from the inputs of :func:`bwd_dkdv`;
    ``route`` as there."""
    B, Sq, H, hd = q.shape
    route = _bwd_route(q, route)
    _build.check_grid("flash_attention_bwd_dq", 1, B * H)
    dq = torch.empty_like(q)
    if _bwd_counted("flash_attention_bwd_dq", q, k, causal, window,
                    q_offset, route):
        return dq
    with torch.cuda.device(q.device):
        lib = _build.load()
        if route != TENSOR_CORES:
            fn = lib.sira_flash_bwd_dq
        elif hd <= TC_BWD_SPLIT_HEAD_DIM:
            fn = lib.sira_flash_bwd_dq_tc
        else:
            fn = lib.sira_flash_bwd_dq_tc256
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 *_bwd_args(q, k, causal, window, q_offset, logit_cap))
    _build.check_launch("flash_attention_bwd_dq", err)
    _count("flash_attention_bwd_dq", route)
    return dq


#: the backward's kernels, one launch each per backward
BWD_KERNELS = ("flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        logit_cap: float = 0.0, route=None):
    """→ (dq, dk, dv) in the inputs' types, from the forward's ``out`` and
    ``lse`` (:func:`flash_attention_fwd_lse`) and the output gradient
    ``dout``: three kernel launches on the card (D, dK/dV, dQ; no atomics,
    so the bits repeat), ``ref.flash_attention_bwd_ref`` for CPU
    tensors.  ``route`` (internal: tests and measurements) forces the
    route of dK/dV and dQ (:func:`bwd_dkdv`)."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              logit_cap=logit_cap)
    if not _build.on_card(q):
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]) \
            or lse.dtype != torch.float32:
        raise ValueError(
            f"flash_attention backward: out {out.dtype}{tuple(out.shape)}, "
            f"dout {dout.dtype}{tuple(dout.shape)}, lse "
            f"{lse.dtype}{tuple(lse.shape)} do not fit q "
            f"{q.dtype}{tuple(q.shape)}")
    if q.shape[0] * q.shape[1] * q.shape[2] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q, k, v, out, dout = map(_dense, (q, k, v, out, dout))
    lse = lse.contiguous()
    route = _bwd_route(q, route)
    delta = bwd_delta(out, dout)
    dk, dv = bwd_dkdv(q, k, v, dout, lse, delta, route=route, **kw)
    dq = bwd_dq(q, k, v, dout, lse, delta, route=route, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel (which also writes
    the log-sum-exp) and, for the backward, the three kernels of
    :func:`flash_attention_bwd`.  Handed CPU tensors, it runs the plain
    forward and backward instead.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, logit_cap):
        kw = dict(causal=causal, window=int(window),
                  q_offset=int(q_offset), logit_cap=logit_cap)
        if _build.on_card(q):
            q, k, v = _dense(q), _dense(k), _dense(v)
        out, lse = flash_attention_fwd_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None
