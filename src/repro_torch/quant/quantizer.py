"""Uniform affine quantizers in PyTorch (paper §2.1/§2.3; Brevitas-analog).

Counterpart of ``src/repro/quant/quantizer.py``: arbitrary bitwidth,
signed/unsigned, narrow range, per-tensor / per-channel / per-group scale
granularity, float or power-of-two (PoT) scales, zero-points, and
straight-through-estimator (STE) fake quantization.  Forward values equal
the reference's expression for expression (the STE is written
``x_c + (y - x_c).detach()``, the same sum the reference rounds).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..kernels.ref import _int_dot


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 8
    signed: bool = True
    narrow: bool = False
    granularity: str = "per_tensor"   # per_tensor | per_channel | per_group
    channel_axis: int = -1
    group_size: int = 32
    pot: bool = False                 # power-of-two scale restriction
    symmetric: bool = True            # zero_point == 0
    rounding: str = "nearest"         # nearest | toward_zero

    @property
    def qmin(self) -> int:
        if self.signed:
            return -(2 ** (self.bits - 1)) + (1 if self.narrow else 0)
        return 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1


def _reduce_axes(x: torch.Tensor, spec: QuantSpec) -> Tuple[int, ...]:
    if spec.granularity == "per_tensor":
        return tuple(range(x.dim()))
    ax = spec.channel_axis % x.dim()
    return tuple(i for i in range(x.dim()) if i != ax)


def times_reciprocal(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` as XLA compiles a division by a constant: ``t`` times the
    reciprocal of ``n`` rounded to float32 (float64 for a float64 ``t``),
    in that precision (a bf16 ``t`` is widened first), rounded once to
    ``t``'s dtype.  Not the IEEE quotient: the two differ in the last
    bit for some ``t``."""
    wide = torch.float64 if t.dtype == torch.float64 else torch.float32
    inv = float(1.0 / torch.tensor(float(n), dtype=wide))
    return (t.to(wide) * inv).to(t.dtype)


# ln 2 split for an exact reduction: ``n * LN2_HI`` is exact for |n| < 2**21.
LN2_HI = 0.693147180369123816490
LN2_LO = 1.90821492927058770002e-10


def pot_scale(s: torch.Tensor) -> torch.Tensor:
    """``exp2(ceil(log2(s)))`` as XLA compiles the reference's
    ``jnp.exp2(jnp.ceil(jnp.log2(s)))`` on the CPU, bit for bit.

    ``log2`` is ``log(s) / log(2)`` with ``log(2)`` rounded to ``s``'s
    dtype, the division a product with that constant's reciprocal, and
    ``exp2(n)`` is ``exp(n * log(2))``.  Each op runs in float32 (float64
    for float64) and is rounded to ``s``'s dtype after it, as XLA widens
    bf16 and float16; float16's reciprocal is a float16 constant.  XLA's
    ``exp`` is correctly rounded at these points and the installed
    ``torch.exp`` is not always (float32 ``n = 32``, float64 ``n = -27``),
    so float32 takes ``exp`` in float64, and float64 reduces
    ``n * log(2)`` exactly and scales ``1 + r`` by ``2**n``.  Subnormal
    inputs and results of the widened dtype are flushed to zero, as
    XLA's CPU code does.  The result is not always a power of two (float32
    ``exp(32 * log(2))`` is ``2**32 + 512``)."""
    dt = s.dtype
    wide = torch.float64 if dt == torch.float64 else torch.float32
    tiny = torch.finfo(wide).tiny
    s = torch.where(s.to(wide).abs() < tiny, torch.zeros_like(s), s)
    ln2 = torch.tensor(math.log(2.0), dtype=torch.float64).to(dt).to(wide)
    inv = (torch.tensor(1.0, dtype=wide) / ln2).to(
        torch.float16 if dt == torch.float16 else wide)
    lg = torch.log(s.to(wide)).to(dt)
    n = torch.ceil((lg.to(wide) * float(inv)).to(dt))
    x = (n.to(wide) * float(ln2)).to(dt).double()
    if dt == torch.float64:
        fin = torch.isfinite(n)
        k = torch.where(fin, n, torch.zeros_like(n))
        r = (x - k * LN2_HI) - k * LN2_LO
        y = torch.where(fin, (1.0 + r) * torch.exp2(k - 1) * 2.0,
                        torch.exp(x))
    else:
        y = torch.exp(x).to(wide)
    return torch.where(y.abs() < tiny, torch.zeros_like(y), y).to(dt)


def compute_scale(x: torch.Tensor, spec: QuantSpec, eps: float = 1e-8,
                  amax: Optional[Callable[[torch.Tensor], torch.Tensor]]
                  = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max calibration → (scale, zero_point), broadcastable to x.

    ``amax``, when given, maps each max this rank reduced (and each
    negated min) to the max over the ranks that hold the rest of the
    reduced dims (``Layout.max``): the scale of the whole tensor when
    ``x`` is a rank's block of it.

    Each scale is taken as the reference's is where it runs compiled
    (its layers run under a scan): XLA turns ``amax / qmax`` into a
    float32 product with the float32 reciprocal of ``qmax``, so the
    scale is ``top * float32(1 / qmax)`` in float32, cast once to ``x``'s
    dtype (:func:`times_reciprocal`).  The zero point keeps its
    division, as the compiled reference does, and a power-of-two scale
    is :func:`pot_scale`'s."""
    amax = amax or (lambda t: t)
    if spec.granularity == "per_group":
        ax = spec.channel_axis % x.dim()
        g = spec.group_size
        shp = list(x.shape)
        if shp[ax] % g:
            raise ValueError("group_size must divide the channel dim")
        xg = torch.movedim(x, ax, -1).reshape(-1, shp[ax] // g, g)
        top = amax(xg.abs().amax(dim=(0, 2), keepdim=True))      # (1, G, 1)
        s = torch.clamp(times_reciprocal(top, spec.qmax), min=eps)
        s = s.expand(1, shp[ax] // g, g).reshape(shp[ax])
        shape = [1] * x.dim()
        shape[ax] = shp[ax]
        s = s.reshape(shape)
        z = torch.zeros_like(s)
    elif spec.symmetric:
        axes = _reduce_axes(x, spec)
        top = amax(x.abs().amax(dim=axes, keepdim=True))
        s = torch.clamp(times_reciprocal(top, spec.qmax), min=eps)
        z = torch.zeros_like(s)
    else:
        axes = _reduce_axes(x, spec)
        x_lo = -amax(-x.amin(dim=axes, keepdim=True))
        x_hi = amax(x.amax(dim=axes, keepdim=True))
        s = torch.clamp(times_reciprocal(x_hi - x_lo, spec.qmax - spec.qmin),
                        min=eps)
        z = torch.round(spec.qmin - x_lo / s)
    if spec.pot:
        s = pot_scale(s)
    return s, z


def quantize_int(x: torch.Tensor, scale: torch.Tensor,
                 zero_point: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """g ∘ f⁻¹: real → clipped integer (float dtype carrier).

    ``rounding="toward_zero"`` truncates instead of rounding to nearest
    (half to even), which guarantees |q| <= |x/scale| element-wise."""
    u = x / scale + zero_point
    if spec.rounding == "toward_zero":
        q = torch.trunc(u)
    elif spec.rounding == "nearest":
        q = torch.round(u)
    else:
        raise ValueError(f"unknown rounding mode: {spec.rounding!r}")
    return torch.clamp(q, spec.qmin, spec.qmax)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor) -> torch.Tensor:
    return scale * (q - zero_point)


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Q(x) = f(g(f⁻¹(x))) with a clipped straight-through gradient:
    identity inside the representable range, zero outside."""
    q = quantize_int(x.detach(), scale, zero_point, spec)
    y = dequantize(q, scale, zero_point)
    lo = dequantize(torch.tensor(float(spec.qmin), device=x.device),
                    scale, zero_point)
    hi = dequantize(torch.tensor(float(spec.qmax), device=x.device),
                    scale, zero_point)
    x_clipped = torch.minimum(torch.maximum(x, lo), hi)
    return x_clipped + (y - x_clipped).detach()


def fake_quant_dynamic(x: torch.Tensor, spec: QuantSpec,
                       amax: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Fake-quant with scales computed on the fly from the current batch
    (``amax``: as :func:`compute_scale`'s)."""
    s, z = compute_scale(x.detach(), spec, amax=amax)
    return fake_quant(x, s, z, spec)


# --------------------------------------------------------------------------
# integer-arithmetic helpers (serving path)
# --------------------------------------------------------------------------

def to_int_dtype(q: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    if spec.bits <= 8:
        return q.to(torch.int8)
    if spec.bits <= 16:
        return q.to(torch.int16)
    return q.to(torch.int32)


def int_matmul(qx: torch.Tensor, qw: torch.Tensor,
               acc_dtype=torch.int32) -> torch.Tensor:
    """Integer ``qx @ qw`` over the last axis of qx, int32 accumulation (a
    plain product: the reference's is a ``dot_general``, not a kernel)."""
    lead = qx.shape[:-1]
    acc = _int_dot(qx.reshape(-1, qx.shape[-1]), qw)
    return acc.reshape(*lead, qw.shape[1]).to(acc_dtype)


PACKABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "in_proj", "out_proj", "lm_head")


def pack_weights_int8(params: Any, min_size: int = 1 << 12,
                      cfg: Any = None) -> Any:
    """Pack every 2D+ float weight named in ``PACKABLE`` as ``{q: int8,
    s: float32 per output channel}`` (weight-only W8).  Small tensors
    (norms, biases) stay float.  ``params`` is a nested dict/list tree of
    tensors; a new tree is returned.

    ``min_size`` is held, as in the reference, against the size of the
    array the reference keeps for the leaf, which stacks its layers on a
    leading axis: a leaf of the ``layers`` list counts ``len(layers)``
    times its own size, half that for gemma2 (a dense-family ``cfg`` with
    ``sliding_window``: the reference stacks the local and the global
    layers apart), and an expert array counts the reference's pad experts
    too (``cfg.n_experts_padded``).  Every other leaf counts its own size.
    A tree with a ``layers`` list therefore needs the model's ``cfg``
    (``Model.cfg``); without it this raises ``ValueError``."""
    layers = params.get("layers") if isinstance(params, dict) else None
    n_stack = 1
    if isinstance(layers, (list, tuple)):
        if cfg is None:
            raise ValueError(
                "pack_weights_int8: a tree with a 'layers' list needs the "
                "model's cfg, which says how the reference stacks them")
        n_stack = len(layers)
        if cfg.family in ("dense", "vlm", "audio") and cfg.sliding_window:
            n_stack //= 2

    def stacked_size(path: Tuple[str, ...], w: torch.Tensor) -> int:
        if not path or path[0] != "layers":
            return w.numel()
        if "experts" in path and cfg.moe.n_experts:
            return n_stack * w.numel() // cfg.moe.n_experts \
                * cfg.n_experts_padded
        return n_stack * w.numel()

    def pack(path: Tuple[str, ...], w):
        if isinstance(w, dict):
            return {k: pack(path + (k,), v) for k, v in w.items()}
        if isinstance(w, (list, tuple)):
            return [pack(path, v) for v in w]
        if not path or path[-1] not in PACKABLE or w.dim() < 2 \
                or stacked_size(path, w) < min_size \
                or w.dtype not in (torch.float32, torch.bfloat16):
            return w
        # per-output-channel scale over the fan-in axis only
        wf = w.to(torch.float32)
        sc = torch.clamp(wf.abs().amax(dim=-2, keepdim=True) / 127.0,
                         min=1e-8)
        q = torch.clamp(torch.round(wf / sc), -128, 127).to(torch.int8)
        return {"q": q, "s": sc}

    return pack((), params)
