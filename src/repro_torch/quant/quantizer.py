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
from typing import Any, Tuple

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


def compute_scale(x: torch.Tensor, spec: QuantSpec,
                  eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max calibration → (scale, zero_point), broadcastable to x."""
    if spec.granularity == "per_group":
        ax = spec.channel_axis % x.dim()
        g = spec.group_size
        shp = list(x.shape)
        if shp[ax] % g:
            raise ValueError("group_size must divide the channel dim")
        xg = torch.movedim(x, ax, -1).reshape(-1, shp[ax] // g, g)
        amax = xg.abs().amax(dim=(0, 2), keepdim=True)           # (1, G, 1)
        s = torch.clamp(amax / spec.qmax, min=eps)
        s = s.expand(1, shp[ax] // g, g).reshape(shp[ax])
        shape = [1] * x.dim()
        shape[ax] = shp[ax]
        s = s.reshape(shape)
        z = torch.zeros_like(s)
    elif spec.symmetric:
        axes = _reduce_axes(x, spec)
        amax = x.abs().amax(dim=axes, keepdim=True)
        s = torch.clamp(amax / spec.qmax, min=eps)
        z = torch.zeros_like(s)
    else:
        axes = _reduce_axes(x, spec)
        x_lo = x.amin(dim=axes, keepdim=True)
        x_hi = x.amax(dim=axes, keepdim=True)
        s = torch.clamp((x_hi - x_lo) / (spec.qmax - spec.qmin), min=eps)
        z = torch.round(spec.qmin - x_lo / s)
    if spec.pot:
        s = torch.exp2(torch.ceil(torch.log2(s)))
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


def fake_quant_dynamic(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Fake-quant with scales computed on the fly from the current batch."""
    s, z = compute_scale(x.detach(), spec)
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
