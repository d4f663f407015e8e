"""Shared model building blocks (PyTorch, functional).

Counterpart of ``src/repro/models/common.py``.  Parameters are nested
mappings of tensors (plain dicts, or the :class:`~.convert.ParamTree`
module a :class:`~.transformer.Model` holds); layers are a list, not a
stacked axis.  The reference's sharding helpers (``shard``, the mesh
axes) have no counterpart: the port runs on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.quantizer import (QuantSpec, compute_scale, fake_quant,
                               fake_quant_dynamic)


# ------------------------------------------------------------------ init

class ShapeOnly:
    """Stands for a generator where only shapes are wanted: the init
    functions then build ``meta`` tensors and draw nothing
    (``Model.init_shapes``)."""
    device = torch.device("meta")


def _truncated_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated at ±2, float32, on the generator's
    device (the distribution of ``jax.random.truncated_normal(-2, 2)``;
    not its bits)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if isinstance(gen, ShapeOnly):
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return (_truncated_normal(gen, shape) * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return _truncated_normal(gen, (vocab, d)).to(dtype)


# ----------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


# ------------------------------------------------------------------ rope

def rope_frequencies(hd: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers.  Rotates the two
    halves of the head dimension (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- linear

def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           quant: Optional[QuantSpec] = None) -> torch.Tensor:
    """y = x @ w (+ b), optionally fake-quantized (QAT).

    ``w`` is a (K, M) tensor or packed int8 weights ``{q, s}``.  With
    ``quant``: weights are fake-quantized per output channel and the
    activation per tensor."""
    if not isinstance(w, torch.Tensor):      # packed int8 weights {q, s}
        w = w["q"].to(x.dtype) * w["s"].to(x.dtype)
    if quant is not None:
        w_spec = QuantSpec(bits=quant.bits, granularity="per_channel",
                           channel_axis=-1, pot=quant.pot)
        sw, zw = compute_scale(w.detach(), w_spec)
        w = fake_quant(w, sw, zw, w_spec)
        x = fake_quant_dynamic(x, quant)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
