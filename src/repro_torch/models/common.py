"""Shared model building blocks (PyTorch, functional).

Counterpart of ``src/repro/models/common.py``.  Parameters are nested
mappings of tensors (plain dicts, or the :class:`~.convert.ParamTree`
module a :class:`~.transformer.Model` holds); layers are a list, not a
stacked axis.  The reference's sharding helpers (``shard``, the mesh
axes) have no counterpart: a sharded ``Model`` runs its rank's blocks
(``launch/shardings.py``), and :class:`LayoutQuant` carries the layout
to the fake-quant scales.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

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

@dataclasses.dataclass(frozen=True)
class LayoutQuant:
    """Fake-quant under a layout (``launch/mesh.py``): the spec, and the
    layout whose ranks hold the rest of a tensor a scale is the max of.
    ``Model`` hands it to the layers in place of a bare ``QuantSpec``."""
    spec: QuantSpec
    layout: Any


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What one rank of a layout's "model" axis runs (Megatron style):
    its query and KV heads, its experts (first, count) and the layout
    whose "model" axis joins the ranks (None: the whole model, nothing
    to join).  ``kv_group`` > 1 when the axis is a multiple of the KV
    heads: that many ranks hold the same KV head, and its projections'
    gradients are summed over them (:meth:`shared`)."""
    n_heads: int
    n_kv: int
    layout: Any = None
    experts: Tuple[int, int] = (0, 0)
    kv_group: int = 1

    @property
    def size(self) -> int:
        return 1 if self.layout is None else self.layout.size("model")

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial products (after a row-split
        product); identity backward."""
        return x if self.layout is None else \
            self.layout.all_reduce(x, "model")

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering work split over the ranks (before a
        column-split product); its gradient is summed over them."""
        return x if self.layout is None else self.layout.copy(x, "model")

    def shared(self, w: torch.Tensor) -> torch.Tensor:
        """A KV projection leaf that ``kv_group`` ranks hold alike: the
        leaf itself, whose gradient (each rank's is its query heads'
        part) is summed over those ranks."""
        if self.kv_group == 1 or not (torch.is_grad_enabled() and
                                      w.requires_grad):
            return w
        return _SharedHead.apply(w, self.layout, self.kv_group)


class _SharedHead(torch.autograd.Function):
    """Identity forward; backward: the sum of the gradient over the ranks
    of this rank's KV group (each rank writes its part at its group's
    place in a zero tensor of all groups, one ``all_reduce`` over
    "model", and takes its group's place back)."""

    @staticmethod
    def forward(ctx, w, layout, group):
        ctx.layout, ctx.group = layout, group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        layout, group = ctx.layout, ctx.group
        n = layout.size("model") // group
        i = layout.index("model") // group
        full = g.new_zeros((n,) + g.shape)
        full[i] = g
        return layout.all_reduce(full, "model")[i], None, None


def _reduces(spec: QuantSpec, ndim: int, dim: int) -> bool:
    """Whether ``spec``'s scale is a max over dim ``dim``."""
    return spec.granularity == "per_tensor" or \
        spec.channel_axis % ndim != dim % ndim


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           quant=None, *, row_split: bool = False) -> torch.Tensor:
    """y = x @ w (+ b), optionally fake-quantized (QAT).

    ``w`` is a (K, M) tensor or packed int8 weights ``{q, s}``.  With
    ``quant`` (a ``QuantSpec``, or a :class:`LayoutQuant` under a
    layout): weights are fake-quantized per output channel and the
    activation per tensor.  Under a layout each scale is the whole
    tensor's, as in the reference: the activation's is a max over the
    batch axes ("pod", "data"), and when ``row_split`` (the rows of
    ``w``, and so the columns of ``x``, are split over "model": ``wo``,
    ``w_down``, ``out_proj``) the weight's per-channel max and the
    activation's are also maxima over "model"."""
    if not isinstance(w, torch.Tensor):      # packed int8 weights {q, s}
        w = w["q"].to(x.dtype) * w["s"].to(x.dtype)
    if quant is not None:
        layout = None
        if isinstance(quant, LayoutQuant):
            quant, layout = quant.spec, quant.layout
        w_spec = QuantSpec(bits=quant.bits, granularity="per_channel",
                           channel_axis=-1, pot=quant.pot)
        w_max = x_max = None
        if layout is not None:
            if row_split:
                w_max = functools.partial(layout.max, axis="model")
            axes = tuple(a for a in ("pod", "data")
                         if _reduces(quant, x.dim(), 0)) + \
                (("model",) if row_split and _reduces(quant, x.dim(), -1)
                 else ())
            x_max = functools.partial(layout.max, axis=axes)
        sw, zw = compute_scale(w.detach(), w_spec, amax=w_max)
        w = fake_quant(w, sw, zw, w_spec)
        x = fake_quant_dynamic(x, quant, amax=x_max)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
