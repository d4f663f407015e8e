"""SIRA-flavored scaled-integer gradient compression with error feedback.

The paper's core representation — a tensor as (integer payload, scale) —
applied to the distributed-training communication layer: gradients are
quantized to int8 with a per-tensor scale before the all-reduce, an
8/32 wire-byte reduction; the residual quantization error is carried to
the next step (error feedback), which is what keeps SGD/Adam convergence
intact (Karimireddy et al., 2019).

Counterpart of ``src/repro/train/compression.py``.  ``torch.round``
rounds half to even like ``jnp.round``, and the scale is taken as the
jitted step takes it, so the int8 payload equals the compiled
reference's bit for bit.  ``compressed_psum``, the reference's
``shard_map`` collective, runs over an axis of the port's
``torch.distributed`` layout (``launch/mesh.py``) or a process group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..quant.quantizer import times_reciprocal
from ..tree import flatten, leaves, tree_map, unflatten


def quantize_tensor(g: torch.Tensor, amax=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization → (payload, scale).
    ``amax`` maps the local max |g| to the whole tensor's when ``g`` is a
    rank's block of it (``Layout.max``).  The scale is the compiled
    reference's (it runs inside the jitted step): ``amax`` times the
    float32 reciprocal of 127, not the IEEE quotient."""
    top = torch.max(torch.abs(g))
    if amax is not None:
        top = amax(top)
    scale = torch.clamp(times_reciprocal(top, 127), min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: Any, error_feedback: Any, amax=None
                   ) -> Tuple[Any, Any]:
    """Quantize (grads + carried error) to int8; return (dequantized
    grads, new error feedback).  ``amax``: as :func:`quantize_tensor`'s,
    for grads that are a rank's blocks.

    The new error is ``g32 - q * s`` rounded once, as the compiled
    reference computes it: XLA contracts the product and the difference
    into one fused multiply-add.  In float64 the product of an int8 and a
    float32 is exact and so is the difference (|g32 - q·s| <= s/2 spans
    fewer than 53 bits), so one rounding to float32 gives the fma's
    result on any device."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_tensor(g32, amax)
        err = q.to(torch.float64).mul_(-s.to(torch.float64)).add_(g32)
        return dequantize_tensor(q, s), err.to(torch.float32)

    flat_g, spec = flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, leaves(error_feedback))]
    return (unflatten(spec, [o[0] for o in outs]),
            unflatten(spec, [o[1] for o in outs]))


def init_error_feedback(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """int8-payload all-reduce over ``axis_name`` (a ``launch.mesh``
    layout axis, resolved against the active layout, or a process group):
    quantize → max of the scales → payloads renormalized to that common
    scale and rounded to int32 → sum of the int32 payloads → rescale, as
    the reference's.  Per element the result is within 2·Σ_r scale_r of
    the plain sum.  The summed payloads are int32, so the all-reduce moves
    as many bytes as a float32 one (the max adds 4 bytes)."""
    from ..launch import mesh
    q, s = quantize_tensor(x)
    s_max = mesh.max(s, axis_name)
    # renormalize payloads to the common scale before the integer sum
    q_common = torch.round(q.to(torch.float32) * (s / s_max)
                           ).to(torch.int32)
    total = mesh.all_reduce(q_common, axis_name)
    return total.to(torch.float32) * s_max
