"""Gated MLP (SwiGLU / GeGLU) with QAT hooks — counterpart of
``src/repro/models/mlp.py``."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import dense_init, linear


def init_mlp(gen: torch.Generator, d: int, ff: int, dtype
             ) -> Dict[str, Any]:
    return {
        "w_gate": dense_init(gen, (d, ff), dtype=dtype),
        "w_up": dense_init(gen, (d, ff), dtype=dtype),
        "w_down": dense_init(gen, (ff, d), scale=ff ** -0.5, dtype=dtype),
    }


def apply_mlp(params, x: torch.Tensor, act: str = "silu",
              quant=None) -> torch.Tensor:
    g = linear(x, params["w_gate"], quant=quant)
    u = linear(x, params["w_up"], quant=quant)
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's to erf
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    return linear(h, params["w_down"], quant=quant, row_split=True)
