"""Carry a JAX parameter tree of the reference package across into this
package, and hold parameters as an ``nn.Module``.

The reference keeps parameters as a pytree: nested dicts, repeated layers
stacked on axis 0 (``src/repro/models/transformer.py Model.init``), gemma2
as stacked ``{"local", "global"}`` pairs, the hybrid's Mamba2 layers
stacked on (n_groups, attn_every).  Here layers are a list: layer ``2i``
of gemma2 is ``local[i]`` and ``2i + 1`` is ``global[i]``; the hybrid's
layer ``g·attn_every + j`` is ``layers[g][j]``.  MoE's expert arrays lose
the reference's pad experts (never routed to): the port keeps
``n_experts``.  The converter reads numpy arrays only (no import of the
reference).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict (and list) of tensors as a module: each tensor is a
    frozen ``nn.Parameter`` (``requires_grad=False``: a train step
    differentiates the detached :meth:`tree` instead), each dict a child
    ``ParamTree``, each list an ``nn.ModuleList``.  Reads like the dict it
    came from (``p["wq"]``, ``p.get("bq")``, ``"lm_head" in p``), so the
    model functions take either."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v)
                                                   for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default

    def tree(self) -> Dict[str, Any]:
        """The nested dict (and list) of tensors this module holds,
        detached: the tree a train step differentiates."""
        out: Dict[str, Any] = {k: v.detach()
                               for k, v in self._parameters.items()}
        for k, m in self._modules.items():
            out[k] = ([c.tree() for c in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes, as JAX hands it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(prefix: str, node: Any, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else k, v, out)
    else:
        out[prefix] = _tensor(node)


def _layer(stacked: Any, *i: int) -> Any:
    if isinstance(stacked, Mapping):
        return {k: _layer(v, *i) for k, v in stacked.items()}
    return np.asarray(stacked)[i]


def load_reference_params(cfg, tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The reference's param pytree (numpy leaves) of ``cfg``, any family,
    → a flat state dict (CPU tensors, dtypes kept: MoE's router and
    Mamba2's ``A_log``/``D``/``dt_bias`` stay float32 in a bf16 model)
    keyed like ``Model.params``: ``embed``, ``final_norm``, ``lm_head``
    (absent when tied), ``layers.<i>.attn.wq``, ``layers.<i>.moe.experts
    .w_gate`` ([:n_experts] of the reference's padded array),
    ``shared_attn.attn.wq``, ...; packed ``{q, s}`` weights become
    ``<name>.q`` and ``<name>.s``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if key != "layers":
            _flatten(key, val, out)
    layers = tree["layers"]
    if cfg.sliding_window:
        per = []
        for i in range(cfg.n_layers // 2):
            per += [_layer(layers["local"], i), _layer(layers["global"], i)]
    elif cfg.family == "hybrid":
        per = [_layer(layers, *divmod(i, cfg.attn_every))
               for i in range(cfg.n_layers)]
    else:
        per = [_layer(layers, i) for i in range(cfg.n_layers)]
    for i, layer in enumerate(per):
        if "moe" in layer:              # drop the pad experts
            experts = layer["moe"]["experts"]
            for k in experts:
                experts[k] = experts[k][:cfg.moe.n_experts]
        _flatten(f"layers.{i}", layer, out)
    return out


def unflatten(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A flat ``a.b.0.c`` state dict → nested dicts, ``layers`` a list."""
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    if "layers" in tree:
        layers = tree["layers"]
        tree["layers"] = [layers[str(i)] for i in range(len(layers))]
    return tree
