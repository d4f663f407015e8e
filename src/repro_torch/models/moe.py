"""Top-k routed MoE with shared experts (Switch/GShard grouped dispatch).

Counterpart of ``src/repro/models/moe.py``.  Tokens are grouped by batch
row (G = B groups of S·k slots); within each group every slot gets its
rank in its expert's queue, slots past the capacity C are dropped, and
the kept ones are scattered into a (B, E, C, d) layout, run through the
experts as batched matrix products, gathered back and weighted by their
gates.  The reference has no Pallas kernel here (einsum, ``top_k``,
scatter), so neither has the port.

The reference pads the expert arrays to ``n_experts_padded`` (a multiple
of 16) for expert parallelism and never routes to the pads; the port
keeps only the ``n_experts`` real ones (ROADMAP C).  Under expert
parallelism each rank holds a block of them (``launch/shardings.py
expert_range``: of the real count where "model" divides it, else of the
padded count, so a rank may hold fewer real experts, or none).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import TensorParallel, dense_init
from .mlp import apply_mlp, init_mlp


def init_moe(gen: torch.Generator, d: int, n_experts: int, d_expert: int,
             n_shared: int, dtype) -> Dict[str, Any]:
    p = {
        "router": dense_init(gen, (d, n_experts), scale=d ** -0.5,
                             dtype=torch.float32),
        "experts": {
            "w_gate": dense_init(gen, (n_experts, d, d_expert), dtype=dtype),
            "w_up": dense_init(gen, (n_experts, d, d_expert), dtype=dtype),
            "w_down": dense_init(gen, (n_experts, d_expert, d),
                                 scale=d_expert ** -0.5, dtype=dtype),
        },
    }
    if n_shared:
        p["shared"] = init_mlp(gen, d, n_shared * d_expert, dtype)
    return p


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and batch row, as the reference computes them."""
    C = int(max(top_k, capacity_factor * S * top_k / n_experts))
    return min(C, S * top_k)


def rank_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each slot within its expert's queue, in slot order.

    flat_e: (G, n) expert ids → (G, n) int64 ranks, by a stable sort and
    ``searchsorted`` per row (no (n, E) one-hot)."""
    G, n = flat_e.shape
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=flat_e.device)
    start = torch.searchsorted(sorted_e.contiguous(),
                               experts.expand(G, n_experts).contiguous())
    pos_sorted = torch.arange(n, device=flat_e.device) - \
        torch.gather(start, 1, sorted_e)
    return torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)


class Routing(NamedTuple):
    logits: torch.Tensor     # (B, S, E) float32 router logits
    probs: torch.Tensor      # (B, S, E) softmax
    gate_vals: torch.Tensor  # (B, S, k) renormalised top-k probabilities
    gate_idx: torch.Tensor   # (B, S, k) expert ids
    pos: torch.Tensor        # (B, S·k) rank of each slot in its queue
    in_cap: torch.Tensor     # (B, S·k) the slot is kept (pos < C)
    C: int                   # capacity per expert and batch row


def route(params, x: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """The router of :func:`apply_moe`: float32 logits, softmax, top-k
    renormalised (floor 1e-9), queue ranks and the capacity mask."""
    B, S, _ = x.shape
    E = params["router"].shape[-1]
    logits = torch.matmul(x.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = capacity(S, top_k, E, capacity_factor)
    pos = rank_in_expert(gate_idx.reshape(B, S * top_k), E)
    return Routing(logits, probs, gate_vals, gate_idx, pos, pos < C, C)


def apply_moe(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu", quant=None,
              tp: Optional[TensorParallel] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) → (y, {"load_balance", "router_z"}).  ``quant`` reaches
    the shared MLP only, as in the reference.

    Expert parallelism (``tp`` over a "model" axis > 1): the routing is
    computed alike on every rank; a rank holds the experts ``tp.experts``
    (first, count) names and dispatches only the kept slots routed to
    them; every other slot reads a zero row.  The weighted sum is the
    rank's share of ``y`` (each kept slot has one owner), the shared MLP
    is split as a dense one, and one all-reduce over "model" joins both.
    ``x`` and the gates enter the split work through ``tp.copy``, so
    their gradients (and the router's) are the whole ones."""
    B, S, d = x.shape
    we = params["experts"]
    r = route(params, x, top_k=top_k, capacity_factor=capacity_factor)
    E, C, n = r.probs.shape[-1], r.C, S * top_k
    lo, E_l = tp.experts if tp is not None and tp.size > 1 else (0, E)
    xin = x if tp is None else tp.copy(x)
    gates = r.gate_vals if tp is None else tp.copy(r.gate_vals)
    flat_e = r.gate_idx.reshape(B, n) - lo
    keep = r.in_cap & (flat_e >= 0) & (flat_e < E_l)
    pos_c = torch.clamp(r.pos, 0, C - 1)
    # flat place of each slot in this rank's (B, E_l, C) layout, or a
    # trash row past the end for slots it does not run, and its token
    rows = torch.arange(B, device=x.device)[:, None]
    trash = B * E_l * C
    slot = torch.where(keep, (rows * E_l + flat_e) * C + pos_c,
                       trash).reshape(-1)                     # (B·n,)
    token = torch.arange(B * S, device=x.device).repeat_interleave(top_k)

    # dispatch: every kept slot is written to its own place and every
    # other one to the trash row, so a dropped slot cannot overwrite a
    # kept token (and no mask is synchronised to the host)
    xe = xin.new_zeros((trash + 1, d))
    xe[slot] = xin.reshape(B * S, d)[token]
    xe = xe[:trash]
    # experts: one batched product per weight, E_l batches of B·C rows
    xe = xe.reshape(B, E_l, C, d).transpose(0, 1).reshape(E_l, B * C, d)
    g = torch.bmm(xe, we["w_gate"])
    u = torch.bmm(xe, we["w_up"])
    h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u
    ye = torch.bmm(h, we["w_down"])                          # (E_l, B·C, d)
    ye = ye.reshape(E_l, B, C, d).transpose(0, 1).reshape(trash, d)

    # combine: gather back (the trash row is zero), weight by the gates
    # (0 for slots dropped or not this rank's)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    y_tok = ye[slot].reshape(B, n, d)
    w_tok = gates.reshape(B, n) * keep.to(gates.dtype)
    y = (y_tok.to(torch.float32) * w_tok[..., None]).reshape(
        B, S, top_k, d).sum(dim=2).to(x.dtype)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], xin, act=act, quant=quant)
    if tp is not None:
        y = tp.reduce(y)

    # aux: Switch load-balance + router z-loss
    ids = r.gate_idx.reshape(-1)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=torch.float32))
    density = counts / (B * S)
    density_proxy = r.probs.mean(dim=(0, 1))
    lb_loss = E * torch.sum(density * density_proxy)
    z_loss = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
    return y, {"load_balance": lb_loss, "router_z": z_loss}


def apply_moe_direct(params, x: torch.Tensor, r: Routing, *,
                     act: str = "silu") -> torch.Tensor:
    """The oracle of :func:`apply_moe`'s dispatch: ``Σ_k gate · in_cap ·
    expert_k(x)`` (plus the shared MLP) in float64, each expert applied to
    the tokens routed to it, with the routing ``r`` and no (B, E, C, d)
    layout, queue position or gather."""
    B, S, d = x.shape
    k = r.gate_idx.shape[-1]
    f64 = torch.float64
    xf = x.to(f64).reshape(B * S, d)
    idx = r.gate_idx.reshape(B * S, k)
    w = (r.gate_vals.to(f64) * r.in_cap.reshape(B, S, k)).reshape(B * S, k)
    y = torch.zeros_like(xf)
    we = params["experts"]
    for e in range(we["w_gate"].shape[0]):
        tok, j = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        g = xe @ we["w_gate"][e].to(f64)
        h = (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) \
            * (xe @ we["w_up"][e].to(f64))
        y.index_add_(0, tok, (h @ we["w_down"][e].to(f64)) * w[tok, j, None])
    y = y.reshape(B, S, d)
    if "shared" in params:
        sh = params["shared"]
        y = y + apply_mlp({n: sh[n].to(f64) for n in ("w_gate", "w_up",
                                                      "w_down")},
                          x.to(f64), act=act)
    return y
