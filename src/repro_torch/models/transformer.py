"""The language model for the dense family and its vlm/audio variants.

Counterpart of ``src/repro/models/transformer.py`` for ``family`` in
``dense`` (incl. gemma2's local/global alternation, soft-caps and
post-norms), ``vlm`` and ``audio`` (the dense backbone with a frontend
embedding prepended):

  * ``init(generator)``          → draws the weights (returns the model)
  * ``load_reference_params(t)`` → takes the reference's param pytree
  * ``forward(tokens, ...)``     → logits (B, S_total, vocab_padded): the
                                   prefill; every attention layer runs the
                                   flash-attention kernel on a card
  * ``init_cache(...)``          → KV cache (stacked over layers)
  * ``decode_step(...)``         → (logits (B, 1, V), cache), plain PyTorch

``moe``, ``ssm`` and ``hybrid`` are not ported yet; ``loss`` and every
gradient wait for the training slice (no backward kernel of the
attention yet).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.lower import resolve_device
from .attention import (attention_decode, attention_prefill, init_attention,
                        init_kv_cache)
from .common import dense_init, embed_init, rms_norm, softcap
from .convert import ParamTree, load_reference_params, unflatten
from .mlp import apply_mlp, init_mlp

DENSE_FAMILIES = ("dense", "vlm", "audio")
_NOT_PORTED = {"moe": "ROADMAP A9 (models/moe.py)",
               "ssm": "ROADMAP A9 (models/ssm.py)",
               "hybrid": "ROADMAP A9 (models/ssm.py and the hybrid)"}


def _init_dense_layer(gen: torch.Generator, cfg: ArchConfig
                      ) -> Dict[str, Any]:
    d = cfg.d_model

    def zeros():
        return torch.zeros((d,), dtype=cfg.dtype, device=gen.device)
    p = {
        "ln1": zeros(),
        "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.qkv_bias, cfg.dtype),
        "ln2": zeros(),
        "mlp": init_mlp(gen, d, cfg.d_ff, cfg.dtype),
    }
    if cfg.post_norms:
        p["post_ln1"] = zeros()
        p["post_ln2"] = zeros()
    return p


def _dense_layer_fwd(p, x, cfg: ArchConfig, *, window: int, quant=None):
    h = attention_prefill(
        p["attn"], rms_norm(x, p["ln1"]), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
        logit_cap=cfg.attn_softcap, window=window, quant=quant)
    if cfg.post_norms:
        h = rms_norm(h, p["post_ln1"])
    x = x + h
    h = apply_mlp(p["mlp"], rms_norm(x, p["ln2"]), act=cfg.mlp_act,
                  quant=quant)
    if cfg.post_norms:
        h = rms_norm(h, p["post_ln2"])
    return x + h


def _dense_layer_dec(p, x, cache, idx, cfg: ArchConfig, *, window: int,
                     quant=None, rolling: bool = False, valid_from=None):
    h, cache = attention_decode(
        p["attn"], rms_norm(x, p["ln1"]), cache, idx, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
        logit_cap=cfg.attn_softcap, window=window, quant=quant,
        rolling=rolling, valid_from=valid_from)
    if cfg.post_norms:
        h = rms_norm(h, p["post_ln1"])
    x = x + h
    h = apply_mlp(p["mlp"], rms_norm(x, p["ln2"]), act=cfg.mlp_act,
                  quant=quant)
    if cfg.post_norms:
        h = rms_norm(h, p["post_ln2"])
    return x + h, cache


class Model(nn.Module):
    """One dense-family LM on one device; its weights live in
    ``self.params`` (a :class:`ParamTree`, filled by :meth:`init` or
    :meth:`load_reference_params`)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        if cfg.family not in DENSE_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
                f"{_NOT_PORTED.get(cfg.family, 'unknown family')}")
        self.cfg = cfg
        self.device = device
        self.params: Optional[ParamTree] = None

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> "Model":
        """Draw the weights as the reference does (truncated normal at ±2,
        std fan_in^-0.5, ``wo`` (H·hd)^-0.5, ``w_down`` d_ff^-0.5, embed
        std 1, norms and biases zero) on ``generator`` — the same
        distributions, not the same numbers."""
        cfg = self.cfg
        tree: Dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                cfg.dtype),
            "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                      device=generator.device),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = dense_init(
                generator, (cfg.d_model, cfg.vocab_padded), dtype=cfg.dtype)
        tree["layers"] = [_init_dense_layer(generator, cfg)
                          for _ in range(cfg.n_layers)]
        self.params = ParamTree(tree).to(self.device)
        return self

    def load_reference_params(self, tree) -> "Model":
        """Take the reference's param pytree (numpy leaves, see
        :func:`~.convert.load_reference_params`)."""
        flat = load_reference_params(self.cfg, tree)
        self.params = ParamTree(unflatten(flat)).to(self.device)
        return self

    def _weights(self) -> ParamTree:
        if self.params is None:
            raise RuntimeError("the model has no weights yet: call init() "
                               "or load_reference_params() first")
        return self.params

    # ------------------------------------------------------ embeddings
    def _embed(self, params, tokens, frontend_embed):
        cfg = self.cfg
        # the constant is rounded to the model's dtype first, as in the
        # reference (sqrt(1536) = 39.19 becomes 39.25 in bfloat16)
        x = params["embed"][tokens] * torch.tensor(
            cfg.d_model ** 0.5, dtype=cfg.dtype, device=tokens.device)
        if frontend_embed is not None:
            x = torch.cat([frontend_embed.to(x.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        if not isinstance(head, torch.Tensor):       # int8-packed lm_head
            head = head["q"].to(x.dtype) * head["s"].to(x.dtype)
        logits = softcap(torch.matmul(x, head), cfg.final_softcap)
        if cfg.vocab_padded != cfg.vocab:       # in place: logits are big
            logits[..., cfg.vocab:] = -1e30
        return logits

    # ---------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor,
                frontend_embed: Optional[torch.Tensor] = None, *,
                quant=None) -> torch.Tensor:
        """Prefill: tokens (B, S) → logits (B, S_total, vocab_padded),
        S_total = S plus the frontend's positions."""
        cfg = self.cfg
        params = self._weights()
        x = self._embed(params, tokens, frontend_embed)
        for i, p in enumerate(params["layers"]):
            local = cfg.sliding_window and i % 2 == 0
            x = _dense_layer_fwd(p, x, cfg,
                                 window=cfg.sliding_window if local else 0,
                                 quant=quant)
        return self._logits(params, x)

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, s_max: int,
                   kv_dtype=None) -> Dict[str, Any]:
        """{"k", "v"} of (n_layers, B, s_max, KV, hd); gemma2: {"local":
        a sliding_window-deep rolling cache, "global": a full one}, each
        over n_layers / 2 layers."""
        cfg = self.cfg
        kv_dtype = kv_dtype or cfg.dtype

        def stacked(n, s):
            one = init_kv_cache(batch, s, cfg.n_kv_heads, cfg.hd, kv_dtype,
                                device=self.device)
            return {k: v[None].repeat(n, 1, 1, 1, 1) for k, v in one.items()}
        if cfg.sliding_window:
            n = cfg.n_layers // 2
            return {"local": stacked(n, min(cfg.sliding_window, s_max)),
                    "global": stacked(n, s_max)}
        return stacked(cfg.n_layers, s_max)

    # ------------------------------------------------------ decode step
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any],
                    cache_index, *, quant=None,
                    valid_from: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (B, 1) → (logits (B, 1, V), cache), the cache updated in
        place at ``cache_index``.

        valid_from (B,): first valid cache slot per batch row for
        left-padded batches.  gemma2's local layers decode against their
        rolling window buffer (``window=0``, ``rolling=True``: the buffer
        length is the window), so valid_from raises there."""
        cfg = self.cfg
        params = self._weights()
        x = self._embed(params, tokens, None)
        for i, p in enumerate(params["layers"]):
            if cfg.sliding_window:
                part = "local" if i % 2 == 0 else "global"
                c = {k: v[i // 2] for k, v in cache[part].items()}
                rolling = part == "local"
            else:
                c = {k: v[i] for k, v in cache.items()}
                rolling = False
            x, _ = _dense_layer_dec(p, x, c, cache_index, cfg, window=0,
                                    quant=quant, rolling=rolling,
                                    valid_from=valid_from)
        return self._logits(params, x), cache

    @property
    def supports_paged(self) -> bool:
        """The paged serving path needs full-context attention at every
        layer: sliding-window rolling caches pin layout to position."""
        return not self.cfg.sliding_window


def get_model(cfg: ArchConfig, device=None) -> Model:
    """``device=None`` means the card (``"cuda"``) and raises without
    one; pass ``device="cpu"`` for the plain PyTorch versions."""
    return Model(cfg, resolve_device(device))
