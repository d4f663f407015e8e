"""Top-level model assembly for every registered architecture family.

Counterpart of ``src/repro/models/transformer.py``: ``dense`` (incl.
gemma2's local/global alternation, soft-caps and post-norms), ``vlm`` and
``audio`` (the dense backbone with a frontend embedding prepended),
``moe`` (attention + routed experts, ``models/moe.py``), ``ssm`` (Mamba2,
``models/ssm.py``) and ``hybrid`` (Zamba2: a Mamba2 backbone and one
shared attention block applied after every ``attn_every`` layers):

  * ``init(generator)``          → draws the weights (returns the model)
  * ``load_reference_params(t)`` → takes the reference's param pytree
  * ``forward(tokens, ...)``     → logits (B, S_total, vocab_padded): the
                                   prefill; every attention layer runs the
                                   flash-attention kernel on a card;
                                   ``return_aux=True`` adds MoE's aux
                                   losses averaged over layers
  * ``init_cache(...)``          → KV cache / SSM states (stacked over
                                   layers, the reference's layout)
  * ``decode_step(...)``         → (logits (B, 1, V), cache), plain
                                   PyTorch, the cache updated in place
  * ``decode_paged(...)``        → (logits (B, T, V), page pools), the
                                   serving path against a paged KV cache
                                   (``serve/``), plain PyTorch, the pools
                                   written in place
  * ``loss(params, ...)``        → mean token cross-entropy,
                                   differentiable: on a card every
                                   attention layer's gradient comes from
                                   the flash-attention backward kernels
                                   (``kernels/flash_attention.py
                                   FlashAttention``), on the CPU autograd
                                   differentiates the plain attention
  * ``param_tree()``             → the weights as a nested dict of tensors,
                                   the params a train step takes

Layers are a list: gemma2's layer ``2i`` is the reference's ``local[i]``
and ``2i + 1`` its ``global[i]``; the hybrid's layer ``g·attn_every + j``
is the reference's ``layers[g][j]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.lower import resolve_device
from .attention import (attention_decode, attention_prefill, init_attention,
                        init_kv_cache, paged_attention)
from .common import dense_init, embed_init, rms_norm, softcap
from .convert import ParamTree, load_reference_params, unflatten
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .ssm import apply_mamba2, init_mamba2, init_mamba_state

DENSE_FAMILIES = ("dense", "vlm", "audio")
FAMILIES = DENSE_FAMILIES + ("moe", "ssm", "hybrid")


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


def _init_moe_layer(gen: torch.Generator, cfg: ArchConfig
                    ) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": torch.zeros((d,), dtype=cfg.dtype, device=gen.device),
        "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.qkv_bias, cfg.dtype),
        "ln2": torch.zeros((d,), dtype=cfg.dtype, device=gen.device),
        "moe": init_moe(gen, d, cfg.moe.n_experts, cfg.moe.d_expert,
                        cfg.moe.n_shared, cfg.dtype),
    }


def _init_mamba_layer(gen: torch.Generator, cfg: ArchConfig
                      ) -> Dict[str, Any]:
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                          device=gen.device),
        "mamba": init_mamba2(gen, cfg.d_model, cfg.ssm, cfg.dtype),
    }


def _moe_ffn(p, x, cfg: ArchConfig, quant):
    return apply_moe(p["moe"], rms_norm(x, p["ln2"]), top_k=cfg.moe.top_k,
                     capacity_factor=cfg.moe.capacity_factor,
                     act=cfg.mlp_act, quant=quant)


def _moe_layer_fwd(p, x, cfg: ArchConfig, *, quant=None):
    h = attention_prefill(
        p["attn"], rms_norm(x, p["ln1"]), n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta, quant=quant)
    x = x + h
    h, aux = _moe_ffn(p, x, cfg, quant)
    return x + h, aux


def _moe_layer_dec(p, x, cache, idx, cfg: ArchConfig, *, quant=None,
                   valid_from=None):
    h, cache = attention_decode(
        p["attn"], rms_norm(x, p["ln1"]), cache, idx, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta, quant=quant,
        valid_from=valid_from)
    x = x + h
    h, _ = _moe_ffn(p, x, cfg, quant)
    return x + h


def _mamba_layer(p, x, cfg: ArchConfig, *, quant=None, state=None):
    """Prefill (``state=None``) or one decode step against ``state``,
    updated in place; returns the new residual stream."""
    h, _ = apply_mamba2(p["mamba"], rms_norm(x, p["ln"]), cfg.ssm,
                        quant=quant, state=state, decode=state is not None)
    return x + h


class Model(nn.Module):
    """One LM on one device; its weights live in ``self.params`` (a
    :class:`ParamTree`, filled by :meth:`init` or
    :meth:`load_reference_params`)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self.device = device
        self.params: Optional[ParamTree] = None

    # ------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> "Model":
        """Draw the weights as the reference does (truncated normal at ±2,
        std fan_in^-0.5, ``wo`` (H·hd)^-0.5, ``w_down`` d_ff^-0.5, embed
        std 1, norms and biases zero) on ``generator`` — the same
        distributions, not the same numbers; MoE's router float32, Mamba2's
        ``A_log``, ``D`` and ``dt_bias`` float32 and deterministic)."""
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
        layer = {"moe": _init_moe_layer, "ssm": _init_mamba_layer,
                 "hybrid": _init_mamba_layer}.get(cfg.family,
                                                  _init_dense_layer)
        tree["layers"] = [layer(generator, cfg)
                          for _ in range(cfg.n_layers)]
        if cfg.family == "hybrid":
            tree["shared_attn"] = _init_dense_layer(generator, cfg)
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
                quant=None, return_aux: bool = False):
        """Prefill: tokens (B, S) → logits (B, S_total, vocab_padded),
        S_total = S plus the frontend's positions.  ``return_aux``: →
        (logits, aux), aux MoE's {"load_balance", "router_z"} averaged over
        the layers (None for the other families)."""
        logits, aux = self._forward(self._weights(), tokens, frontend_embed,
                                    quant=quant)
        return (logits, aux) if return_aux else logits

    def _forward(self, params, tokens, frontend_embed, *, quant=None,
                 remat: bool = False):
        """→ (logits, aux or None)."""
        cfg = self.cfg

        def run(fn, *args, **kw):
            if remat and torch.is_grad_enabled():
                # recompute the layer in the backward pass, as the
                # reference's jax.checkpoint does
                return checkpoint(fn, *args, use_reentrant=False, **kw)
            return fn(*args, **kw)
        x = self._embed(params, tokens, frontend_embed)
        layers = params["layers"]
        aux = None
        if cfg.family == "moe":
            auxs = []
            for p in layers:
                x, a = run(_moe_layer_fwd, p, x, cfg, quant=quant)
                auxs.append(a)
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        elif cfg.family in ("ssm", "hybrid"):
            for i, p in enumerate(layers):
                x = run(_mamba_layer, p, x, cfg, quant=quant)
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    x = run(_dense_layer_fwd, params["shared_attn"], x, cfg,
                            window=0, quant=quant)
        else:
            for i, p in enumerate(layers):
                local = cfg.sliding_window and i % 2 == 0
                x = run(_dense_layer_fwd, p, x, cfg,
                        window=cfg.sliding_window if local else 0,
                        quant=quant)
        return self._logits(params, x), aux

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, s_max: int,
                   kv_dtype=None) -> Dict[str, Any]:
        """The reference's stacked layout.  dense/vlm/audio/moe: {"k",
        "v"} of (n_layers, B, s_max, KV, hd); gemma2: {"local": a
        sliding_window-deep rolling cache, "global": a full one}, each over
        n_layers / 2 layers.  ssm: {"conv": (n_layers, B, K-1, ch), "ssd":
        (n_layers, B, H, P, N) float32}.  hybrid: {"mamba": those two over
        (n_groups, attn_every), "attn": {"k", "v"} over n_groups}."""
        cfg = self.cfg
        kv_dtype = kv_dtype or cfg.dtype

        def stacked(lead, one):
            return {k: v.expand(lead + v.shape).clone()
                    for k, v in one.items()}

        def kv(n, s):
            return stacked((n,), init_kv_cache(
                batch, s, cfg.n_kv_heads, cfg.hd, kv_dtype,
                device=self.device))
        if cfg.family in ("ssm", "hybrid"):
            state = init_mamba_state(batch, cfg.d_model, cfg.ssm, cfg.dtype,
                                     device=self.device)
            if cfg.family == "ssm":
                return stacked((cfg.n_layers,), state)
            n_groups = cfg.n_layers // cfg.attn_every
            return {"mamba": stacked((n_groups, cfg.attn_every), state),
                    "attn": kv(n_groups, s_max)}
        if cfg.sliding_window:
            n = cfg.n_layers // 2
            return {"local": kv(n, min(cfg.sliding_window, s_max)),
                    "global": kv(n, s_max)}
        return kv(cfg.n_layers, s_max)

    # ------------------------------------------------------ decode step
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any],
                    cache_index, *, quant=None,
                    valid_from: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens (B, 1) → (logits (B, 1, V), cache), the cache updated in
        place at ``cache_index``.

        valid_from (B,): first valid cache slot per batch row for
        left-padded batches, forwarded to every attention layer; the SSM
        layers ignore it (recurrent state cannot be masked), as in the
        reference.  gemma2's local layers decode against their rolling
        window buffer (``window=0``, ``rolling=True``: the buffer length is
        the window), so valid_from raises there."""
        cfg = self.cfg
        params = self._weights()
        x = self._embed(params, tokens, None)

        def at(c, *i):
            return {k: v[i] for k, v in c.items()}
        if cfg.family in ("ssm", "hybrid"):
            mamba = cache if cfg.family == "ssm" else cache["mamba"]
            for i, p in enumerate(params["layers"]):
                where = (i,) if cfg.family == "ssm" else \
                    divmod(i, cfg.attn_every)
                x = _mamba_layer(p, x, cfg, quant=quant,
                                 state=at(mamba, *where))
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    x, _ = _dense_layer_dec(
                        params["shared_attn"], x,
                        at(cache["attn"], i // cfg.attn_every), cache_index,
                        cfg, window=0, quant=quant, valid_from=valid_from)
            return self._logits(params, x), cache
        for i, p in enumerate(params["layers"]):
            if cfg.family == "moe":
                x = _moe_layer_dec(p, x, at(cache, i), cache_index, cfg,
                                   quant=quant, valid_from=valid_from)
                continue
            if cfg.sliding_window:
                part = "local" if i % 2 == 0 else "global"
                c = at(cache[part], i // 2)
                rolling = part == "local"
            else:
                c = at(cache, i)
                rolling = False
            x, _ = _dense_layer_dec(p, x, c, cache_index, cfg, window=0,
                                    quant=quant, rolling=rolling,
                                    valid_from=valid_from)
        return self._logits(params, x), cache

    # -------------------------------------------------------------- loss
    def loss(self, params, tokens, labels, frontend_embed=None, *,
             quant=None, remat: bool = False) -> torch.Tensor:
        """Mean token cross-entropy (float32 logsumexp) of ``params`` (a
        tree like :meth:`param_tree`'s) on ``tokens`` → ``labels`` (B, S);
        the frontend's positions are dropped.  MoE's aux term is added
        only when a forward left ``_last_aux``, which nothing sets, in the
        reference as here: the MoE loss is the plain cross-entropy
        (reference fault 8, ROADMAP C; kept for parity)."""
        logits, _ = self._forward(params, tokens, frontend_embed,
                                  quant=quant, remat=remat)
        if frontend_embed is not None:
            logits = logits[:, frontend_embed.shape[1]:]
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (logz - gold).mean()
        aux = getattr(self, "_last_aux", None)
        if aux is not None:
            nll = nll + 0.01 * aux["load_balance"] + 1e-3 * aux["router_z"]
        return nll

    def param_tree(self) -> Dict[str, Any]:
        """The weights as nested dicts and lists of tensors (detached,
        sharing storage with the module's), the params of a train step."""
        return self._weights().tree()

    @property
    def supports_paged(self) -> bool:
        """The paged serving path needs full-context attention at every
        layer: SSM/hybrid carry recurrent state that paging cannot evict,
        and sliding-window rolling caches pin layout to position."""
        cfg = self.cfg
        return cfg.family in DENSE_FAMILIES + ("moe",) and \
            not cfg.sliding_window

    def decode_paged(self, tokens: torch.Tensor, kv_pages, page_table,
                     lengths, *, page_size: int, quant=None, kv_scales=None
                     ) -> Tuple[torch.Tensor, Any]:
        """Multi-token step against a paged KV cache (the serving path).

        tokens (B, T) → (logits (B, T, V), kv_pages).  Covers chunked
        prefill (B=1, T=chunk), batched continuous decode (B=slots, T=1)
        and speculative verification (B=slots, T=spec_k+1, each slot's
        window at its own ``lengths[b]`` offset) with one code path; see
        ``attention.paged_attention``.

        kv_pages: a list over layers of {"k": (P, page, KV, hd), "v": ...}
        page pools, so each layer can carry its own storage dtype (int8
        where SIRA certifies the range, the model's dtype elsewhere); they
        are written in place and the same list is returned.  kv_scales:
        per-layer (k_scale, v_scale) for the int8 layers, None entries for
        the others.  page_table (B, n_pages) and lengths (B,) are shared by
        all layers."""
        cfg = self.cfg
        if not self.supports_paged:
            raise NotImplementedError(
                f"paged decode needs full-context attention — "
                f"family={cfg.family!r} sliding_window={cfg.sliding_window}")
        params = self._weights()
        x = self._embed(params, tokens, None)
        for layer, p in enumerate(params["layers"]):
            ks, vs = (kv_scales[layer] if kv_scales and
                      kv_scales[layer] is not None else (None, None))
            h, _, _ = paged_attention(
                p["attn"], rms_norm(x, p["ln1"]), kv_pages[layer]["k"],
                kv_pages[layer]["v"], page_table, lengths,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
                theta=cfg.rope_theta, page_size=page_size,
                logit_cap=cfg.attn_softcap, quant=quant, k_scale=ks,
                v_scale=vs)
            if cfg.post_norms:
                h = rms_norm(h, p["post_ln1"])
            x = x + h
            if cfg.family == "moe":
                h, _ = _moe_ffn(p, x, cfg, quant)
            else:
                h = apply_mlp(p["mlp"], rms_norm(x, p["ln2"]),
                              act=cfg.mlp_act, quant=quant)
            if cfg.post_norms:
                h = rms_norm(h, p["post_ln2"])
            x = x + h
        return self._logits(params, x), kv_pages


def get_model(cfg: ArchConfig, device=None) -> Model:
    """``device=None`` means the card (``"cuda"``) and raises without
    one; pass ``device="cpu"`` for the plain PyTorch versions."""
    return Model(cfg, resolve_device(device))
