"""Parameter / state / input partition specs (DP x TP x EP), and the
slicing of a parameter tree to one rank's block.

Counterpart of ``src/repro/launch/shardings.py``.  A spec is a tuple with
one entry per dim: an axis name, a tuple of axis names, or ``None``
(replicated) — the reference's ``PartitionSpec`` as a tuple.  Rules are
assigned by parameter path name, applied to the *last* dims:

  embed (V, d)            → ("model", None)      vocab-parallel
  lm_head (d, V)          → (None, "model")
  attn wq/wk/wv (d, Hh)   → (None, "model")      head-parallel
  attn wo (Hh, d)         → ("model", None)
  mlp w_gate/up (d, f)    → (None, "model")
  mlp w_down (f, d)       → ("model", None)
  moe experts (E, d, f)   → ("model", None, None) expert-parallel
  mamba in_proj (d, p)    → (None, "model")
  mamba out_proj (p, d)   → ("model", None)
  conv_w (K, ch)          → (None, "model"); conv_b/bq/bk/bv → ("model",)
  norms / scalars         → replicated

Optimizer moments and master weights additionally shard their largest
replicated dim over "data" (ZeRO-style).

The port's layers are a list, so a layer's leaf has no stacking axis:
its spec is the reference's without the leading ``None``.  The tree is
walked the same way: nested dicts (and the port's layer lists, whose
items keep their parent's path).

:func:`shard_params` is the port's own: it slices each leaf to this
rank's block along the dims its (divisibility-filtered) spec puts on
"model", which is what tensor-parallel ``Model`` code runs on.  K/V
projections follow the heads, not the columns: when "model" is a
multiple of the KV heads, each rank keeps the KV head of its query group
(GSPMD would split a head's columns or pad; ROADMAP C).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

Spec = Tuple[Any, ...]
BATCH = ("pod", "data")

_RULES = [
    ("embed", ("model", None)),
    ("lm_head", (None, "model")),
    ("wq", (None, "model")), ("wk", (None, "model")),
    ("wv", (None, "model")),
    ("wo", ("model", None)),
    ("bq", ("model",)), ("bk", ("model",)), ("bv", ("model",)),
    ("w_gate", (None, "model")), ("w_up", (None, "model")),
    ("w_down", ("model", None)),
    ("router", (None, None)),
    ("in_proj", (None, "model")),
    ("out_proj", ("model", None)),
    ("conv_w", (None, "model")), ("conv_b", ("model",)),
    ("norm_scale", (None,)),
    ("A_log", (None,)), ("D", (None,)), ("dt_bias", (None,)),
]

_EXPERT_RULES = [
    ("w_gate", ("model", None, None)), ("w_up", ("model", None, None)),
    ("w_down", ("model", None, None)),
]


def _spec_for(path: str, ndim: int, in_experts: bool) -> Spec:
    # int8-packed weights: {.../wq/q, .../wq/s} — rule on the parent name
    if path.endswith("/q"):
        path = path[:-2]
    elif path.endswith("/s"):
        return (None,) * ndim
    rules = _EXPERT_RULES + _RULES if in_experts else _RULES
    for key, tail in rules:
        if path.endswith("/" + key) or path == key:
            pad = (None,) * (ndim - len(tail))
            return pad + tuple(tail)
    return (None,) * ndim


def _walk(tree, fn, path="", in_experts=False):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + "/" + k,
                         in_experts or k == "experts")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path, in_experts) for v in tree]
    return fn(path, tree, in_experts)


def param_pspecs(params: Any) -> Any:
    """Spec tree mirroring the params tree (dicts, lists of layers)."""
    return _walk(params, lambda path, leaf, ex: _spec_for(
        path, _ndim(leaf), ex))


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else \
        len(getattr(leaf, "shape", ()))


def zero_shard(spec: Spec, shape) -> Spec:
    """Additionally shard the largest None dim over 'data' (ZeRO-style),
    for optimizer state."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (s, n) in enumerate(zip(parts, shape)):
        if s is None and n > best_size and n >= 16:
            best, best_size = i, n
    if best is not None:
        parts[best] = "data"
    return tuple(parts)


def opt_pspecs(params: Any, pspec_tree: Any) -> Any:
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        if isinstance(p, (list, tuple)):
            return [walk(a, b) for a, b in zip(p, s)]
        return zero_shard(s, tuple(p.shape))
    return walk(params, pspec_tree)


def filter_spec_for_layout(spec: Spec, layout, shape=None) -> Spec:
    """Drop axis names the layout does not have (pod-less single layout),
    and — when ``shape`` is given — drop assignments that do not divide
    the dim (anything odd degrades to replication).  The reference's
    ``filter_pspec_for_mesh``."""
    names = set(layout.axis_names)
    sizes = dict(zip(layout.axis_names, layout.shape))

    def f(s, dim):
        if s is None:
            return None
        parts = s if isinstance(s, (tuple, list)) else (s,)
        kept = tuple(a for a in parts if a in names)
        if not kept:
            return None
        if dim is not None:
            total = 1
            for a in kept:
                total *= sizes[a]
            if dim % total != 0:
                return None
        return kept if len(kept) > 1 else kept[0]

    dims = list(shape) + [None] * (len(spec) - len(shape)) \
        if shape is not None else [None] * len(spec)
    return tuple(f(s, d) for s, d in zip(spec, dims))


def batch_pspec(ndim: int) -> Spec:
    return (BATCH,) + (None,) * (ndim - 1)


def kv_page_pspec() -> Spec:
    """Spec of a serving KV page pool of shape (num_pages, page_size,
    n_kv_heads, head_dim): the KV-head dim over "model", so the host-side
    page table and free list stay global while the KV bytes split."""
    return (None, None, "model", None)


def kv_pool_sharding(layout, n_kv_heads: int) -> Spec:
    """Divisibility-guarded spec for the page pools: the head dim
    degrades to replication when "model" does not divide ``n_kv_heads``
    (the reference's ``kv_pool_sharding``, as a spec)."""
    return filter_spec_for_layout(kv_page_pspec(), layout,
                                  (1, 1, n_kv_heads, 1))


def cache_pspecs(cache: Any, kv_heads: int = 0,
                 model_size: int = 16) -> Any:
    """Specs for decode caches, assigned by leaf key name (the reference's
    ``launch/dryrun.py cache_pspecs``).

    KV caches shard their head axis on "model" when divisible; otherwise
    the *sequence* axis is model-sharded (flash-decode style)."""
    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        nd = len(tree.shape)
        if key in ("k", "v"):        # (n..., B, S, KV, hd)
            pad = (None,) * (nd - 4)
            if kv_heads and kv_heads % model_size == 0:
                return pad + (BATCH, None, "model", None)
            return pad + (BATCH, "model", None, None)
        if key == "conv":            # (n..., B, K-1, ch)
            pad = (None,) * (nd - 3)
            return pad + (BATCH, None, "model")
        if key == "ssd":             # (n..., B, H, P, N)
            pad = (None,) * (nd - 4)
            return pad + (BATCH, "model", None, None)
        return (None,) * nd
    return walk(cache, "")


# ------------------------------------------------------ tensor parallel

def tp_heads(cfg, layout) -> Tuple[int, int]:
    """(query heads, KV heads) one rank of ``layout``'s "model" axis
    holds.  "model" must divide the query heads, and divide the KV heads
    or be a multiple of them (then each rank keeps the one KV head of its
    query group); anything else raises ``ValueError``."""
    m = layout.size("model")
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if m == 1:
        return H, KV
    if H % m:
        raise ValueError(f"{cfg.name}: the model axis ({m}) does not "
                         f"divide the {H} query heads")
    if KV % m and m % KV:
        raise ValueError(f"{cfg.name}: the model axis ({m}) neither "
                         f"divides the {KV} KV heads nor is a multiple of "
                         f"them")
    return H // m, max(KV // m, 1)


def check_tensor_parallel(cfg, layout) -> None:
    """Raise for what the port does not shard over "model" yet: MoE expert
    parallelism and the Mamba2/Zamba2 families (``NotImplementedError``,
    ROADMAP A11b); a head count the axis does not fit, or an MLP width it
    does not divide (``ValueError``).  The rows of ``wo`` (the query
    heads' columns) and of ``w_down`` (``d_ff``) are summed over "model"
    after their products: a dim the axis left whole would be summed once
    per rank."""
    m = layout.size("model")
    if m == 1:
        return
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism of the {cfg.family!r} family "
            f"(model axis {m}) is not ported yet (ROADMAP A11b); a layout "
            f"with model = 1 runs it")
    tp_heads(cfg, layout)
    if cfg.d_ff % m:
        raise ValueError(f"{cfg.name}: the model axis ({m}) does not "
                         f"divide d_ff ({cfg.d_ff}), the rows of w_down")


def kv_head_range(cfg, layout) -> Tuple[int, int]:
    """(first KV head, count) that this rank of ``layout`` holds."""
    _, n_kv = tp_heads(cfg, layout)
    m, KV = layout.size("model"), cfg.n_kv_heads
    if m <= KV:
        return layout.index("model") * n_kv, n_kv
    return layout.index("model") // (m // KV), 1


def _kv_columns(cfg, layout) -> Optional[slice]:
    """The wk/wv/bk/bv columns of this rank when "model" is a multiple of
    the KV heads: the hd columns of its query group's head."""
    m, KV = layout.size("model"), cfg.n_kv_heads
    if m <= KV or not KV:
        return None
    head = layout.index("model") // (m // KV)
    return slice(head * cfg.hd, (head + 1) * cfg.hd)


def _block(t: torch.Tensor, dim: int, layout, axis) -> torch.Tensor:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n, i = 1, 0
    for a in names:                  # row-major over the named axes
        n *= layout.size(a)
        i = i * layout.size(a) + layout.index(a)
    step = t.shape[dim] // n
    return t.narrow(dim, i * step, step)


def shard_params(params: Any, layout, cfg=None) -> Any:
    """This rank's block of every leaf: sliced along each dim that the
    leaf's spec, filtered for ``layout`` and the leaf's shape, puts on an
    axis; a dim the axis does not divide stays whole, as
    :func:`filter_spec_for_layout` rules.  An int8-packed ``s`` follows
    its ``q`` wherever it has the sliced dim in full.  With ``cfg`` (and
    "model" > 1) the layout is checked (:func:`check_tensor_parallel`)
    and K/V projections follow the heads (:func:`_kv_columns`).  Blocks
    are copies: the full tree can be freed."""
    kv_cols = None
    if cfg is not None:
        check_tensor_parallel(cfg, layout)
        kv_cols = _kv_columns(cfg, layout)

    def one(leaf, spec, kv_head: bool):
        out = leaf
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            if kv_head and axis == "model":
                out = out.narrow(dim, kv_cols.start, cfg.hd)
            else:
                out = _block(out, dim, layout, axis)
        return out.clone(memory_format=torch.contiguous_format)

    def walk(tree, path="", in_experts=False):
        if isinstance(tree, (list, tuple)):
            return [walk(v, path, in_experts) for v in tree]
        packed = isinstance(tree, dict) and set(tree) == {"q", "s"}
        if isinstance(tree, dict) and not packed:
            return {k: walk(v, path + "/" + k, in_experts or k == "experts")
                    for k, v in tree.items()}
        w = tree["q"] if packed else tree
        kv_head = kv_cols is not None and \
            path.rsplit("/", 1)[-1] in _KV_LEAVES
        spec = _spec_for(path, w.dim(), in_experts)
        if kv_head:           # the head's columns, whatever they divide
            spec = tuple(None if a is None else "model" for a in spec)
        else:
            spec = filter_spec_for_layout(spec, layout, w.shape)
        if not packed:
            return one(w, spec, kv_head)
        s = tree["s"]        # per output channel: follows q where full
        s_spec = tuple(a if a is not None and s.shape[d] == w.shape[d]
                       else None for d, a in enumerate(spec))
        return {"q": one(w, spec, kv_head), "s": one(s, s_spec, kv_head)}
    return walk(params)


_KV_LEAVES = ("wk", "wv", "bk", "bv")

