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

import dataclasses
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
    """Raise ``ValueError`` for a "model" axis that the model's heads,
    experts or widths do not fit: the query and KV heads
    (:func:`tp_heads`), the MLP width (dense, and Zamba2's shared
    block), the shared experts' width, the expert count (the real one or
    the reference's padded one must divide) and Mamba2's heads.  The rows
    of ``wo``, ``w_down`` and ``out_proj`` are summed over "model" after
    their products: a dim the axis left whole would be summed once per
    rank."""
    m = layout.size("model")
    if m == 1:
        return
    if cfg.n_heads:
        tp_heads(cfg, layout)
    if cfg.family not in ("moe", "ssm") and cfg.d_ff % m:
        raise ValueError(f"{cfg.name}: the model axis ({m}) does not "
                         f"divide d_ff ({cfg.d_ff}), the rows of w_down")
    if cfg.family == "moe":
        E, shared = cfg.moe.n_experts, cfg.moe.n_shared * cfg.moe.d_expert
        if E % m and cfg.n_experts_padded % m:
            raise ValueError(f"{cfg.name}: the model axis ({m}) divides "
                             f"neither the {E} experts nor their padded "
                             f"count {cfg.n_experts_padded}")
        if shared % m:
            raise ValueError(f"{cfg.name}: the model axis ({m}) does not "
                             f"divide the shared experts' width {shared}")
    if cfg.family in ("ssm", "hybrid"):
        H = _ssm_heads(cfg)
        if H % m:
            raise ValueError(f"{cfg.name}: the model axis ({m}) does not "
                             f"divide the {H} Mamba2 heads")


def _ssm_heads(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim


def expert_range(cfg, layout) -> Tuple[int, int]:
    """(first expert, count) of the real experts this rank holds: a block
    of the real count where "model" divides it, else of the reference's
    padded count (``n_experts_padded``), whose pads the port does not
    hold: a rank may then hold fewer real experts, or none."""
    E, m = cfg.moe.n_experts, layout.size("model")
    per = E // m if E % m == 0 else cfg.n_experts_padded // m
    lo = layout.index("model") * per
    return min(lo, E), max(0, min(per, E - lo))


def _mamba_parts(name: str, cfg, layout):
    """(dim, [(start, length), ...]) of a Mamba2 leaf that this rank
    holds (split by head), or None for a leaf it holds whole."""
    H, P = _ssm_heads(cfg), cfg.ssm.head_dim
    d_in, bc = H * P, 2 * cfg.ssm.n_groups * cfg.ssm.d_state
    m, i = layout.size("model"), layout.index("model")
    h, c = H // m, H * P // m
    return {
        "in_proj": (-1, [(i * c, c), (d_in + i * c, c), (2 * d_in, bc),
                         (2 * d_in + bc + i * h, h)]),
        "conv_w": (-1, [(i * c, c), (d_in, bc)]),
        "conv_b": (-1, [(i * c, c), (d_in, bc)]),
        "A_log": (-1, [(i * h, h)]), "D": (-1, [(i * h, h)]),
        "dt_bias": (-1, [(i * h, h)]),
        "norm_scale": (-1, [(i * c, c)]),
        "out_proj": (-2, [(i * c, c)]),
    }.get(name)


def _take(t: torch.Tensor, dim: int, parts) -> torch.Tensor:
    return torch.cat([t.narrow(dim, a, n) for a, n in parts], dim=dim)


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
    "model" > 1) the layout is checked (:func:`check_tensor_parallel`),
    K/V projections follow the heads (:func:`_kv_columns`), experts are
    split by :func:`expert_range`, and Mamba2's leaves by head
    (:func:`_mamba_parts`: the z, x and dt columns of the rank's heads
    and the whole B and C; the reference's spec splits ``in_proj``'s
    packed columns evenly instead, ROADMAP C).  Blocks are copies: the
    full tree can be freed."""
    kv_cols = None
    special = cfg is not None and layout.size("model") > 1
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

    def by_rule(t, name, in_experts, path):
        """The model-axis block of a leaf the specs do not cover, or
        None."""
        if not special:
            return None
        if in_experts and name in ("w_gate", "w_up", "w_down"):
            lo, n = expert_range(cfg, layout)
            return t.narrow(0, lo, n)
        if "/mamba/" in path:
            plan = _mamba_parts(name, cfg, layout)
            if plan is not None and t.shape[plan[0]] > 1:
                return _take(t, *plan)
        return None

    def walk(tree, path="", in_experts=False):
        if isinstance(tree, (list, tuple)):
            return [walk(v, path, in_experts) for v in tree]
        packed = isinstance(tree, dict) and set(tree) == {"q", "s"}
        if isinstance(tree, dict) and not packed:
            return {k: walk(v, path + "/" + k, in_experts or k == "experts")
                    for k, v in tree.items()}
        w = tree["q"] if packed else tree
        name = path.rsplit("/", 1)[-1]
        ruled = by_rule(w, name, in_experts, path)
        if ruled is not None:
            if not packed:
                return ruled.clone(memory_format=torch.contiguous_format)
            s = tree["s"]
            s_ruled = by_rule(s, name, in_experts, path)
            return {"q": ruled.clone(memory_format=torch.contiguous_format),
                    "s": s.clone() if s_ruled is None else s_ruled.clone(
                        memory_format=torch.contiguous_format)}
        kv_head = kv_cols is not None and name in _KV_LEAVES
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


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf's entry of :func:`train_plan`."""
    zero_dim: Optional[int]
    owned: Any


def train_plan(cfg, layout) -> Any:
    """Per leaf of a rank's param tree (the tree ``Model.shard`` gives),
    what a sharded train step needs: a :class:`LeafPlan` (``zero_dim``,
    ``owned``).

    ``zero_dim``: the dim whose block along "data" this rank's AdamW
    state holds (the reference's ``opt_pspecs``: :func:`zero_shard`'s
    largest dim >= 16 that the param spec leaves replicated, where the
    "data" axis divides it), or None (every data rank holds it whole).

    ``owned``: which of the leaf's elements this rank counts in the
    global gradient norm, so that each element of the whole model is
    counted once over "model": True (a block of its own), False (a copy
    that rank 0 of "model", or of its KV group, counts), or a bool
    tensor over the last dim (Mamba2's ``in_proj`` and conv, whose B and
    C columns every rank holds alike)."""
    from ..models.transformer import Model
    whole = Model(cfg, torch.device("cpu")).init_shapes()
    m, i = layout.size("model"), layout.index("model")
    data = layout.size("data")
    kv_group = m // cfg.n_kv_heads if cfg.n_kv_heads and \
        m > cfg.n_kv_heads else 1
    bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state

    def owned(path, name, spec, in_experts):
        if m == 1:
            return True
        if name in _KV_LEAVES and kv_group > 1 and "/attn/" in path:
            return i % kv_group == 0
        if in_experts and name in ("w_gate", "w_up", "w_down"):
            return True
        if "/mamba/" in path and name in ("in_proj", "conv_w", "conv_b"):
            c = _ssm_heads(cfg) * cfg.ssm.head_dim // m
            h = _ssm_heads(cfg) // m
            mask = [True] * (2 * c if name == "in_proj" else c) + \
                [i == 0] * bc + ([True] * h if name == "in_proj" else [])
            return torch.tensor(mask)
        return "model" in spec or i == 0

    def walk(tree, path="", in_experts=False):
        if isinstance(tree, (list, tuple)):
            return [walk(v, path, in_experts) for v in tree]
        if isinstance(tree, dict):
            return {k: walk(v, path + "/" + k, in_experts or k == "experts")
                    for k, v in tree.items()}
        name = path.rsplit("/", 1)[-1]
        spec = _spec_for(path, tree.dim(), in_experts)
        parts = _mamba_parts(name, cfg, layout) if "/mamba/" in path \
            else None
        if parts is not None and m > 1:       # split by head
            spec = tuple("model" if d == parts[0] % tree.dim() else a
                         for d, a in enumerate(spec))
        z = zero_shard(spec, tuple(tree.shape))
        zero_dim = z.index("data") if "data" in z else None
        if zero_dim is not None and (data == 1 or
                                     tree.shape[zero_dim] % data):
            zero_dim = None
        local = filter_spec_for_layout(spec, layout, tree.shape)
        return LeafPlan(zero_dim, owned(path, name, local, in_experts))
    return walk(whole)


_KV_LEAVES = ("wk", "wv", "bk", "bv")

