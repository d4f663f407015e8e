"""FLOPs, HBM bytes and resident bytes per device of one cell
(architecture x shape x layout), from the model code's own shapes.

The reference's ``roofline/hlo_cost.py`` parses XLA's optimised HLO; the
port has no HLO, so this module counts what the port's model code does:

* weight products: 2·M·N·K for every product a token makes with a weight
  (the block of it that one device holds under the layout's specs), the
  head's included; MoE experts by their capacity slots, as ``apply_moe``
  computes them, as many experts as rank 0 holds (a block of the
  reference's padded count where "model" does not divide the real one);
* attention: the S² products, causal (each query sees the keys up to it,
  within a window), 2·2·hd per query-key pair and head;
* Mamba2's SSD: its five chunk products (``ssd_chunked``);
* elementwise and norm work, by the sizes involved (estimates: a norm
  4 FLOPs per element, a softmax 5 per score, SwiGLU 5 per element, RoPE
  6, a residual add 1, the loss head 5 per logit, AdamW 15 per leaf
  element);
* HBM bytes: every product's operands read once and its output written
  once, the attention's q, k, v and output once (no S² traffic: the
  flash kernel keeps it on chip), each elementwise pass its input and
  output once, the weights once per pass, a decode step's cache once;
* resident bytes: parameters and optimizer state exactly, from the
  shape-only tree (``Model.init_shapes``) cut to one device's blocks by
  ``launch/shardings.py shard_params``; activations, logits and cache by
  the shapes the model code allocates (estimates).

A training step is the forward, twice its weight products and
elementwise work for the backward (once for a product with a constant,
the SSD's running sum), 3.5 times the attention's products
for the flash backward (dK/dV recomputes S and makes dP, dV and dK; dQ
recomputes S and dP and makes dQ), and with ``remat`` a second forward of
each layer but its last product where nothing saves that product's
output (``w_down`` without a post-norm, Mamba2's ``out_proj``:
``torch.utils.checkpoint`` stops recomputing once the tensors the
backward needs are back).  Collectives are predicted from the same
shapes with ``launch/mesh.py``'s ring rule.

``roofline/op_cost.py`` counts the program itself; the dry run holds
these figures beside its count (``predicted``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from .analysis import CollectiveStats

#: the axes a batch and the gradient all-reduce run over
DATA_AXES = ("pod", "data")
#: weights a token multiplies in the dense/MoE/SSM layers (per-token
#: products); experts are counted by their capacity slots
_TOKEN_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "in_proj", "out_proj", "router")


@dataclasses.dataclass
class CellCost:
    flops: float
    bytes: float
    matmul_flops: float
    attention_flops: float
    elementwise_flops: float
    param_bytes: int
    opt_bytes: int
    grad_bytes: int
    activation_bytes: float
    cache_bytes: int
    output_bytes: float
    collectives: CollectiveStats
    note: str = ""

    def cost(self) -> Dict[str, float]:
        """The reference's cost dict: "flops" and "bytes accessed"."""
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "matmul_flops": self.matmul_flops,
                "attention_flops": self.attention_flops,
                "elementwise_flops": self.elementwise_flops}

    def memory(self) -> Dict[str, float]:
        """Resident bytes by kind; the total is :func:`predicted_peak`
        (the logits are part of the activations' peak)."""
        return dict(param_bytes=float(self.param_bytes),
                    opt_bytes=float(self.opt_bytes),
                    grad_bytes=float(self.grad_bytes),
                    activation_bytes=float(self.activation_bytes),
                    cache_bytes=float(self.cache_bytes),
                    output_bytes=float(self.output_bytes),
                    predicted_peak_bytes=predicted_peak(self),
                    total_per_device_gb=predicted_peak(self) / 2 ** 30)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _nbytes(tree)


def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_numel(v) for v in tree)
    return tree.numel()


def _weight(w):
    """A weight leaf or an int8-packed {q, s} → the tensor of its shape."""
    return w["q"] if isinstance(w, dict) and "q" in w else w


def _token_products(block: Dict[str, Any]) -> List[tuple]:
    """(K, N) of every per-token product in a layer's tree."""
    out = []

    def walk(node, key):
        if isinstance(node, dict) and not ("q" in node and "s" in node):
            for k, v in node.items():
                if k != "experts":
                    walk(v, k)
            return
        w = _weight(node)
        if key in _TOKEN_WEIGHTS and w.dim() == 2:
            out.append(tuple(w.shape))
    walk(block, "")
    return out


def _keys_seen(S: int, window: int) -> int:
    """Σ over query positions of the keys a causal query sees."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def local_params(cfg, layout, int8_weights: bool = False):
    """(the shape-only params, the block of them that rank 0 of
    ``layout`` holds, the note).

    Experts are split as the port splits them (``shardings
    .expert_range``): where "model" does not divide the real count,
    blocks of the reference's padded count (``n_experts_padded /
    model`` a device, what the reference's spec gives one), whose pads
    no rank holds, so rank 0 holds the most.  Mamba2 is split by head.
    The note says where the layout is costed by the specs alone (the
    port's tensor parallelism refuses it), where the experts follow the
    padded count, and where the port splits Mamba2 otherwise than the
    reference's spec."""
    from ..launch.shardings import check_tensor_parallel, shard_params
    from ..models.transformer import Model
    tree = Model(cfg, torch.device("cpu")).init_shapes()
    if int8_weights:
        from ..quant.quantizer import pack_weights_int8
        tree = pack_weights_int8(tree, cfg=cfg)
    notes, tp_cfg, m = [], cfg, layout.size("model")
    try:
        check_tensor_parallel(cfg, layout)
    except ValueError as e:
        notes.append(f"costed by the specs alone: {e}")
        tp_cfg = None
    E, Ep = cfg.moe.n_experts, cfg.n_experts_padded
    if tp_cfg is not None and E and E % m:
        notes.append(f"experts split as blocks of the reference's padded "
                     f"{Ep}, {Ep // m} a device (the port holds only the "
                     f"{E} real ones: the last ranks hold fewer)")
    if tp_cfg is not None and m > 1 and cfg.family in ("ssm", "hybrid"):
        notes.append("Mamba2 split by head (z, x, dt columns of the "
                     "rank's heads, B and C whole on every rank), where "
                     "the reference's spec splits in_proj's packed "
                     "columns evenly (ROADMAP C)")
    return tree, shard_params(tree, layout, tp_cfg), "; ".join(notes)


def opt_state_bytes(tree, local, layout) -> int:
    """AdamW's state per device: float32 master, m and v of every leaf
    (their largest replicated dim split over "data", ZeRO-style, where it
    divides) and the int32 step."""
    from ..launch.shardings import param_pspecs, zero_shard
    specs = param_pspecs(tree)
    data = layout.size("data")
    total = 0

    def walk(g, l, s):
        nonlocal total
        if isinstance(g, dict):
            for k in g:
                walk(g[k], l[k], s[k])
        elif isinstance(g, (list, tuple)):
            for a, b, c in zip(g, l, s):
                walk(a, b, c)
        else:
            z = zero_shard(s, tuple(g.shape))
            div = 1
            if "data" in z and data > 1:
                dim = z.index("data")
                div = data if g.shape[dim] % data == 0 else 1
            total += 3 * 4 * (l.numel() // div)
    walk(tree, local, specs)
    return total + 4


def cell_cost(cfg, shape, layout, *, microbatches: int = 8,
              remat: bool = True, int8_weights: bool = False,
              int8_kv: bool = False) -> CellCost:
    """The cost of one device's share of ``shape`` (a ``configs.SHAPES``
    cell or any ``ShapeCell``) under ``layout`` (``launch.mesh``; a
    shape-only layout will do).  Allocates nothing."""
    tree, local, note = local_params(cfg, layout, int8_weights)
    a = torch.empty((), dtype=cfg.dtype).element_size()
    m = layout.size("model")
    dp = layout.size(("pod", "data"))
    kind = shape.kind
    b = max(1, math.ceil(shape.global_batch / dp))
    front = cfg.frontend_len or (256 if cfg.frontend == "patch" else
                                 64 if cfg.frontend == "frame" else 0)
    S_new = 1 if kind == "decode" else shape.seq_len + front
    S_ctx = shape.seq_len                       # decode: the cache depth
    T = b * S_new
    d, hd = cfg.d_model, cfg.hd
    head = local["embed"] if cfg.tie_embeddings else _weight(
        local["lm_head"])
    V_l = head.shape[0] if cfg.tie_embeddings else head.shape[1]

    # ---- per-layer structure: (block, is_attention, window, family)
    apps = []
    for i, p in enumerate(local["layers"]):
        window = cfg.sliding_window if (cfg.sliding_window and i % 2 == 0) \
            else 0
        apps.append((p, "attn" in p, window))
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            apps.append((local["shared_attn"], True, 0))

    mm = ew = att = 0.0
    last = 0.0               # products that remat does not recompute
    one_sided = 0.0          # products with a constant operand
    byts = 0.0
    coll = _Colls(layout)
    for p, is_attn, window in apps:
        for K, N in _token_products(p):
            mm += 2.0 * T * K * N
            byts += (T * (K + N)) * a
        if "mlp" in p and not cfg.post_norms:
            last += 2.0 * T * math.prod(_weight(p["mlp"]["w_down"]).shape)
        if "mamba" in p:
            last += 2.0 * T * math.prod(_weight(p["mamba"]["out_proj"])
                                        .shape)
        if is_attn:
            H_l = _weight(p["attn"]["wq"]).shape[1] // hd
            KV_l = _weight(p["attn"]["wk"]).shape[1] // hd
            keys = b * (_keys_seen(S_new, window) if kind != "decode"
                        else min(S_ctx, window or S_ctx))
            att += 4.0 * H_l * hd * keys
            ew += 5.0 * H_l * keys + 6.0 * T * (H_l + KV_l) * hd
            byts += T * (2 * H_l + 2 * KV_l) * hd * a      # q, k, v, out
            byts += 2 * T * (H_l + KV_l) * hd * a          # RoPE
            if kind == "decode":                           # the cache
                kv_a = 1 if int8_kv else a
                byts += 2 * b * min(S_ctx, window or S_ctx) * KV_l * hd \
                    * kv_a
            coll.reduce(T * d * a)
        n_norms = 4 if cfg.post_norms else 2
        ew += T * d * (4.0 * n_norms + 2.0)
        byts += T * d * a * (2 * n_norms + 3 * 2)
        if "mlp" in p:
            ff_l = _weight(p["mlp"]["w_gate"]).shape[1]
            ew += 5.0 * T * ff_l
            byts += 3 * T * ff_l * a
            coll.reduce(T * d * a)
        if "moe" in p:
            mm_e, by_e, ew_e = _experts(cfg, p["moe"], b, S_new, a)
            mm, byts, ew = mm + mm_e, byts + by_e, ew + ew_e
            coll.reduce(T * d * a)               # the experts' shares
        if "mamba" in p:
            mm_s, by_s, ew_s, one_s = _ssd(cfg, p["mamba"], b, S_new, kind)
            mm, byts, ew = mm + mm_s, byts + by_s, ew + ew_s
            one_sided += one_s
            coll.reduce(T * 4)                   # the norm's sum of squares
            coll.reduce(T * d * a)
    # embedding, final norm, head
    byts += 2 * T * d * a
    ew += 4.0 * T * d
    head_mm = 2.0 * T * d * V_l
    mm += head_mm
    byts += T * (d + V_l) * a + _nbytes(head)
    out_bytes = float(T * cfg.vocab_padded * a)
    byts += out_bytes
    coll.reduce(T * d * a)                        # vocab-parallel embed
    coll.gather(T * V_l * a)                      # column-split head
    param_bytes = _tree_bytes(local)
    numel = _tree_numel(local)

    # ---- resident bytes
    act = _activation_bytes(cfg, local, T, V_l, a, m)
    cache = 0
    if kind == "decode":
        kv_a = 1 if int8_kv else a
        for p, is_attn, window in apps:
            if is_attn:
                KV_l = _weight(p["attn"]["wk"]).shape[1] // hd
                cache += 2 * b * min(S_ctx, window or S_ctx) * KV_l * hd \
                    * kv_a
            if "mamba" in p:
                cache += _ssm_state_bytes(cfg, p["mamba"], b)
    opt = grad = 0
    if kind != "train":
        byts += param_bytes                       # weights read once
    else:
        passes = 4.0 if remat else 3.0            # fwd, 2 x bwd, remat
        recompute = mm - head_mm - last if remat else 0.0
        mm, ew, byts = (3.0 * mm - one_sided + recompute, ew * 3.0,
                        byts * passes)
        att = att * (5.5 if remat else 4.5)
        byts += param_bytes * passes * microbatches
        ew += 5.0 * T * cfg.vocab_padded + 15.0 * numel
        opt = opt_state_bytes(tree, local, layout)
        # a microbatch's grads in the params' dtypes, and (from two
        # microbatches) their float32 sums
        grad = param_bytes + (4 * numel if microbatches > 1 else 0)
        byts += 2 * opt + 2 * grad + 2 * param_bytes   # AdamW
        # the larger of a microbatch's backward and AdamW's update, which
        # builds the clipped float32 grads, new m, v and masters and the
        # new params before the old ones go
        act = max(_train_activation_bytes(cfg, local,
                                          max(1, T // microbatches), V_l, a,
                                          remat),
                  (16 + a) * numel)
        coll.train(param_bytes)
        out_bytes = 0.0
    return CellCost(flops=mm + att + ew, bytes=byts, matmul_flops=mm,
                    attention_flops=att, elementwise_flops=ew,
                    param_bytes=param_bytes, opt_bytes=opt,
                    grad_bytes=grad, activation_bytes=act,
                    cache_bytes=cache, output_bytes=out_bytes,
                    collectives=coll.stats(), note=note)


def _experts(cfg, moe, b, S, a):
    """(products, bytes, elementwise) of one MoE layer's experts on this
    device: its experts' capacity slots (``moe.capacity``)."""
    from ..models.moe import capacity
    E = cfg.moe.n_experts
    E_l = _weight(moe["experts"]["w_gate"]).shape[0]
    fe = cfg.moe.d_expert
    C = capacity(S, cfg.moe.top_k, E, cfg.moe.capacity_factor)
    slots = b * E_l * C
    d = cfg.d_model
    mm = 2.0 * slots * 3 * d * fe
    byts = slots * (3 * d + 3 * fe) * a
    ew = 5.0 * slots * fe + 3.0 * b * S * cfg.moe.top_k * d
    return mm, byts, ew


def _ssd(cfg, mamba, b, S, kind):
    """(products, bytes, elementwise, products whose backward is one
    product) of one Mamba2 layer's SSD and conv (the projections are
    per-token products, counted apart)."""
    s = cfg.ssm
    d_in = _weight(mamba["out_proj"]).shape[0]
    H = d_in // s.head_dim
    P, N, c = s.head_dim, s.d_state, s.chunk
    ch = _weight(mamba["conv_w"]).shape[1]
    T = b * S
    if kind == "decode":       # the state's update is elementwise
        mm = 2.0 * T * H * P * N
        ew = 2.0 * T * s.d_conv * ch + 8.0 * T * H * P * N
        byts = 2 * b * H * P * N * 4 + T * ch * 4
        return mm, byts, ew, 0.0
    c = min(c, S)
    # the running sum of the decays (a product with a constant
    # lower-triangular matrix: one product in the backward, not two),
    # C·B, the intra-chunk product, the state in and out
    csum = 2.0 * T * c * H
    mm = csum + 2.0 * T * (c * N + H * c * P + 2 * H * P * N)
    ew = 2.0 * T * s.d_conv * ch + 4.0 * T * c * H + 10.0 * T * H * P
    byts = 4 * (T * c * H * 2 + T * H * P * 6 + T * ch * 2)
    return mm, byts, ew, csum


def _ssm_state_bytes(cfg, mamba, b) -> int:
    s = cfg.ssm
    d_in = _weight(mamba["out_proj"]).shape[0]
    ch = _weight(mamba["conv_w"]).shape[1]
    a = torch.empty((), dtype=cfg.dtype).element_size()
    return b * (s.d_conv - 1) * ch * a + \
        b * (d_in // s.head_dim) * s.head_dim * s.d_state * 4


def _activation_bytes(cfg, local, T, V_l, a, m) -> float:
    """Peak bytes a forward holds besides the weights: the larger of one
    layer's transients (residual, float32 norm copies, q/k/v/out, the
    MLP's gate, up and product) and the head's (the normed input, the
    logits and, split by column, the gathered parts)."""
    d = cfg.d_model
    layer = 0.0
    for p in local["layers"]:
        t = 2 * T * d * a + 3 * T * d * 4
        if "attn" in p:
            t += T * (_weight(p["attn"]["wq"]).shape[1] * 2 +
                      _weight(p["attn"]["wk"]).shape[1] * 2) * a
        if "mlp" in p:
            t += 4 * T * _weight(p["mlp"]["w_gate"]).shape[1] * a
        if "mamba" in p:
            t += 3 * T * _weight(p["mamba"]["in_proj"]).shape[1] * a
        layer = max(layer, t)
    head = T * d * (a + 8) + T * cfg.vocab_padded * a * (2 if m > 1 else 1)
    return max(layer, head)


def _train_activation_bytes(cfg, local, Tm, V_l, a, remat) -> float:
    """A microbatch's saved activations: every layer's inputs with remat,
    else what each layer saves for its backward (norm inputs in float32,
    q, k, v, the attention output and its log-sum-exp, the MLP's gate,
    up and product), plus the loss head (logits, their float32 copy and
    its gradient)."""
    d = cfg.d_model
    per = []
    for p in local["layers"]:
        t = Tm * d * a + 2 * Tm * d * 4
        if "attn" in p:
            q = _weight(p["attn"]["wq"]).shape[1]
            kv = _weight(p["attn"]["wk"]).shape[1]
            t += Tm * (2 * q + 2 * kv) * a + Tm * (q // cfg.hd) * 4
        if "mlp" in p:
            t += 4 * Tm * _weight(p["mlp"]["w_gate"]).shape[1] * a
        if "mamba" in p:
            t += 3 * Tm * _weight(p["mamba"]["in_proj"]).shape[1] * a
        per.append(t)
    saved = (len(per) * Tm * d * a + max(per)) if remat else sum(per)
    return saved + Tm * cfg.vocab_padded * (a + 3 * 4)


class _Colls:
    """The collectives one device's share of a cell makes, by the ring
    rule of ``launch/mesh.py``: an ``all_reduce`` after each row-split
    product (``wo``, ``w_down``, ``out_proj``, the experts' weighted
    shares: the port's expert parallelism sums them, where the
    reference's GSPMD dispatches by all-to-all) and of the vocab-parallel
    embedding and Mamba2's norm, an ``all_gather`` of the column-split
    head, and in training the backward's twins plus the gradient
    ``all_reduce`` over the data axes.  Operand bytes of collectives whose
    group spans nodes (``Layout.crosses_nodes``: in the production
    layouts the data axes, never "model") are also summed apart, and those
    over the pod axis as ``cross_pod_bytes``."""

    def __init__(self, layout):
        self.m, self.dp = layout.size("model"), layout.size(DATA_AXES)
        self.model_inter = layout.crosses_nodes("model")
        self.data_inter = layout.crosses_nodes(DATA_AXES)
        self.pod = layout.size("pod") > 1
        self.counts: Dict[str, int] = {}
        self.operand: Dict[str, int] = {}
        self.wire: Dict[str, int] = {}
        self.internode = self.cross_pod = 0

    def _add(self, op: str, nbytes: float, g: int, n: int = 1,
             internode: bool = False) -> None:
        if g == 1:
            return
        w = (2 if op == "all-reduce" else 1) * (g - 1) / g * nbytes
        self.counts[op] = self.counts.get(op, 0) + n
        self.operand[op] = self.operand.get(op, 0) + int(nbytes * n)
        self.wire[op] = self.wire.get(op, 0) + int(w * n)
        if internode:
            self.internode += int(nbytes * n)

    def reduce(self, nbytes):
        self._add("all-reduce", nbytes, self.m, internode=self.model_inter)

    def gather(self, nbytes):
        self._add("all-gather", nbytes, self.m, internode=self.model_inter)

    def train(self, grad_bytes):
        for d in (self.counts, self.operand, self.wire):
            for k in d:
                d[k] *= 2                          # the backward's twins
        self.internode *= 2
        self._add("all-reduce", grad_bytes, self.dp,
                  internode=self.data_inter)
        if self.pod:
            self.cross_pod += int(grad_bytes)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.counts),
                               operand_bytes=dict(self.operand),
                               wire_bytes=dict(self.wire),
                               cross_pod_bytes=self.cross_pod,
                               internode_bytes=self.internode)


def predicted_peak(c: CellCost) -> float:
    """Peak resident bytes of one device: weights, optimizer state,
    gradients, cache and the activations' peak."""
    return float(c.param_bytes + c.opt_bytes + c.grad_bytes + c.cache_bytes
                 + c.activation_bytes)

