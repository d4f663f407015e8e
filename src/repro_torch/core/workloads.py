"""Paper QNN workload topologies (Table 5), built in the graph IR.

Scaled-down but structurally faithful versions of the paper's four
evaluation networks — used by benchmarks (Table 6 / Fig 21 / Fig 22
reproductions) and tests.  Name encodes quantization: wXaY.

  TFC-w2a2   3-layer MLP                      (f)
  CNV-w2a2   VGG10-like conv stack            (c, f)
  RN8-w3a3   ResNet-8 with residuals          (c, 8, r)
  MNv1-w4a4  MobileNet-v1 depthwise-separable (c, d, 8)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .graph import Graph
from .intervals import ScaledIntRange


@dataclasses.dataclass
class QNNWorkload:
    name: str
    graph: Graph
    input_range: Dict[str, ScaledIntRange]
    input_shape: Tuple[int, ...]
    weight_bits: int
    act_bits: int


def _quant(g: Graph, x: str, scale, bits: int, signed: int, out: str,
           narrow: int = 0, zp: float = 0.0) -> str:
    s = g.add_initializer(scale)
    z = g.add_initializer(zp)
    b = g.add_initializer(float(bits))
    g.add_node("Quant", [x, s, z, b], [out], dict(signed=signed,
                                                  narrow=narrow))
    return out


def _qlinear(g: Graph, rng, x: str, k: int, m: int, wbits: int, abits: int,
             prefix: str, relu: bool = True, per_channel: bool = True,
             bn: bool = True, final: bool = False) -> str:
    """Quant MatMul + (bias) + (BatchNorm lowered) + Relu + Quant."""
    W = rng.normal(size=(k, m)) * (1.5 / np.sqrt(k))
    w_name = g.add_initializer(W, f"{prefix}_W")
    if per_channel:
        s_w = np.abs(W).max(axis=0) / (2 ** (wbits - 1) - 1)
    else:
        s_w = np.abs(W).max() / (2 ** (wbits - 1) - 1)
    wq = _quant(g, w_name, np.maximum(s_w, 1e-8), wbits, 1,
                f"{prefix}_Wq")
    mm = f"{prefix}_mm"
    g.add_node("MatMul", [x, wq], [mm])
    cur = mm
    bias = rng.normal(size=(m,)) * 0.1
    b_name = g.add_initializer(bias, f"{prefix}_B")
    g.add_node("Add", [cur, b_name], [f"{prefix}_gemm"])
    cur = f"{prefix}_gemm"
    if bn:
        mvals = np.abs(rng.normal(size=(m,))) * 0.5 + 0.05
        nvals = rng.normal(size=(m,)) * 0.2
        mn = g.add_initializer(mvals, f"{prefix}_M")
        nn = g.add_initializer(nvals, f"{prefix}_N")
        g.add_node("Mul", [cur, mn], [f"{prefix}_bnm"])
        g.add_node("Add", [f"{prefix}_bnm", nn], [f"{prefix}_bn"])
        cur = f"{prefix}_bn"
    if final:
        return cur
    if relu:
        g.add_node("Relu", [cur], [f"{prefix}_act"])
        cur = f"{prefix}_act"
        out = _quant(g, cur, 0.11, abits, 0, f"{prefix}_out")
    else:
        out = _quant(g, cur, 0.11, abits, 1, f"{prefix}_out")
    return out


def _qconv(g: Graph, rng, x: str, cin: int, cout: int, wbits: int,
           abits: int, prefix: str, k: int = 3, stride: int = 1,
           pad: int = 1, groups: int = 1, relu: bool = True,
           signed_act: bool = False) -> str:
    W = rng.normal(size=(cout, cin // groups, k, k)) * \
        (1.5 / np.sqrt(cin // groups * k * k))
    w_name = g.add_initializer(W, f"{prefix}_W")
    s_w = np.abs(W).reshape(cout, -1).max(axis=1).reshape(cout, 1, 1, 1)
    s_w = np.maximum(s_w / (2 ** (wbits - 1) - 1), 1e-8)
    wq = _quant(g, w_name, s_w, wbits, 1, f"{prefix}_Wq")
    conv = f"{prefix}_conv"
    g.add_node("Conv", [x, wq], [conv],
               dict(stride=stride, pad=pad, groups=groups))
    # BatchNorm lowered to Mul/Add (per channel, shape (C,1,1))
    mvals = (np.abs(rng.normal(size=(cout, 1, 1))) * 0.5 + 0.05)
    nvals = rng.normal(size=(cout, 1, 1)) * 0.2
    mn = g.add_initializer(mvals, f"{prefix}_M")
    nn = g.add_initializer(nvals, f"{prefix}_N")
    g.add_node("Mul", [conv, mn], [f"{prefix}_bnm"])
    g.add_node("Add", [f"{prefix}_bnm", nn], [f"{prefix}_bn"])
    cur = f"{prefix}_bn"
    if relu:
        g.add_node("Relu", [cur], [f"{prefix}_act"])
        cur = f"{prefix}_act"
    out = _quant(g, cur, 0.13, abits, 1 if signed_act else 0,
                 f"{prefix}_out")
    return out


def make_tfc(wbits: int = 2, abits: int = 2, width: int = 64,
             in_dim: int = 49, seed: int = 0) -> QNNWorkload:
    """TFC: 3-layer MLP on (downscaled) MNIST-like input."""
    rng = np.random.default_rng(seed)
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 1.0 / 127, 8, 0, "Xq")
    x = _qlinear(g, rng, x, in_dim, width, wbits, abits, "fc1")
    x = _qlinear(g, rng, x, width, width, wbits, abits, "fc2")
    x = _qlinear(g, rng, x, width, 10, wbits, abits, "fc3", final=True,
                 bn=False)
    g.outputs = [x]
    return QNNWorkload("TFC-w%da%d" % (wbits, abits), g,
                       {"X": ScaledIntRange(lo=np.zeros(()), hi=np.ones(()))},
                       (1, in_dim), wbits, abits)


def make_cnv(wbits: int = 2, abits: int = 2, ch: int = 16,
             img: int = 16, seed: int = 1) -> QNNWorkload:
    """CNV: VGG10-like — conv-conv-pool x3 then two FC layers."""
    rng = np.random.default_rng(seed)
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 1.0 / 127, 8, 1, "Xq")
    cin, cur_img = 3, img
    for blk, cout in enumerate([ch, 2 * ch, 4 * ch]):
        x = _qconv(g, rng, x, cin, cout, wbits, abits, f"b{blk}c0", pad=1)
        x = _qconv(g, rng, x, cout, cout, wbits, abits, f"b{blk}c1", pad=1)
        g.add_node("MaxPool", [x], [f"b{blk}_pool"], dict(kernel=2, stride=2))
        x = f"b{blk}_pool"
        cin, cur_img = cout, cur_img // 2
    g.add_node("GlobalAveragePool", [x], ["gap"],
               dict(window=cur_img * cur_img))
    g.add_node("Flatten", ["gap"], ["flat"])
    x = _qlinear(g, rng, "flat", cin, 2 * ch, wbits, abits, "fc1")
    x = _qlinear(g, rng, x, 2 * ch, 10, wbits, abits, "fc2", final=True,
                 bn=False)
    g.outputs = [x]
    return QNNWorkload("CNV-w%da%d" % (wbits, abits), g,
                       {"X": ScaledIntRange(lo=-np.ones(()), hi=np.ones(()))},
                       (1, 3, img, img), wbits, abits)


def make_rn8(wbits: int = 3, abits: int = 3, ch: int = 16,
             img: int = 16, seed: int = 2) -> QNNWorkload:
    """ResNet-8: stem + 3 residual stages; 8-bit first/last layers."""
    rng = np.random.default_rng(seed)
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 1.0 / 127, 8, 1, "Xq")
    x = _qconv(g, rng, x, 3, ch, 8, abits, "stem", pad=1)  # 8-bit first
    cin = ch
    for stage, cout in enumerate([ch, 2 * ch, 4 * ch]):
        stride = 1 if stage == 0 else 2
        skip = x
        y = _qconv(g, rng, x, cin, cout, wbits, abits, f"s{stage}c0",
                   stride=stride, pad=1)
        y = _qconv(g, rng, y, cout, cout, wbits, abits, f"s{stage}c1",
                   pad=1, relu=False, signed_act=True)
        if stride != 1 or cin != cout:
            skip = _qconv(g, rng, skip, cin, cout, wbits, abits,
                          f"s{stage}sc", k=1, stride=stride, pad=0,
                          relu=False, signed_act=True)
        add = f"s{stage}_add"
        g.add_node("Add", [y, skip], [add])
        g.add_node("Relu", [add], [f"s{stage}_act"])
        x = _quant(g, f"s{stage}_act", 0.13, abits, 0, f"s{stage}_out")
        cin = cout
    g.add_node("GlobalAveragePool", [x], ["gap"],
               dict(window=(img // 4) * (img // 4)))
    g.add_node("Flatten", ["gap"], ["flat"])
    x = _qlinear(g, rng, "flat", cin, 100, 8, 8, "head", final=True,
                 bn=False)  # 8-bit last
    g.outputs = [x]
    return QNNWorkload("RN8-w%da%d" % (wbits, abits), g,
                       {"X": ScaledIntRange(lo=-np.ones(()), hi=np.ones(()))},
                       (1, 3, img, img), wbits, abits)


def make_mnv1(wbits: int = 4, abits: int = 4, ch: int = 8,
              img: int = 16, depth: int = 4, seed: int = 3) -> QNNWorkload:
    """MobileNet-v1: stem conv + depthwise-separable blocks."""
    rng = np.random.default_rng(seed)
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 1.0 / 127, 8, 1, "Xq")
    x = _qconv(g, rng, x, 3, ch, 8, abits, "stem", stride=2, pad=1)
    cin = ch
    for blk in range(depth):
        cout = min(cin * 2, 8 * ch) if blk % 2 == 1 else cin
        # depthwise 3x3 (per-channel activation scaling per paper §6.2)
        x = _qconv(g, rng, x, cin, cin, wbits, abits, f"dw{blk}",
                   groups=cin, pad=1)
        # pointwise 1x1
        x = _qconv(g, rng, x, cin, cout, wbits, abits, f"pw{blk}", k=1,
                   pad=0)
        cin = cout
    g.add_node("GlobalAveragePool", [x], ["gap"],
               dict(window=(img // 2) * (img // 2)))
    g.add_node("Flatten", ["gap"], ["flat"])
    x = _qlinear(g, rng, "flat", cin, 100, 8, 8, "head", final=True,
                 bn=False)
    g.outputs = [x]
    return QNNWorkload("MNv1-w%da%d" % (wbits, abits), g,
                       {"X": ScaledIntRange(lo=-np.ones(()), hi=np.ones(()))},
                       (1, 3, img, img), wbits, abits)


def make_hsw(wbits: int = 3, abits: int = 4, width: int = 48,
             in_dim: int = 16, seed: int = 7) -> QNNWorkload:
    """HSW: hard-swish/Silu MLP — the non-ReLU threshold-conversion
    stressor (beyond the paper's ReLU-only workloads).

    Layer tails exercise every certificate outcome:
      * fc1 ends in Silu + *unsigned* Quant: the proven range straddles
        the stationary point (x* ≈ −1.28) so transfer composition cannot
        decide, but the quantized output is monotone (the dip saturates
        at level 0) — certified by the on-grid fallback;
      * fc2 ends in Tanh behind a mixed-sign BatchNorm multiplier:
        per-channel reversed directions, certified ``representable`` by
        transfer composition (signed per-channel out_scale);
      * fc3 ends in hard-swish + *signed* fine-grained Quant: the dip
        around x* = −1.5 is resolved by the quantizer — uncertifiable,
        left as an elementwise chain for meta-kernel pricing.
    """
    rng = np.random.default_rng(seed)
    g = Graph(inputs=["X"], outputs=[])
    x = _quant(g, "X", 1.0 / 127, 8, 0, "Xq")

    def layer(x: str, k: int, m: int, act: str, prefix: str,
              signed_act: int, mixed_bn: bool = False) -> str:
        W = rng.normal(size=(k, m)) * (1.5 / np.sqrt(k))
        w_name = g.add_initializer(W, f"{prefix}_W")
        s_w = np.abs(W).max(axis=0) / (2 ** (wbits - 1) - 1)
        wq = _quant(g, w_name, np.maximum(s_w, 1e-8), wbits, 1,
                    f"{prefix}_Wq")
        g.add_node("MatMul", [x, wq], [f"{prefix}_mm"])
        b_name = g.add_initializer(rng.normal(size=(m,)) * 0.1,
                                   f"{prefix}_B")
        g.add_node("Add", [f"{prefix}_mm", b_name], [f"{prefix}_gemm"])
        mvals = np.abs(rng.normal(size=(m,))) * 0.5 + 0.05
        if mixed_bn:
            mvals = mvals * np.where(np.arange(m) % 3 == 0, -1.0, 1.0)
        mn = g.add_initializer(mvals, f"{prefix}_M")
        nn = g.add_initializer(rng.normal(size=(m,)) * 0.2, f"{prefix}_N")
        g.add_node("Mul", [f"{prefix}_gemm", mn], [f"{prefix}_bnm"])
        g.add_node("Add", [f"{prefix}_bnm", nn], [f"{prefix}_bn"])
        g.add_node(act, [f"{prefix}_bn"], [f"{prefix}_act"])
        return _quant(g, f"{prefix}_act", 0.11, abits, signed_act,
                      f"{prefix}_out")

    x = layer(x, in_dim, width, "Silu", "fc1", signed_act=0)
    x = layer(x, width, width, "Tanh", "fc2", signed_act=1, mixed_bn=True)
    x = layer(x, width, width, "HardSwish", "fc3", signed_act=1)
    x = _qlinear(g, rng, x, width, 10, wbits, abits, "head", final=True,
                 bn=False)
    g.outputs = [x]
    return QNNWorkload("HSW-w%da%d" % (wbits, abits), g,
                       {"X": ScaledIntRange(lo=np.zeros(()), hi=np.ones(()))},
                       (1, in_dim), wbits, abits)


WORKLOADS = {
    "TFC-w2a2": make_tfc,
    "CNV-w2a2": make_cnv,
    "RN8-w3a3": make_rn8,
    "MNv1-w4a4": make_mnv1,
}

# non-ReLU variants kept out of WORKLOADS: the paper's Table 5/6
# reproductions (and the compiled-backend bit-exactness suite) iterate the
# four paper networks; benchmarks and threshold-conversion tests iterate
# ALL_WORKLOADS.
EXTRA_WORKLOADS = {
    "HSW-w3a4": make_hsw,
}

ALL_WORKLOADS = {**WORKLOADS, **EXTRA_WORKLOADS}


def make_all(**kw) -> List[QNNWorkload]:
    return [fn() for fn in WORKLOADS.values()]
