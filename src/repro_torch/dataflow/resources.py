"""Per-node FPGA resource and throughput models for dataflow accelerators.

FINN-R-style fast analytical models: every compute node of a streamlined
graph becomes a :class:`NodeModel` (geometry + SIRA bitwidths), and this
module prices one *implementation style* of it under a *folding*
assignment (PE = output-channel parallelism, SIMD = dot-product
parallelism):

  * ``cycles_per_frame`` — initiation interval of the node: how many
    clock cycles it occupies per input frame.  The graph-level II is the
    max over nodes; FPS = fclk / max-II.
  * ``node_resources``   — LUT / DSP / BRAM estimate for a style.
  * ``select_style``     — cheapest admissible style in LUT-equivalents
    (DSPs weighted by ``dsp_lut_equiv``), generalizing the paper's
    §7.3.2 two-way tail rule to thresholding / composite / DSP-mapped
    MAC across the whole graph, driven by SIRA bitwidths.
  * ``fifo_depth`` / ``fifo_resources`` — inter-node stream FIFOs sized
    from the producer/consumer rate imbalance plus branch-latency skew
    (validated against the cycle-accurate simulator in
    :mod:`repro_torch.dataflow.simulate`).

The per-tail LUT primitives (paper Table 4) come from
:mod:`repro_torch.dataflow.costmodel`; coefficients below that are not from the
paper are FINN-R-shaped and documented inline — they only need to be
*relatively* right for the style/folding decisions to be meaningful.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple, Union

from .costmodel import (lut_add, lut_composite_memory, lut_composite_total,
                        lut_max, lut_meta_kernel, lut_mul,
                        lut_threshold_total, lut_toint)

# ------------------------------------------------------------------ devices


@dataclasses.dataclass(frozen=True)
class DeviceBudget:
    """Resource budget of one FPGA part (BRAMs counted as 18Kb blocks)."""
    name: str
    luts: int
    dsps: int
    brams: int
    fclk_mhz: float = 100.0

    def limit(self, resource: str) -> int:
        return {"luts": self.luts, "dsps": self.dsps,
                "brams": self.brams}[resource]


DEVICES: Dict[str, DeviceBudget] = {
    # Zynq-7020 (PYNQ-Z1/Z2): the paper's embedded class
    "pynq-z1": DeviceBudget("pynq-z1", luts=53_200, dsps=220, brams=280,
                            fclk_mhz=100.0),
    # ZU7EV (ZCU104): mid-range MPSoC
    "zcu104": DeviceBudget("zcu104", luts=230_400, dsps=1_728, brams=624,
                           fclk_mhz=200.0),
    # VU13P-class datacenter card
    "u250": DeviceBudget("u250", luts=1_728_000, dsps=12_288, brams=5_376,
                         fclk_mhz=300.0),
}


def get_device(device: Union[str, DeviceBudget]) -> DeviceBudget:
    if isinstance(device, DeviceBudget):
        return device
    try:
        return DEVICES[device]
    except KeyError:
        raise KeyError(f"unknown device {device!r}; known: "
                       f"{sorted(DEVICES)} (or pass a DeviceBudget)")


# ------------------------------------------------------- model coefficients

#: fixed-point parameter width of composite tails (paper's fixed16.8)
PARAM_BITS = 16
#: LUT-equivalents of one DSP slice when comparing styles — DSPs are the
#: scarcer resource on embedded parts (Zynq-7020: 242 LUTs per DSP), but
#: pricing them at full scarcity would never map a MAC to a DSP; 70 keeps
#: the paper's behaviour (8×8 products on DSP, SIRA-narrowed ones in LUTs)
DSP_LUT_EQUIV = 70.0
#: two MACs pack into one DSP48 when both operands fit 8 bits (INT8 trick)
DSP_PACK_BITS = 8
#: weight/threshold memories at or below this many bits stay in LUTRAM
LUTRAM_CUTOFF_BITS = 4096
#: capacity of one BRAM block as counted by DeviceBudget
BRAM_BITS = 18 * 1024
#: FIFOs at or below this many bits are SRL shift registers, not BRAM
FIFO_LUT_CUTOFF_BITS = 1024


@dataclasses.dataclass
class Resources:
    luts: float = 0.0
    dsps: int = 0
    brams: int = 0

    def __add__(self, other: "Resources") -> "Resources":
        return Resources(self.luts + other.luts, self.dsps + other.dsps,
                         self.brams + other.brams)

    def as_dict(self) -> Dict[str, float]:
        return dict(luts=self.luts, dsps=self.dsps, brams=self.brams)


# ------------------------------------------------------------- node models

#: node kinds priced by this module
KINDS = ("mvau", "threshold", "elementwise", "pool", "toint")

#: elementwise ops with no exact composite (Mul/Add/Max) decomposition —
#: they need the piecewise meta-kernel unless threshold-converted
NONLINEAR_ELEMENTWISE = {"Sigmoid", "Tanh", "Silu", "Gelu", "Softcap",
                         "HardSwish", "Abs"}


@dataclasses.dataclass
class NodeModel:
    """Style-independent description of one compute node.

    ``pixels`` is the number of output positions per frame (spatial sites
    for Conv, 1 for a plain MatMul), ``channels`` the per-position output
    width (Cout / M / C) — PE folds over channels, SIMD over the dot
    length K (mvau only).  Bitwidths come from the SIRA analysis (or the
    datatype-bound baseline)."""
    name: str
    op_type: str
    kind: str
    pixels: int
    channels: int
    K: int = 1
    window: int = 1          # pool kernel footprint (elements reduced)
    in_bits: int = 8
    out_bits: int = 8
    weight_bits: int = 0     # mvau only
    acc_bits: int = 32       # mvau accumulator width
    param_bits: int = PARAM_BITS
    in_elems: int = 0        # dynamic input elements per frame
    reason: str = ""         # why an elementwise tail stayed unconverted
    certificate: str = ""    # monotonicity certificate (threshold kind)

    @property
    def out_elems(self) -> int:
        return self.pixels * self.channels


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def fold_options(node: NodeModel) -> List[Tuple[int, int]]:
    """Admissible (pe, simd) assignments: PE divides channels, SIMD
    divides K (SIMD fixed at 1 for non-mvau kinds)."""
    pes = _divisors(max(node.channels, 1))
    simds = _divisors(max(node.K, 1)) if node.kind == "mvau" else [1]
    return [(pe, simd) for pe in pes for simd in simds]


def cycles_per_frame(node: NodeModel, pe: int = 1, simd: int = 1) -> int:
    """Initiation interval of the node under a folding assignment."""
    ch = math.ceil(max(node.channels, 1) / pe)
    if node.kind == "mvau":
        return node.pixels * ch * math.ceil(node.K / simd)
    if node.kind == "pool":
        return node.pixels * ch * node.window
    # threshold / elementwise / toint: one output element per PE per cycle
    return node.pixels * ch


def node_styles(node: NodeModel) -> List[str]:
    """Admissible implementation styles, cheapest-first preference left to
    :func:`select_style`."""
    if node.kind == "mvau":
        return ["lut_mac", "dsp_mac"]
    if node.kind == "threshold":
        # a certificate other than plain monotone:transfer means the
        # original tail was not an affine+ReLU composite shape (grid
        # certification or mixed per-channel directions) — re-expanding
        # it needs the meta-kernel, not the composite chain
        if node.certificate and node.certificate != "monotone:transfer":
            return ["thresholding", "meta_kernel"]
        return ["thresholding", "composite", "dsp_mac"]
    if node.kind == "elementwise":
        # an uncertifiable tail (machine-readable reason from the
        # monotonicity certifier) or an intrinsically nonlinear op has no
        # exact composite form — only the meta-kernel implements it
        if node.reason or node.op_type in NONLINEAR_ELEMENTWISE:
            return ["meta_kernel"]
        if node.op_type in ("Mul", "Div"):
            return ["composite", "dsp_mac"]
    return ["composite"]


def node_resources(node: NodeModel, style: str, pe: int = 1,
                   simd: int = 1) -> Resources:
    """Price one style of the node under a folding assignment."""
    r = Resources()
    n_i, n_o = node.in_bits, node.out_bits
    if node.kind == "mvau":
        w, a, acc = node.weight_bits, n_i, node.acc_bits
        if style == "dsp_mac":
            pack = 2 if max(w, a) <= DSP_PACK_BITS else 1
            r.dsps = math.ceil(pe * simd / pack)
            # control/routing + accumulator register per PE
            r.luts = pe * simd * 5.0 + pe * acc
        elif style == "lut_mac":
            # fabric multiplier ~0.9 LUT per partial-product bit plus the
            # SIMD adder tree / accumulator (2 LUTs per accumulator bit)
            r.luts = pe * simd * (0.9 * w * a + 2.0) + pe * 2.0 * acc
        else:
            raise ValueError(f"mvau style {style!r}")
        w_bits_total = node.K * node.channels * max(w, 1)
        if w_bits_total <= LUTRAM_CUTOFF_BITS:
            r.luts += w_bits_total / 64.0
        else:
            r.brams += math.ceil(w_bits_total / BRAM_BITS)
        return r
    if node.kind == "threshold":
        if style == "thresholding":
            r.luts = lut_threshold_total(n_i, n_o, node.channels, pe)
        elif style == "meta_kernel":
            r.luts = lut_meta_kernel(n_i, node.param_bits,
                                     node.channels, pe)
        elif style == "composite":
            r.luts = lut_composite_total(n_i, node.param_bits,
                                         node.channels, pe)
        elif style == "dsp_mac":
            # scale & bias stages on DSP slices; params as in composite
            r.dsps = 2 * pe
            r.luts = pe * (n_i + n_o) + \
                lut_composite_memory(node.param_bits, node.channels)
        else:
            raise ValueError(f"threshold style {style!r}")
        return r
    if node.kind == "pool":
        if node.op_type == "MaxPool":
            r.luts = lut_max(n_i, pe)
        else:  # Average/GlobalAveragePool: accumulate + scale by 1/window
            r.luts = lut_add(n_i, n_i, pe) + \
                lut_mul(n_i, node.param_bits, pe)
        return r
    if node.kind == "toint":
        r.luts = lut_toint(n_i, pe)
        return r
    # elementwise (Table 4 meta-kernels)
    op = node.op_type
    if style == "meta_kernel":
        r.luts = lut_meta_kernel(n_i, node.param_bits, node.channels, pe)
        return r
    if style == "dsp_mac" and op in ("Mul", "Div"):
        r.dsps = pe
        r.luts = pe * 4.0 + node.channels * node.param_bits / 64.0
        return r
    if op in ("Mul", "Div"):
        r.luts = lut_mul(n_i, node.param_bits, pe)
        if op == "Div":
            r.luts *= 1.5  # reciprocal stage
    elif op in ("Add", "Sub"):
        r.luts = lut_add(n_i, node.param_bits, pe)
    elif op == "Relu":
        r.luts = lut_max(n_i, pe)
    else:  # conservative fallback for exotic elementwise ops
        r.luts = lut_mul(n_i, node.param_bits, pe)
    # per-channel parameter memory (one set, in LUTs)
    r.luts += node.channels * node.param_bits / 128.0
    return r


def resource_score(r: Resources,
                   dsp_lut_equiv: float = DSP_LUT_EQUIV) -> float:
    """Scalar cost used for style selection / folding tie-breaks: LUTs
    plus DSPs and BRAMs priced in LUT-equivalents (a BRAM18 ~ its LUTRAM
    replacement cost)."""
    return r.luts + dsp_lut_equiv * r.dsps + 128.0 * r.brams


def select_style(node: NodeModel, pe: int = 1, simd: int = 1,
                 dsp_lut_equiv: float = DSP_LUT_EQUIV) -> str:
    """Cheapest admissible style for the node — the graph-level
    generalization of ``costmodel.select_tail_style`` (§7.3.2): SIRA
    bitwidths decide thresholding vs composite vs DSP-mapped MAC."""
    styles = node_styles(node)
    return min(styles, key=lambda s: resource_score(
        node_resources(node, s, pe, simd), dsp_lut_equiv))


def baseline_style(node: NodeModel) -> str:
    """Conservative no-SIRA style: every MAC on DSP slices, every tail as
    the composite elementwise chain (no proven ranges → no exact
    threshold extraction); nonlinear elementwise ops need the meta-kernel
    regardless of analysis."""
    if node.kind == "mvau":
        return "dsp_mac"
    if node.kind == "elementwise" and \
            node.op_type in NONLINEAR_ELEMENTWISE:
        return "meta_kernel"
    if node.kind == "threshold" and node.certificate and \
            node.certificate != "monotone:transfer":
        # no-SIRA baseline keeps the original (nonlinear) tail: meta-kernel
        return "meta_kernel"
    return "composite"


# ------------------------------------------------------------------- FIFOs

def fifo_depth(elems: int, ii_producer: float, ii_consumer: float,
               ipo: int = 1, skew_cycles: float = 0.0) -> int:
    """Analytical stream-FIFO depth for one edge.

    ``elems`` move per frame; the producer emits them over
    ``ii_producer`` cycles, the consumer drains them over
    ``ii_consumer``.  A producer faster than its consumer builds up
    ``elems * (1 - ii_p/ii_c)`` entries within a frame before
    backpressure paces it; ``ipo`` (elements consumed per consumer
    output) adds the burst margin; ``skew_cycles`` covers branch-latency
    mismatch at join nodes (the shorter branch buffers while the longer
    one fills), converted to elements at the producer's rate."""
    imbalance = 0.0
    if ii_consumer > 0 and ii_producer < ii_consumer:
        imbalance = elems * (1.0 - ii_producer / ii_consumer)
    skew_elems = 0.0
    if skew_cycles > 0 and ii_producer > 0:
        skew_elems = skew_cycles * elems / ii_producer
    return int(math.ceil(imbalance + skew_elems)) + int(ipo) + 2


def fifo_resources(depth: int, width_bits: int) -> Resources:
    bits = depth * max(width_bits, 1)
    if bits <= FIFO_LUT_CUTOFF_BITS:
        # SRL32 shift registers: one LUT per bit-slice per 32 entries
        return Resources(luts=max(width_bits, 1) * math.ceil(depth / 32)
                         + 4.0)
    return Resources(luts=8.0, brams=math.ceil(bits / BRAM_BITS))


__all__ = [
    "DeviceBudget", "DEVICES", "get_device", "Resources", "NodeModel",
    "KINDS", "NONLINEAR_ELEMENTWISE", "fold_options", "cycles_per_frame",
    "node_styles", "node_resources", "resource_score", "select_style",
    "baseline_style", "fifo_depth", "fifo_resources", "PARAM_BITS",
    "DSP_LUT_EQUIV",
]
