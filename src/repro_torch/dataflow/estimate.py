"""Graph-level dataflow estimates from an analyzed ``SiraModel``.

``extract_dataflow`` turns the optimized graph into compute
:class:`~repro_torch.dataflow.resources.NodeModel` records plus stream edges:
geometry from a one-off shape probe through the numpy executor, bitwidths
from the model's cached SIRA analysis and the §4.2 accumulator reports.
``estimate`` prices the whole graph (per-node LUT/DSP/BRAM, II, style;
inter-node FIFO depths; totals and the throughput bottleneck) under a
folding assignment, and ``compare_sira_vs_baseline`` produces the paper's
headline SIRA-vs-datatype-bound resource deltas (−LUTs, −DSPs, −accumulator
bits) on the *same* topology and folding — widths and style decisions are
the only difference, which is exactly what SIRA contributes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.accumulator import (AccumulatorReport, _dot_length,
                                minimize_accumulators)
from ..core.intervals import InvalidRangeError
from ..core.model import SiraModel
from .resources import (DeviceBudget, NodeModel, baseline_style,
                        cycles_per_frame, fifo_depth, fifo_resources,
                        get_device, node_resources, select_style,
                        DSP_LUT_EQUIV)

#: ops that are pure wiring on a dataflow accelerator (no compute unit)
WIRE_OPS = {"Flatten", "Reshape", "Identity", "Transpose"}

#: container stream widths available to a no-SIRA (datatype-bound) design
CONTAINER_BITS = (8, 16, 32)


def container_bits(bits: int) -> int:
    for b in CONTAINER_BITS:
        if bits <= b:
            return b
    return CONTAINER_BITS[-1]


@dataclasses.dataclass
class Edge:
    """One stream between two compute nodes (``elems`` per frame)."""
    producer: str
    consumer: str
    elems: int
    width_bits: int


@dataclasses.dataclass
class DataflowGraph:
    nodes: List[NodeModel]
    edges: List[Edge]

    def node(self, name: str) -> NodeModel:
        return next(n for n in self.nodes if n.name == name)


# --------------------------------------------------------------- extraction

def _shape_probe(model: SiraModel,
                 input_shapes: Optional[Dict[str, Sequence[int]]] = None
                 ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of every tensor via one executor pass (batch-1 frames)."""
    shapes = dict(input_shapes or {})
    single = model.metadata.get("input_shape")
    if single is not None and len(model.graph.inputs) == 1:
        shapes.setdefault(model.graph.inputs[0], tuple(single))
    missing = [t for t in model.graph.inputs if t not in shapes]
    if missing:
        raise ValueError(
            f"dataflow estimate needs frame shapes for inputs {missing}; "
            f"set metadata['input_shape'] or pass input_shapes=")
    feeds = {}
    for t in model.graph.inputs:
        r = model.input_ranges[t]
        mid = (np.asarray(r.lo) + np.asarray(r.hi)) * 0.5
        feeds[t] = np.broadcast_to(mid, shapes[t]).astype(np.float64)
    env = model.graph.execute(feeds, record_all=True)
    return {name: np.shape(v) for name, v in env.items()}


def _range_bits(model: SiraModel, tensor: str, default: int = 32) -> int:
    """Stream width of a tensor from its SIRA range (unsigned when the
    proven integer interval is non-negative); ``default`` for tensors
    whose scaled-integer structure was lost (fixed32 regions)."""
    r = model.ranges.get(tensor)
    if r is None or not r.is_scaled_int:
        return default
    try:
        if np.min(r.int_lo) >= 0:
            bits = r.required_unsigned_bits()
        else:
            bits = r.required_signed_bits()
    except InvalidRangeError:
        return default
    return max(1, min(int(bits), 32))


def _channel_geometry(shape: Tuple[int, ...], axis: int
                      ) -> Tuple[int, int]:
    """(pixels, channels) of a frame tensor given its channel axis."""
    if not shape:
        return 1, 1
    channels = int(shape[axis])
    pixels = int(np.prod(shape)) // max(channels, 1)
    return max(pixels, 1), max(channels, 1)


def _dyn_inputs(node, const_tensors) -> List[str]:
    return [t for t in node.inputs if t not in const_tensors]


def extract_dataflow(model: SiraModel,
                     input_shapes: Optional[Dict[str, Sequence[int]]] = None
                     ) -> DataflowGraph:
    """Compute nodes + stream edges of the model's optimized graph.

    Constant subgraphs (weight preparation) are folded into the consuming
    node's weight memory; ``WIRE_OPS`` are transparent."""
    g = model.graph
    g.toposort()
    shapes = _shape_probe(model, input_shapes)
    ranges = model.ranges

    alias: Dict[str, str] = {}          # wire-op output -> real source

    def resolve(t: str) -> str:
        while t in alias:
            t = alias[t]
        return t

    producer_of: Dict[str, str] = {}    # tensor -> compute node name
    nodes: List[NodeModel] = []
    edges: List[Edge] = []
    # constness propagates through folded weight-prep subgraphs: the
    # outputs of an all-constant node are constants too (e.g. a wscale
    # Mul producing a quantized FC weight must stay a weight memory, not
    # become a dynamic stream)
    const_tensors = set(g.initializers)

    for node in g.nodes:
        dyn = _dyn_inputs(node, const_tensors)
        if not dyn:
            const_tensors.update(node.outputs)
            continue                    # constant fold: weight prep
        if node.op_type in WIRE_OPS:
            alias[node.outputs[0]] = dyn[0]
            continue
        out = node.outputs[0]
        out_shape = shapes.get(out, ())
        # channel axis: channels-first for 4D (Conv-side), last otherwise
        axis = 1 if len(out_shape) == 4 else -1
        in0 = resolve(dyn[0])
        in_bits = max((_range_bits(model, t) for t in map(resolve, dyn)),
                      default=32)
        out_bits = _range_bits(model, out)
        in_elems = int(np.prod(shapes.get(in0, (1,))))

        if node.op_type in ("MatMul", "Gemm", "Conv"):
            K = _dot_length(g, node) or 1
            pixels, channels = _channel_geometry(out_shape, axis)
            w_tensor = next((t for t in node.inputs if t not in dyn),
                            None)
            w_bits = _range_bits(model, w_tensor, default=8) \
                if w_tensor else 8
            nm = NodeModel(name=node.name, op_type=node.op_type,
                           kind="mvau", pixels=pixels, channels=channels,
                           K=K, in_bits=in_bits, out_bits=out_bits,
                           weight_bits=w_bits, in_elems=in_elems)
        elif node.op_type == "MultiThreshold":
            thr = g.initializers[node.inputs[1]]
            C, steps = thr.shape
            n_o = max(1, int(math.ceil(math.log2(steps + 1))))
            t_axis = int(node.attrs.get("axis", -1))
            pixels, channels = _channel_geometry(out_shape, t_axis)
            nm = NodeModel(name=node.name, op_type=node.op_type,
                           kind="threshold", pixels=pixels,
                           channels=int(C), in_bits=in_bits, out_bits=n_o,
                           in_elems=in_elems,
                           certificate=str(node.attrs.get("certificate",
                                                          "")))
        elif node.op_type in ("MaxPool", "AveragePool",
                              "GlobalAveragePool"):
            pixels, channels = _channel_geometry(out_shape, axis)
            if node.op_type == "GlobalAveragePool":
                in_shape = shapes.get(in0, (1, 1, 1, 1))
                window = int(np.prod(in_shape[2:])) or 1
            else:
                k = int(node.attrs.get("kernel", 2))
                window = k * k
            nm = NodeModel(name=node.name, op_type=node.op_type,
                           kind="pool", pixels=pixels, channels=channels,
                           window=window, in_bits=in_bits,
                           out_bits=out_bits, in_elems=in_elems)
        elif node.op_type == "Quant":
            bits = int(np.asarray(g.initializers[node.inputs[3]]))
            pixels, channels = _channel_geometry(out_shape, axis)
            nm = NodeModel(name=node.name, op_type=node.op_type,
                           kind="toint", pixels=pixels, channels=channels,
                           in_bits=in_bits, out_bits=bits,
                           in_elems=in_elems)
        else:                           # elementwise (Table 4 meta-kernel)
            pixels, channels = _channel_geometry(out_shape, axis)
            reason = str(node.attrs.get("meta_kernel_reason")
                         or node.attrs.get("unconverted_reason") or "")
            nm = NodeModel(name=node.name, op_type=node.op_type,
                           kind="elementwise", pixels=pixels,
                           channels=channels, in_bits=in_bits,
                           out_bits=out_bits, in_elems=in_elems,
                           reason=reason)
        nodes.append(nm)
        for t in dyn:
            src = resolve(t)
            if src in producer_of:
                edges.append(Edge(producer=producer_of[src],
                                  consumer=nm.name,
                                  elems=int(np.prod(shapes.get(src, (1,)))),
                                  width_bits=_range_bits(model, src)))
        for o in node.outputs:
            producer_of[o] = nm.name
    return DataflowGraph(nodes=nodes, edges=edges)


# --------------------------------------------------------------- estimates

@dataclasses.dataclass
class NodeEstimate:
    name: str
    op_type: str
    kind: str
    style: str
    pe: int
    simd: int
    cycles: int
    luts: float
    dsps: int
    brams: int
    in_bits: int
    out_bits: int
    weight_bits: int
    acc_bits: int
    channels: int
    K: int
    pixels: int


@dataclasses.dataclass
class FifoEstimate:
    producer: str
    consumer: str
    depth: int
    width_bits: int
    elems: int
    luts: float
    brams: int


@dataclasses.dataclass
class GraphEstimate:
    name: str
    widths: str                      # "sira" | "datatype"
    nodes: List[NodeEstimate]
    fifos: List[FifoEstimate]
    fclk_mhz: float

    @property
    def luts(self) -> float:
        return sum(n.luts for n in self.nodes) + \
            sum(f.luts for f in self.fifos)

    @property
    def dsps(self) -> int:
        return sum(n.dsps for n in self.nodes)

    @property
    def brams(self) -> int:
        return sum(n.brams for n in self.nodes) + \
            sum(f.brams for f in self.fifos)

    @property
    def max_cycles(self) -> int:
        return max((n.cycles for n in self.nodes), default=1)

    @property
    def bottleneck(self) -> Optional[str]:
        if not self.nodes:
            return None
        return max(self.nodes, key=lambda n: n.cycles).name

    @property
    def fps(self) -> float:
        return self.fclk_mhz * 1e6 / self.max_cycles

    def style_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.style] = out.get(n.style, 0) + 1
        return out

    def utilization(self, device: Union[str, DeviceBudget]
                    ) -> Dict[str, float]:
        d = get_device(device)

        def frac(used, limit):
            # a zero-resource budget ("use no DSPs") is a legal
            # DeviceBudget: unused → 0, any use → infinitely over
            if limit <= 0:
                return 0.0 if used <= 0 else math.inf
            return used / limit
        return dict(luts=frac(self.luts, d.luts),
                    dsps=frac(self.dsps, d.dsps),
                    brams=frac(self.brams, d.brams))

    def totals(self) -> Dict[str, float]:
        return dict(luts=self.luts, dsps=self.dsps, brams=self.brams,
                    max_cycles=self.max_cycles, fps=self.fps)


FoldingMap = Dict[str, Tuple[int, int]]


def _acc_table(model: SiraModel) -> Dict[str, AccumulatorReport]:
    reports = model.metadata.get("accumulator_reports")
    if reports is None:
        reports = minimize_accumulators(
            model.graph, model.input_ranges, ranges=model.ranges)
    return {r.node_name: r for r in reports}


def _widen(nm: NodeModel, acc: Optional[AccumulatorReport],
           widths: str, model: SiraModel) -> NodeModel:
    """Attach accumulator widths; for the datatype baseline, round every
    stream to its container width and use the datatype accumulator
    bound."""
    nm = dataclasses.replace(nm)
    if nm.kind == "mvau":
        if widths == "sira":
            # float-region MVAUs (no §4.2 report): the accumulator holds
            # the output value itself — its proven width, capped fixed32
            nm.acc_bits = acc.sira_bits if acc else \
                min(32, max(nm.out_bits, nm.in_bits))
        else:
            nm.acc_bits = acc.datatype_bits if acc else 32
    if widths == "datatype":
        nm.in_bits = container_bits(nm.in_bits)
        nm.out_bits = container_bits(nm.out_bits)
        if nm.kind == "mvau":
            nm.weight_bits = container_bits(nm.weight_bits)
    return nm


def widen_dataflow(model: SiraModel, dfg: DataflowGraph,
                   widths: str = "sira") -> Dict[str, NodeModel]:
    """Width-attached NodeModels — the form every pricing decision must
    see (raw extracted nodes carry a placeholder acc_bits=32).  Used by
    both :func:`estimate` and the folding search so they optimize the
    same cost model."""
    acc_table = _acc_table(model)
    wide = {nm.name: _widen(nm, acc_table.get(nm.name), widths, model)
            for nm in dfg.nodes}
    if widths == "datatype":
        _propagate_container_streams(wide, dfg)
    return wide


def _stream_out_bits(nm: NodeModel) -> int:
    """Container width of the stream leaving a node in the no-SIRA
    baseline: MVAUs emit at their (datatype-bound) accumulator width."""
    if nm.kind == "mvau":
        return container_bits(nm.acc_bits)
    return container_bits(nm.out_bits)


def _propagate_container_streams(wide: Dict[str, NodeModel],
                                 dfg: DataflowGraph) -> None:
    """Baseline stream widths flow from producers (edges are listed in
    consumer-topological order, so one pass suffices)."""
    incoming: Dict[str, int] = {}
    for e in dfg.edges:
        w = _stream_out_bits(wide[e.producer])
        incoming[e.consumer] = max(incoming.get(e.consumer, 0), w)
    for name, bits in incoming.items():
        wide[name].in_bits = bits


def estimate(model: SiraModel, *,
             widths: str = "sira",
             styles: str = "auto",
             folding: Optional[FoldingMap] = None,
             device: Union[str, DeviceBudget] = "pynq-z1",
             input_shapes: Optional[Dict[str, Sequence[int]]] = None,
             dsp_lut_equiv: float = DSP_LUT_EQUIV,
             dataflow_graph: Optional[DataflowGraph] = None
             ) -> GraphEstimate:
    """Whole-graph resource/throughput estimate.

    ``widths``: "sira" (proven ranges) or "datatype" (container widths +
    datatype-bound accumulators).  ``styles``: "auto" (cheapest per node,
    SIRA-driven) or "baseline" (DSP MACs + composite tails).  ``folding``
    maps node name → (pe, simd); unmapped nodes run fully folded (1, 1).
    """
    if widths not in ("sira", "datatype"):
        raise ValueError(f"widths={widths!r}")
    if styles not in ("auto", "baseline"):
        raise ValueError(f"styles={styles!r}")
    d = get_device(device)
    dfg = dataflow_graph or extract_dataflow(model, input_shapes)
    folding = folding or {}

    wide = widen_dataflow(model, dfg, widths)
    nodes: List[NodeEstimate] = []
    for nm in dfg.nodes:
        nm_w = wide[nm.name]
        pe, simd = folding.get(nm.name, (1, 1))
        style = (baseline_style(nm_w) if styles == "baseline"
                 else select_style(nm_w, pe, simd, dsp_lut_equiv))
        res = node_resources(nm_w, style, pe, simd)
        nodes.append(NodeEstimate(
            name=nm.name, op_type=nm.op_type, kind=nm.kind, style=style,
            pe=pe, simd=simd, cycles=cycles_per_frame(nm_w, pe, simd),
            luts=res.luts, dsps=res.dsps, brams=res.brams,
            in_bits=nm_w.in_bits, out_bits=nm_w.out_bits,
            weight_bits=nm_w.weight_bits, acc_bits=nm_w.acc_bits,
            channels=nm_w.channels, K=nm_w.K, pixels=nm_w.pixels))

    cycles = {n.name: n.cycles for n in nodes}
    # first-output latency along the DAG, for join-skew FIFO sizing
    lat: Dict[str, float] = {}
    in_edges: Dict[str, List[Edge]] = {}
    for e in dfg.edges:
        in_edges.setdefault(e.consumer, []).append(e)
    for nm in dfg.nodes:                # dfg.nodes is in topo order
        own = cycles[nm.name] / max(wide[nm.name].out_elems, 1)
        best = 0.0
        for e in in_edges.get(nm.name, ()):
            stride_p = cycles[e.producer] / max(e.elems, 1)
            ipo = max(1, math.ceil(e.elems / max(wide[nm.name].out_elems,
                                                 1)))
            best = max(best, lat[e.producer] + ipo * stride_p)
        lat[nm.name] = best + own

    fifos: List[FifoEstimate] = []
    for e in dfg.edges:
        arrivals = {e2.producer: lat[e2.producer]
                    for e2 in in_edges[e.consumer]}
        skew = max(arrivals.values()) - arrivals[e.producer]
        ipo = max(1, math.ceil(e.elems / max(wide[e.consumer].out_elems,
                                             1)))
        depth = fifo_depth(e.elems, cycles[e.producer],
                           cycles[e.consumer], ipo=ipo, skew_cycles=skew)
        width = e.width_bits if widths == "sira" \
            else _stream_out_bits(wide[e.producer])
        res = fifo_resources(depth, width)
        fifos.append(FifoEstimate(
            producer=e.producer, consumer=e.consumer, depth=depth,
            width_bits=width, elems=e.elems, luts=res.luts,
            brams=res.brams))
    return GraphEstimate(name=model.name or "model", widths=widths,
                         nodes=nodes, fifos=fifos, fclk_mhz=d.fclk_mhz)


# -------------------------------------------------------------- comparison

@dataclasses.dataclass
class DataflowComparison:
    """SIRA vs datatype-bound baseline on the same topology + folding."""
    sira: GraphEstimate
    baseline: GraphEstimate
    mean_acc_bits_sira: float
    mean_acc_bits_datatype: float

    @property
    def lut_reduction(self) -> float:
        return 1.0 - self.sira.luts / self.baseline.luts

    @property
    def dsp_reduction(self) -> float:
        if self.baseline.dsps == 0:
            return 0.0
        return 1.0 - self.sira.dsps / self.baseline.dsps

    @property
    def bram_reduction(self) -> float:
        if self.baseline.brams == 0:
            return 0.0
        return 1.0 - self.sira.brams / self.baseline.brams

    @property
    def acc_bits_reduction(self) -> float:
        if self.mean_acc_bits_datatype == 0:
            return 0.0
        return 1.0 - self.mean_acc_bits_sira / self.mean_acc_bits_datatype

    @property
    def tail_lut_ratio(self) -> float:
        """Layer-tail-only LUT ratio (threshold/elementwise/toint nodes)
        — comparable to the paper's Table 6 rLUT column."""
        kinds = ("threshold", "elementwise", "toint")
        opt = sum(n.luts for n in self.sira.nodes if n.kind in kinds)
        base = sum(n.luts for n in self.baseline.nodes if n.kind in kinds)
        return opt / base if base else 1.0

    def summary(self) -> Dict[str, float]:
        return dict(
            lut_reduction=self.lut_reduction,
            dsp_reduction=self.dsp_reduction,
            bram_reduction=self.bram_reduction,
            acc_bits_reduction=self.acc_bits_reduction,
            mean_acc_bits_sira=self.mean_acc_bits_sira,
            mean_acc_bits_datatype=self.mean_acc_bits_datatype)


def compare_sira_vs_baseline(
        model: SiraModel, *,
        device: Union[str, DeviceBudget] = "pynq-z1",
        folding: Optional[FoldingMap] = None,
        input_shapes: Optional[Dict[str, Sequence[int]]] = None,
        dataflow_graph: Optional[DataflowGraph] = None
        ) -> DataflowComparison:
    """The headline deltas: estimate the same dataflow graph with SIRA
    widths/auto styles vs datatype-bound widths/baseline styles.  Cycle
    counts are width-independent, so both sides share the folding and the
    comparison isolates exactly what SIRA contributes."""
    dfg = dataflow_graph or extract_dataflow(model, input_shapes)
    est_s = estimate(model, widths="sira", styles="auto", folding=folding,
                     device=device, dataflow_graph=dfg)
    est_b = estimate(model, widths="datatype", styles="baseline",
                     folding=folding, device=device, dataflow_graph=dfg)
    accs = list(_acc_table(model).values())
    mu_s = float(np.mean([a.sira_bits for a in accs])) if accs else 0.0
    mu_d = float(np.mean([a.datatype_bits for a in accs])) if accs else 0.0
    return DataflowComparison(sira=est_s, baseline=est_b,
                              mean_acc_bits_sira=mu_s,
                              mean_acc_bits_datatype=mu_d)
