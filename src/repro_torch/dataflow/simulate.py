"""Cycle-accurate stream simulator for tiny dataflow graphs.

Used **only** to validate the analytical II / FIFO-depth models in tests
(the DSE itself never simulates).  The machine model matches the
analytical one:

  * a node emits at most one output element per firing, with at least
    ``stride`` cycles between firings (II = stride × outputs-per-frame);
  * each input edge carries ``cin`` elements per ``cout`` consumer
    outputs; the k-th firing needs ``ceil((k+1)·cin/cout) −
    ceil(k·cin/cout)`` fresh elements (uniform-rate schedule, handles
    both up- and down-sampling edges);
  * edges are finite FIFOs: a node blocked on a full output FIFO or an
    empty input FIFO stalls (backpressure propagates upstream);
  * source nodes (no input edges) free-run, throttled only by their
    stride and downstream FIFO space — the worst case for FIFO sizing.

``simulate`` reports the steady-state cycles-per-frame (interval between
the last two frame completions at the sink), per-edge peak occupancy and
a deadlock flag.  ``from_estimate`` converts a
:class:`~repro_torch.dataflow.estimate.GraphEstimate` of a uniform-rate graph
(integer strides — MLP-style chains like TFC) into simulator form.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class SimNode:
    name: str
    stride: int              # min cycles between consecutive outputs
    outputs_per_frame: int


@dataclasses.dataclass
class SimEdge:
    src: str
    dst: str
    cin: int                 # elements consumed per frame on this edge
    cout: int                # consumer outputs per frame
    depth: int               # FIFO capacity (elements)


@dataclasses.dataclass
class SimResult:
    cycles_per_frame: float  # steady-state interval at the sink
    frame_times: List[int]   # completion cycle of each frame
    max_occupancy: Dict[Tuple[str, str], int]
    total_cycles: int
    deadlocked: bool


def _need(edge: SimEdge, k: int) -> int:
    """Fresh elements the consumer's k-th firing consumes from ``edge``."""
    return (math.ceil((k + 1) * edge.cin / edge.cout)
            - math.ceil(k * edge.cin / edge.cout))


def simulate(nodes: List[SimNode], edges: List[SimEdge],
             frames: int = 4,
             max_cycles: Optional[int] = None) -> SimResult:
    order = {n.name: i for i, n in enumerate(nodes)}
    for e in edges:
        if order[e.src] >= order[e.dst]:
            raise ValueError("nodes must be listed in topological order")
    in_edges: Dict[str, List[SimEdge]] = {n.name: [] for n in nodes}
    out_edges: Dict[str, List[SimEdge]] = {n.name: [] for n in nodes}
    for e in edges:
        in_edges[e.dst].append(e)
        out_edges[e.src].append(e)

    sinks = [n for n in nodes if not out_edges[n.name]]
    if len(sinks) != 1:
        raise ValueError("graph must have exactly one sink")
    sink = sinks[0]

    fifo: Dict[Tuple[str, str], int] = {(e.src, e.dst): 0 for e in edges}
    occ_max = dict(fifo)
    produced = {n.name: 0 for n in nodes}
    ready = {n.name: 0 for n in nodes}
    goal = {n.name: frames * n.outputs_per_frame for n in nodes}
    by_name = {n.name: n for n in nodes}

    if max_cycles is None:
        worst_ii = max(n.stride * n.outputs_per_frame for n in nodes)
        max_cycles = (frames + 4) * worst_ii * (len(nodes) + 2)

    frame_times: List[int] = []
    t = 0
    while produced[sink.name] < goal[sink.name] and t < max_cycles:
        for n in nodes:                   # topo order: same-cycle bypass
            name = n.name
            if produced[name] >= goal[name] or t < ready[name]:
                continue
            k = produced[name]
            needs = [(e, _need(e, k)) for e in in_edges[name]]
            if any(fifo[(e.src, e.dst)] < nd for e, nd in needs):
                continue
            if any(fifo[(e.src, e.dst)] >= e.depth
                   for e in out_edges[name]):
                continue
            for e, nd in needs:
                fifo[(e.src, e.dst)] -= nd
            for e in out_edges[name]:
                key = (e.src, e.dst)
                fifo[key] += 1
                occ_max[key] = max(occ_max[key], fifo[key])
            produced[name] = k + 1
            ready[name] = t + n.stride
            if n is sink and \
                    produced[name] % n.outputs_per_frame == 0:
                frame_times.append(t)
        t += 1

    done = produced[sink.name] >= goal[sink.name]
    if len(frame_times) >= 2:
        interval = float(frame_times[-1] - frame_times[-2])
    elif frame_times:
        interval = float(frame_times[0] + 1)
    else:
        interval = float("inf")
    return SimResult(cycles_per_frame=interval, frame_times=frame_times,
                     max_occupancy=occ_max, total_cycles=t,
                     deadlocked=not done)


def analytical_ii(nodes: List[SimNode]) -> int:
    """The analytical steady-state cycles-per-frame: max node II."""
    return max(n.stride * n.outputs_per_frame for n in nodes)


def from_estimate(est) -> Tuple[List[SimNode], List[SimEdge]]:
    """Build simulator form from a :class:`GraphEstimate` — only valid
    for uniform-rate graphs whose node II divides evenly by the output
    element count (MLP-style chains such as TFC)."""
    out_elems = {n.name: n.pixels * n.channels for n in est.nodes}
    nodes = []
    for n in est.nodes:
        if n.cycles % out_elems[n.name]:
            raise ValueError(
                f"{n.name}: II {n.cycles} is not an integer multiple of "
                f"its {out_elems[n.name]} output elements — uniform-rate "
                f"simulation unsupported")
        nodes.append(SimNode(name=n.name,
                             stride=n.cycles // out_elems[n.name],
                             outputs_per_frame=out_elems[n.name]))
    edges = [SimEdge(src=f.producer, dst=f.consumer, cin=f.elems,
                     cout=out_elems[f.consumer], depth=f.depth)
             for f in est.fifos]
    return nodes, edges


__all__ = ["SimNode", "SimEdge", "SimResult", "simulate",
           "analytical_ii", "from_estimate"]
