"""Roofline analysis of a cell (architecture x shape x layout).

Counterpart of ``src/repro/roofline/analysis.py``.  Per cell three time
terms:

    compute    = FLOPs per device / peak FLOP/s
    memory     = HBM bytes per device / HBM bytes/s
    collective = collective operand bytes per device / link bytes/s,
                 the bytes of collectives that span nodes over the
                 inter-node rate instead

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and
parses the collectives out of the optimised HLO (``parse_collectives``);
the port has no HLO: FLOPs and bytes come from ``roofline/cost.py``,
computed from the model code's own shapes, and the collectives from the
counters of ``launch/mesh.py`` (or ``cost.py``'s prediction of them).

The peaks are arguments.  Their defaults are one H100 SXM's data-sheet
figures (NVIDIA, dense): 989e12 FLOP/s in bf16/f16, 1979e12 OP/s in int8,
67e12 FLOP/s in float32 outside the tensor cores, 3.35e12 B/s of HBM,
900e9 B/s of NVLink within a node and 50e9 B/s per GPU between nodes
(DGX H100, 400 Gb/s InfiniBand).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

#: dense peak FLOP/s (OP/s for int8) of one H100 SXM by operand type
PEAK_FLOPS: Dict[str, float] = {
    "bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
    "float32": 67e12,
}
HBM_BW = 3.35e12           # bytes/s per GPU
NVLINK_BW = 900e9          # bytes/s per GPU within an 8-GPU node
INTERNODE_BW = 50e9        # bytes/s per GPU across nodes (400 Gb/s)
GPUS_PER_NODE = 8          # GPUs joined by NVLink (one DGX H100)


def peak_flops(dtype) -> float:
    """The H100's dense peak for ``dtype`` (a ``torch.dtype`` or its
    name)."""
    name = str(dtype).replace("torch.", "")
    return PEAK_FLOPS[name]


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    operand_bytes: Dict[str, int]     # per-device operand bytes
    wire_bytes: Dict[str, int]        # ring-model on-the-wire bytes
    cross_pod_bytes: int = 0          # operand bytes of pod-axis collectives
    internode_bytes: int = 0          # operand bytes of node-spanning ones

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> int:
        return sum(self.wire_bytes.values())


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float              # 6·N·D (global, fwd+bwd) or 2·N·D
    useful_flops_frac: float        # MODEL / (counted FLOPs · devices)
    mfu_bound: float                # max roofline fraction achievable

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_from(cost: Dict[str, float], colls: CollectiveStats,
                  n_chips: int, model_flops: float,
                  link_bw: float = NVLINK_BW, *,
                  peak_flops: float = PEAK_FLOPS["bfloat16"],
                  hbm_bw: float = HBM_BW,
                  internode_bw: float = INTERNODE_BW) -> Roofline:
    """The reference's ``roofline_from`` with the peaks as arguments:
    ``cost`` holds "flops" and "bytes accessed" per device.  The
    collectives' ``internode_bytes`` cross at ``internode_bw``, the rest
    at ``link_bw`` (with none, the reference's one-rate term)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(colls.total_operand_bytes)
    wb = float(colls.total_wire_bytes)
    ib = float(colls.internode_bytes)
    t_c = flops / peak_flops
    t_m = byts / hbm_bw
    t_x = (cb - ib) / link_bw + ib / internode_bw if ib else cb / link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total = flops * n_chips
    useful = model_flops / total if total else 0.0
    t_star = max(t_c, t_m, t_x)
    mfu_bound = (model_flops / n_chips / peak_flops) / t_star \
        if t_star > 0 else 0.0
    return Roofline(flops_per_chip=flops, bytes_per_chip=byts,
                    collective_bytes_per_chip=cb, wire_bytes_per_chip=wb,
                    compute_s=t_c, memory_s=t_m, collective_s=t_x,
                    bottleneck=bottleneck, model_flops=model_flops,
                    useful_flops_frac=useful, mfu_bound=mfu_bound)


def model_flops_for(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1      # decode: one token per sequence
    return 2.0 * n_active * tokens


def mfu(model_flops: float, seconds: float, n_devices: int = 1,
        dtype=torch.bfloat16) -> float:
    """Model-FLOP utilisation of a measured run: model FLOPs over
    (seconds x devices x the H100's peak for ``dtype``)."""
    return model_flops / (seconds * n_devices * peak_flops(dtype))
