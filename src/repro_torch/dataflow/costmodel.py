"""Analytical FPGA layer-tail cost models (paper §5.4, Tables 4/7, Fig 23).

These models reproduce the paper's LUT predictions for the two layer-tail
implementation styles and drive the composite-vs-thresholding crossover
analysis.  They are kept verbatim from the paper (coefficients from
Table 4); a device-memory mirror (HBM bytes moved per tail on a
GPU) is kept beside them, :func:`hbm_tail_bytes`.

This module absorbed ``repro_torch.core.costmodel`` (which remains as an
import-compatible shim); the graph-level resource/throughput models that
build on these per-tail primitives live in :mod:`repro_torch.dataflow.resources`.
"""
from __future__ import annotations

import dataclasses

from ..core.ops import COST_REGISTRY

# Table 4: LUT = alpha * f(n_i, n_p) * PE + beta.  Coefficients are
# registered in the unified per-op registry by repro_torch.core.ops itself;
# ELEMENTWISE_COEFFS is the legacy dict-compatible view over them.
ELEMENTWISE_COEFFS = COST_REGISTRY


def lut_mul(n_i: int, n_p: int, pe: int) -> float:
    c = ELEMENTWISE_COEFFS["Mul"]
    return c["alpha"] * n_i * n_p * pe + c["beta"]


def lut_add(n_i: int, n_p: int, pe: int) -> float:
    c = ELEMENTWISE_COEFFS["Add"]
    return c["alpha"] * (n_i + n_p) * pe + c["beta"]


def lut_toint(n_i: int, pe: int) -> float:
    c = ELEMENTWISE_COEFFS["ToInt"]
    return c["alpha"] * n_i * pe + c["beta"]


def lut_max(n_i: int, pe: int) -> float:
    c = ELEMENTWISE_COEFFS["Max"]
    return c["alpha"] * n_i * pe + c["beta"]


#: piecewise segments of the nonlinear elementwise meta-kernel
META_KERNEL_SEGMENTS = 16


def lut_meta_kernel(n_i: int, n_p: int, channels: int, pe: int) -> float:
    """Nonlinear elementwise meta-kernel (FINN-style piecewise-linear
    interpolator): per-PE segment-select comparators feeding one
    fixed-point multiply-add, a shared slope/intercept segment table, and
    the per-channel scale/bias parameter memory.  Strictly costlier than
    a same-width ``Mul`` (alpha 2.6 vs 1.18) — this is the price of a
    tail that could *not* be certified for threshold conversion."""
    c = ELEMENTWISE_COEFFS["MetaKernel"]
    compute = c["alpha"] * n_i * n_p * pe + c["beta"]
    table = META_KERNEL_SEGMENTS * 2.0 * n_p / 64.0
    return compute + table + lut_composite_memory(n_p, channels)


# --------------------------------------------------------------------------
# §5.4.2 composite layer tail:  Mul → Add → Max(ReLU) → Mul → ToInt
# --------------------------------------------------------------------------

def lut_composite_compute(n_i: int, n_p: int, pe: int) -> float:
    """LUT_comp(n_i, n_p, PE) with lossless fixed-point width growth."""
    return (lut_mul(n_i, n_p, pe)
            + lut_add(n_i + n_p, n_p, pe)
            + lut_max(n_i + n_p + 1, pe)
            + lut_mul(n_i + n_p + 1, n_p, pe)
            + lut_toint(n_i + n_p + 1, pe))


def lut_composite_memory(n_p: int, channels: int) -> float:
    """Two per-channel parameter sets (Mul, Add) stored in 6-input LUTs."""
    return 2.0 * channels * n_p / 64.0


def lut_composite_total(n_i: int, n_p: int, channels: int, pe: int) -> float:
    return lut_composite_compute(n_i, n_p, pe) + \
        lut_composite_memory(n_p, channels)


# --------------------------------------------------------------------------
# §5.4.3 thresholding layer tail
# --------------------------------------------------------------------------

def n_thresholds(n_o: int, channels: int) -> int:
    """Sum_T = (2^n_o - 1) * C."""
    return (2 ** n_o - 1) * channels


def lut_threshold_memory(n_i: int, n_o: int, channels: int) -> float:
    mem_bits = n_thresholds(n_o, channels) * n_i
    return mem_bits / 64.0


def lut_threshold_compute(n_i: int, n_o: int, pe: int) -> float:
    return n_o * pe * n_i


def lut_threshold_total(n_i: int, n_o: int, channels: int, pe: int) -> float:
    return lut_threshold_compute(n_i, n_o, pe) + \
        lut_threshold_memory(n_i, n_o, channels)


# --------------------------------------------------------------------------
# crossover + style selection (Fig 23 / §7.3.2)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TailCost:
    thresholding_luts: float
    composite_luts: float

    @property
    def best(self) -> str:
        return ("thresholding"
                if self.thresholding_luts <= self.composite_luts
                else "composite")


def tail_cost(n_i: int, n_o: int, n_p: int, channels: int,
              pe: int) -> TailCost:
    return TailCost(
        thresholding_luts=lut_threshold_total(n_i, n_o, channels, pe),
        composite_luts=lut_composite_total(n_i, n_p, channels, pe))


def select_tail_style(n_i: int, n_o: int, n_p: int, channels: int,
                      pe: int) -> str:
    """Automated implementation-style choice the paper suggests as future
    work (§7.3.2): <4-bit outputs → thresholding, >8-bit → composite,
    in between decided by the analytical models.

    This is the *two-way* per-tail rule from the paper; the graph-level
    three-way generalization (thresholding / composite / DSP-mapped) is
    :func:`repro_torch.dataflow.resources.select_style`."""
    if n_o < 4:
        return "thresholding"
    if n_o > 8:
        return "composite"
    return tail_cost(n_i, n_o, n_p, channels, pe).best


# --------------------------------------------------------------------------
# device-memory mirror: HBM bytes per tail invocation
# --------------------------------------------------------------------------

def _dtype_bytes(bits: int) -> int:
    for b in (8, 16, 32):
        if bits <= b:
            return b // 8
    return 8


def hbm_tail_bytes(n_elems: int, n_i_bits: int, n_o_bits: int,
                   channels: int, style: str, fused: bool = True) -> int:
    """HBM traffic of one layer-tail application over n_elems activations.

    composite, unfused: each elementwise op re-reads/writes activations
    (Mul, Add, act, Mul, ToInt → 5 read+write passes at intermediate
    width).  thresholding (or a fused composite): single read at
    accumulator width + single write at activation width + threshold/param
    table read (held on chip, counted once).
    """
    in_b = _dtype_bytes(n_i_bits)
    out_b = _dtype_bytes(n_o_bits)
    if style == "composite" and not fused:
        mid_b = 4  # f32/fixed32 intermediates
        return n_elems * (in_b + out_b + 4 * 2 * mid_b) + channels * 2 * 4
    if style == "composite":  # fused composite (one pass)
        return n_elems * (in_b + out_b) + channels * 2 * 4
    # thresholding: param table = (2^n_o - 1) * C thresholds at in width
    table = n_thresholds(n_o_bits, channels) * in_b
    return n_elems * (in_b + out_b) + table
