"""PTQ calibration (paper §2.1): derive quantizer scales from data.

Min/max and percentile calibrators over activation batches, plus a helper
that freezes dynamic QAT activation quantizers into static ones so the
graph becomes fully static for SIRA analysis and integer serving.

Counterpart of ``src/repro/quant/calibrate.py``: numpy arithmetic, as
there, so scales and zero points equal the reference's.  Observers take
numpy arrays or tensors on any device (copied to the host).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .quantizer import QuantSpec


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MinMaxObserver:
    def __init__(self, spec: QuantSpec):
        self.spec = spec
        self.lo: float | None = None
        self.hi: float | None = None

    def update(self, x) -> None:
        x = _host(x)
        lo, hi = float(x.min()), float(x.max())
        self.lo = lo if self.lo is None else min(self.lo, lo)
        self.hi = hi if self.hi is None else max(self.hi, hi)

    def scale_zp(self) -> Tuple[np.ndarray, np.ndarray]:
        spec = self.spec
        assert self.lo is not None, "observer saw no data"
        if spec.symmetric:
            amax = max(abs(self.lo), abs(self.hi), 1e-8)
            s = amax / spec.qmax
            return np.asarray(s), np.zeros(())
        s = max((self.hi - self.lo) / (spec.qmax - spec.qmin), 1e-8)
        z = round(spec.qmin - self.lo / s)
        return np.asarray(s), np.asarray(float(z))


class PercentileObserver(MinMaxObserver):
    """Clips calibration range to the [p, 100-p] percentile — robust to
    activation outliers (common for transformer activations)."""

    def __init__(self, spec: QuantSpec, percentile: float = 0.01):
        super().__init__(spec)
        self.p = percentile
        self._samples: list = []

    def update(self, x) -> None:
        x = _host(x).ravel()
        if x.size > 65536:
            idx = np.random.default_rng(0).choice(x.size, 65536,
                                                  replace=False)
            x = x[idx]
        self._samples.append(x)
        lo = float(np.percentile(np.concatenate(self._samples), self.p))
        hi = float(np.percentile(np.concatenate(self._samples),
                                 100.0 - self.p))
        self.lo, self.hi = lo, hi


def calibrate_model(apply_fn, params, batches: Iterable,
                    taps: Iterable[str], spec: QuantSpec,
                    observer_cls=MinMaxObserver) -> Dict[str, Tuple]:
    """Run ``apply_fn(params, batch) -> dict(tap -> activation)`` over the
    calibration set and return {tap: (scale, zero_point)}."""
    obs = {t: observer_cls(spec) for t in taps}
    for batch in batches:
        acts = apply_fn(params, batch)
        for t in taps:
            obs[t].update(acts[t])
    return {t: o.scale_zp() for t, o in obs.items()}
