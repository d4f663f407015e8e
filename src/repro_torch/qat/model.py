"""Small quantized MLP classifier driven by the accumulator-aware QAT
loop — the "training knob" end of the train -> SIRA -> DSE chain.

Counterpart of ``src/repro/qat/model.py``.  Implements the model protocol
``make_train_step`` expects (``init(generator)`` and ``loss(params, x,
labels, frontend_embed, quant=..., remat=...)``), with:

  * fake-quant forward passes from ``repro_torch.quant.quantizer`` —
    unsigned input/activation quantizers, per-output-channel
    **round-toward-zero** weight quantizers (the rounding mode the A2Q
    guarantee needs), straight-through gradients;
  * **frozen** quantization scales, computed once at construction from
    the init weights / a calibration batch.  Freezing is load-bearing:
    the projection, the penalty, and the exported SIRA graph must all
    measure weights against the *same* scale, or the L1 bound proven on
    ``W/s`` stops meaning anything about the deployed integers.  The init
    is drawn on a CPU ``torch.Generator`` seeded from ``seed``, both here
    and in :meth:`init`, so the scales come from exactly the weights
    training starts from; the calibration runs on the CPU, so the scales
    are the same whatever device the model trains on;
  * per-layer :class:`~repro_torch.qat.constraints.AccumulatorBudget` when
    ``budget_bits > 0``: an L1 hinge penalty inside the loss plus a
    ``make_projector()`` tree hook for ``AdamW(project=...)``.

Params live on ``device`` (``None`` means the card and raises without
one).  Every scale reaches the arithmetic as a float32 tensor on that
device: dividing a CUDA tensor by a Python number multiplies by its
reciprocal, which can move a rounding boundary by an ulp.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.lower import resolve_device
from ..quant.quantizer import QuantSpec, fake_quant
from .constraints import (AccumulatorBudget, budget_penalty,
                          project_weights, weight_quant_spec)

Key = Union[int, torch.Generator]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=device)


class QATMLP:
    """ReLU MLP with quantized input/weights/activations and an optional
    accumulator budget on every layer.

    ``raw_params`` (a ``{"layers": [{"W", "b"}, ...]}`` tree of arrays)
    replaces the seeded draw as the init, e.g. the reference's init
    carried across by :mod:`repro_torch.qat.convert`."""

    def __init__(self, in_dim: int = 16, hidden=(32,), classes: int = 4,
                 weight_bits: int = 4, act_bits: int = 4,
                 input_bits: int = 8, budget_bits: int = 0,
                 zero_center: bool = False, lam: float = 1e-2,
                 seed: int = 0, device=None,
                 raw_params: Optional[Dict[str, Any]] = None):
        self.in_dim = in_dim
        self.hidden = tuple(hidden)
        self.classes = classes
        self.weight_bits = weight_bits
        self.act_bits = act_bits
        self.input_bits = input_bits
        self.budget_bits = budget_bits
        self.zero_center = zero_center
        self.lam = lam
        self.seed = seed
        self.device = resolve_device(device)
        self.raw_params = raw_params

        dims = [in_dim] + list(self.hidden) + [classes]
        self.layer_dims = list(zip(dims[:-1], dims[1:]))
        self.w_spec = weight_quant_spec(weight_bits)
        self.in_spec = QuantSpec(bits=input_bits, signed=False)
        self.act_spec = QuantSpec(bits=act_bits, signed=False)
        # inputs live in [0, 1]; this scale puts the integer grid exactly
        # on [0, 2^N - 1] so SIRA sees a pure unsigned N-bit input
        self.input_scale = 1.0 / (2 ** input_bits - 1)

        # deterministic class centers for the synthetic task
        rng = np.random.default_rng(seed + 7)
        self._centers = rng.uniform(0.25, 0.75, size=(classes, in_dim))

        # frozen per-output-channel weight scales from the init weights,
        # with 2x headroom so training can grow weights before the
        # clipped STE saturates
        init = self._raw_init(seed)
        w_scales = [
            np.maximum(np.abs(l["W"].double().numpy()).max(axis=0)
                       * 2.0 / self.w_spec.qmax, 1e-8)
            for l in init["layers"]]
        # frozen per-tensor activation scales from a calibration pass
        self.set_scales(w_scales, self._calibrate(init, w_scales))

    def set_scales(self, w_scales: Sequence, a_scales: Sequence) -> None:
        """Freeze the weight scales (float64 arrays, one per layer) and
        activation scales (floats, one per hidden layer)."""
        self.w_scales: List[np.ndarray] = [np.array(s, np.float64)
                                           for s in w_scales]
        self.a_scales: List[float] = [float(s) for s in a_scales]
        self._w_s = [_f32(s, self.device)[None, :] for s in self.w_scales]
        self._a_s = [_f32(s, self.device) for s in self.a_scales]
        self._in_s = _f32(self.input_scale, self.device)

    # ------------------------------------------------------------- budgets
    def budgets(self) -> List[Optional[AccumulatorBudget]]:
        """Per-layer accumulator budgets (None when unconstrained).
        Layer 0 accumulates the quantized input, deeper layers the
        unsigned activation quantizer output."""
        if not self.budget_bits:
            return [None] * len(self.layer_dims)
        out: List[Optional[AccumulatorBudget]] = []
        for i in range(len(self.layer_dims)):
            n = self.input_bits if i == 0 else self.act_bits
            out.append(AccumulatorBudget(
                bits=self.budget_bits, input_bits=n, input_signed=False,
                zero_center=self.zero_center))
        return out

    def make_projector(self):
        """Tree -> tree hard projection onto every layer's budget, for
        ``AdamW(project=...)`` (applied to the f32 master weights after
        each optimizer step)."""
        budgets = self.budgets()
        scales = self._w_s

        def proj(params: Dict[str, Any]) -> Dict[str, Any]:
            layers = []
            for layer, s, b in zip(params["layers"], scales, budgets):
                if b is None:
                    layers.append(dict(layer))
                else:
                    layers.append(
                        {**layer, "W": project_weights(layer["W"], s, b)})
            return {**params, "layers": layers}

        return proj

    # ---------------------------------------------------------------- init
    def _raw_init(self, key: Key) -> Dict[str, Any]:
        """The unprojected init on the CPU: ``raw_params`` when given,
        else normal(0, 1/sqrt(fan_in)) weights drawn from ``key`` and
        zero biases."""
        if self.raw_params is not None:
            return {"layers": [
                {"W": torch.tensor(np.asarray(l["W"]), dtype=torch.float32),
                 "b": torch.tensor(np.asarray(l["b"]), dtype=torch.float32)}
                for l in self.raw_params["layers"]]}
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator().manual_seed(int(key))
        layers = []
        for k, m in self.layer_dims:
            W = torch.randn((k, m), generator=gen, dtype=torch.float32)
            layers.append({"W": W / torch.sqrt(torch.tensor(float(k))),
                           "b": torch.zeros((m,), dtype=torch.float32)})
        return {"layers": layers}

    def init(self, key: Key) -> Dict[str, Any]:
        """Init params on the model's device; already projected onto the
        budget set so step 0 satisfies the constraint (AdamW copies these
        into its masters)."""
        params = self._raw_init(key)
        params = {"layers": [{k: t.to(self.device) for k, t in l.items()}
                             for l in params["layers"]]}
        if self.budget_bits:
            with torch.no_grad():
                params = self.make_projector()(params)
        return params

    def _calibrate(self, params, w_scales) -> List[float]:
        x = torch.from_numpy(self.synth_batch(0, 256)["tokens"])
        h = fake_quant(x, _f32(self.input_scale, "cpu"), 0.0, self.in_spec)
        scales: List[float] = []
        with torch.no_grad():
            for i, layer in enumerate(params["layers"][:-1]):
                wq = fake_quant(layer["W"], _f32(w_scales[i], "cpu")[None, :],
                                0.0, self.w_spec)
                h = torch.relu(h @ wq + layer["b"])
                s = max(float(torch.max(h)), 1e-6) * 2.0 / self.act_spec.qmax
                scales.append(s)
                h = fake_quant(h, _f32(s, "cpu"), 0.0, self.act_spec)
        return scales

    # ------------------------------------------------------------- forward
    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        h = fake_quant(x, self._in_s, 0.0, self.in_spec)
        n = len(params["layers"])
        for i, layer in enumerate(params["layers"]):
            wq = fake_quant(layer["W"], self._w_s[i], 0.0, self.w_spec)
            h = h @ wq + layer["b"]
            if i < n - 1:
                h = torch.relu(h)
                h = fake_quant(h, self._a_s[i], 0.0, self.act_spec)
        return h

    def loss(self, params, x, labels, frontend_embed=None, *,
             quant=None, remat: bool = True) -> torch.Tensor:
        """Cross-entropy + the differentiable accumulator-budget penalty
        (``quant``/``remat``/``frontend_embed`` accepted for the
        make_train_step protocol; quantization here is structural)."""
        del frontend_embed, quant, remat
        logits = self.apply(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
        pen = torch.zeros((), dtype=torch.float32, device=logits.device)
        for layer, s, b in zip(params["layers"], self._w_s, self.budgets()):
            if b is not None:
                pen = pen + budget_penalty(layer["W"], s, b)
        return ce + self.lam * pen

    # ---------------------------------------------------------------- data
    def synth_batch(self, step: int, batch: int) -> Dict[str, np.ndarray]:
        """Deterministic synthetic classification batch: Gaussian blobs
        around per-class centers, clipped to the quantizer's [0, 1]
        input box.  Keyed by (seed, step) so resumed runs replay the
        exact data stream (bit-identical-resume tests rely on this)."""
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        labels = rng.integers(self.classes, size=batch)
        x = self._centers[labels] + rng.normal(
            0.0, 0.08, size=(batch, self.in_dim))
        return {"tokens": np.clip(x, 0.0, 1.0).astype(np.float32),
                "labels": labels.astype(np.int32)}
