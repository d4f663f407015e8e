"""Carry a QAT model and its weights across from the reference package.

The reference's ``QATMLP`` draws its init with ``jax.random``; the port
draws on a ``torch.Generator``, so the two start from different weights.
To compare the two on the same numbers, this module builds the port's
model with the reference's hyper-parameters, its init weights and its
frozen scales, and the port's params or ``TrainState`` from the
reference's param tree.  The scales are copied **verbatim**, never
recomputed: a last-ulp difference in a calibration max would change the
exported graph.  Reads attributes and numpy arrays only (no import of the
reference), as ``models/convert.py`` does for the LMs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..optim.adamw import AdamW
from ..train.train_step import TrainState, init_train_state
from .model import QATMLP


def params_from_reference(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's ``{"layers": [{"W", "b"}, ...]}`` tree (numpy
    leaves) → the same tree of float32 tensors on ``device``."""
    return {"layers": [
        {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
         for k, v in layer.items()} for layer in params["layers"]]}


def qat_model_from_reference(ref_model, raw_params: Optional[Dict] = None,
                             device=None) -> QATMLP:
    """The port's ``QATMLP`` with ``ref_model``'s hyper-parameters and
    frozen ``w_scales`` / ``a_scales``.  ``raw_params``, the reference's
    unprojected init (numpy leaves), becomes the port's init, so that
    ``run_qat`` starts from the reference's weights."""
    model = QATMLP(in_dim=ref_model.in_dim, hidden=ref_model.hidden,
                   classes=ref_model.classes,
                   weight_bits=ref_model.weight_bits,
                   act_bits=ref_model.act_bits,
                   input_bits=ref_model.input_bits,
                   budget_bits=ref_model.budget_bits,
                   zero_center=ref_model.zero_center, lam=ref_model.lam,
                   seed=ref_model.seed, device=device,
                   raw_params=raw_params)
    model.set_scales(ref_model.w_scales, ref_model.a_scales)
    return model


def train_state_from_reference(model: QATMLP, optimizer: AdamW,
                               params: Dict[str, Any]) -> TrainState:
    """A step-0 ``TrainState`` of ``model`` holding the reference's
    params (numpy leaves), its masters copied from them."""
    return init_train_state(model, optimizer, model.seed,
                            params=params_from_reference(params,
                                                         model.device))
