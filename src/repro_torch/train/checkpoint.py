"""Fault-tolerant checkpointing: atomic-rename npz of the full train state
(params, optimizer moments, data cursor, RNG seed) + resume.

Counterpart of ``src/repro/train/checkpoint.py``.  Guarantees:
  * atomicity — write to a temp file, fsync, rename; a crash mid-write
    never corrupts the latest checkpoint;
  * bitwise-deterministic resume (tested in tests/test_torch_train.py);
  * retention — keep the last ``keep`` checkpoints, delete older;
  * validation — the state's structure string (:func:`repro_torch.tree.
    structure`), leaf count and leaf shapes are checked against the
    template on restore, which raises ``ValueError`` on a mismatch.

Leaves are saved from the host (bfloat16 as its 16-bit pattern) and
restored in the template leaf's dtype, on the template leaf's device.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten, structure, unflatten


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten_state(state: Any) -> Dict[str, np.ndarray]:
    flat = {}
    leaves, _ = flatten(state)
    flat["__treedef__"] = np.frombuffer(structure(state).encode(),
                                        dtype=np.uint8)
    for i, leaf in enumerate(leaves):
        if leaf is None:
            continue
        flat[f"leaf_{i}"] = _host(leaf)
    flat["__nleaves__"] = np.asarray(len(leaves))
    flat["__none_mask__"] = np.asarray([leaf is None for leaf in leaves])
    return flat


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat = _flatten_state(state)
    if extra:
        flat["__extra__"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)            # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc(directory, keep)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    cands = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    return os.path.join(directory, cands[-1]) if cands else None


def _restore_leaf(arr: np.ndarray, like: Any) -> Any:
    if not isinstance(like, torch.Tensor):
        return arr.astype(like.dtype) if hasattr(like, "dtype") else arr
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True)).to(like.dtype)
    return t.to(like.device)


def restore_checkpoint(path: str, state_like: Any
                       ) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``state_like`` (the template).

    The saved structure / leaf count / leaf shapes are validated against
    the template: leaves are stored positionally, so restoring into a
    state with a different structure (e.g. a constrained-QAT state into a
    plain trainer, or a different model width) would silently assign
    tensors to the wrong slots.  Mismatches raise ``ValueError``
    instead."""
    with np.load(path, allow_pickle=False) as data:
        leaves, spec = flatten(state_like)
        template = structure(state_like)
        if "__treedef__" in data:
            saved_td = bytes(data["__treedef__"]).decode()
            if saved_td != template:
                raise ValueError(
                    f"checkpoint {path} was saved with a different state "
                    f"structure; leaves are positional so restoring would "
                    f"scramble them.\n  saved:    {saved_td}\n"
                    f"  template: {template}")
        if "__nleaves__" in data and \
                int(data["__nleaves__"]) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {int(data['__nleaves__'])} "
                f"leaves but the template has {len(leaves)}")
        none_mask = data["__none_mask__"]
        out = []
        for i, leaf in enumerate(leaves):
            if none_mask[i]:
                out.append(None)
                continue
            arr = data[f"leaf_{i}"]
            if leaf is not None and hasattr(leaf, "shape") and \
                    tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint {path} leaf {i}: saved shape "
                    f"{tuple(arr.shape)} != template shape "
                    f"{tuple(leaf.shape)}")
            out.append(arr if leaf is None else _restore_leaf(arr, leaf))
        extra = {}
        if "__extra__" in data:
            extra = json.loads(bytes(data["__extra__"]).decode())
    return unflatten(spec, out), extra


def step_of(path: str) -> int:
    return int(os.path.basename(path)[5:13])


def _gc(directory: str, keep: int) -> None:
    cands = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    for p in cands[:-keep]:
        os.unlink(os.path.join(directory, p))
