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
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten, structure, unflatten


def _host(leaf: Any, staging: Optional[torch.Tensor] = None) -> np.ndarray:
    """The leaf as a host array.  A CUDA leaf is copied into ``staging``
    (pinned) when it is given, and the array is then a view of it, valid
    until the next leaf is copied there."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda and staging is not None:
            n = t.numel() * t.element_size()
            t = staging[:n].view(t.dtype).view(t.shape).copy_(t)
        else:
            t = t.cpu()
        if t.dtype == torch.bfloat16:        # numpy has no bfloat16
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def _entries(state: Any, extra: Optional[Dict[str, Any]]
             ) -> Iterator[Tuple[str, np.ndarray]]:
    """The npz's arrays, in order, each leaf brought to the host only when
    its turn comes: a state of tens of GB is never held on the host
    whole."""
    leaves, _ = flatten(state)
    # CUDA leaves come to the host through one pinned buffer, the size of
    # the largest: a copy from the card into pageable memory is several
    # times slower, and it would cost tens of seconds at full width
    sizes = [leaf.numel() * leaf.element_size() for leaf in leaves
             if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
    staging = torch.empty(max(sizes), dtype=torch.uint8,
                          pin_memory=True) if sizes else None
    yield "__treedef__", np.frombuffer(structure(state).encode(),
                                       dtype=np.uint8)
    for i, leaf in enumerate(leaves):
        if leaf is not None:
            yield f"leaf_{i}", _host(leaf, staging)
    yield "__nleaves__", np.asarray(len(leaves))
    yield "__none_mask__", np.asarray([leaf is None for leaf in leaves])
    if extra:
        yield "__extra__", np.frombuffer(json.dumps(extra).encode(),
                                         dtype=np.uint8)


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            # what np.savez writes (stored .npy members, zip64), one
            # member at a time
            with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for name, arr in _entries(state, extra):
                    with zf.open(name + ".npy", "w", force_zip64=True) as m:
                        np.lib.format.write_array(m, arr, allow_pickle=False)
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
    # an array read from the npz is the reader's own: no copy is needed
    # before torch takes it (at full width that is tens of GB)
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.astype(np.int16, copy=False)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr if arr.flags.writeable
                             else arr.copy()).to(like.dtype)
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
