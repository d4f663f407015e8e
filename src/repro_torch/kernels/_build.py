"""Build and load the CUDA kernels of ``csrc/`` (at first use, never at
import), and keep the per-kernel launch counts.

The sources have a plain C interface (raw pointers, sizes, the stream; no
PyTorch header), so ``nvcc`` compiles each in seconds.  One ``nvcc -c``
process per source runs at the same time, one link makes the shared
library, ``ctypes`` loads it.  The library's file name carries a hash of
the sources, the headers they include and the flags, so an unchanged tree
reuses its build and a changed source or header never loads a stale one.
A build failure raises with the compiler's output; nothing falls back to
the plain versions.

Under a count (``roofline/op_cost.py analyze_program``) the wrappers take
their card path for ``meta`` tensors (:func:`on_card`) and stop at their
launch sites (:func:`counted`): they record their kernel's work and
return their outputs, and nothing is built or launched.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("int_matmul.cu", "multithreshold.cu", "quantize.cu",
           "flash_attention.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_tc.cu", "flash_attention_bwd_tc256.cu")
#: headers the sources include: part of the build's hash, so an edit to
#: one rebuilds the library
HEADERS = ("hopper.cuh", "flash_tc.cuh", "flash_bwd.cuh",
           "flash_bwd_tc.cuh")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: launches per kernel since the last :func:`reset_launch_counts`; each
#: wrapper adds one where it launches its kernel and nowhere else
LAUNCH_COUNTS: Dict[str, int] = collections.Counter()

#: while a count runs (``roofline/op_cost.py analyze_program`` sets it),
#: what records a kernel's launch: ``recorder(name, flops, bytes, *,
#: route, call)``; None otherwise
recorder: Optional[Callable[..., None]] = None

_lib: Optional[ctypes.CDLL] = None
#: wall seconds the last real build took (0.0 when a cached library loaded)
build_seconds: float = 0.0


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its card path for ``t``: a CUDA tensor,
    or a ``meta`` tensor under a count.  A ``meta`` tensor outside a
    count raises: it has no data to compute on."""
    if t.is_cuda:
        return True
    if t.is_meta:
        if recorder is None:
            raise RuntimeError(
                "a meta tensor reached a CUDA kernel's wrapper outside a "
                "count (roofline/op_cost.py analyze_program): it has no "
                "data to compute on")
        return True
    return False


def counted(name: str, work: Callable[[], Tuple[float, float]],
            t: torch.Tensor, route: Optional[str] = None,
            call: bool = True) -> bool:
    """At a wrapper's launch site: under a count (``t`` a ``meta``
    tensor), record one launch of kernel ``name`` doing ``work()``
    ((FLOPs, HBM bytes), from the kernel's ``work`` function; called
    only here) and return True, and the wrapper returns its outputs
    unlaunched; False otherwise.  ``call=False``: a further kernel of
    the same call, which :data:`LAUNCH_COUNTS` does not count apart."""
    if not t.is_meta:
        return False
    recorder(name, *work(), route=route, call=call)
    return True


def build_dir() -> pathlib.Path:
    """``<checkout>/build/repro_torch_kernels`` (git-ignored)."""
    return (pathlib.Path(__file__).resolve().parents[3]
            / "build" / "repro_torch_kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of repro_torch cannot be built on this machine")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]], log: pathlib.Path) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    with log.open("a") as fh:
        for c, out in zip(cmds, outputs):
            fh.write("$ " + " ".join(c) + "\n" + out + "\n")
    failed = [(c, out) for c, p, out in zip(cmds, procs, outputs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(
            "$ " + " ".join(c) + "\n" + out for c, out in failed))


def _build(out: pathlib.Path) -> None:
    nvcc = _nvcc()
    bdir = out.parent
    bdir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    log = bdir / f"{out.stem}.log"
    objs = [bdir / f"{tag}.{pathlib.Path(s).stem}.o" for s in SOURCES]
    tmp = bdir / f"{tag}.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                  for s, o in zip(SOURCES, objs)], log)
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], log)
        os.replace(tmp, out)      # atomic: a concurrent build loses nothing
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.sira_int_matmul.argtypes = [p, p, p, p, p, ll, ll, ll, ll, ll, ll,
                                    i, i, i, i, i, p]
    lib.sira_int_matmul.restype = i
    lib.sira_multithreshold.argtypes = [p, p, p, ll, ll, i, i, i, i, i, p]
    lib.sira_multithreshold.restype = i
    lib.sira_quantize.argtypes = [p, p, p, p, ll, ll, i, i, i, i, i, p]
    lib.sira_quantize.restype = i
    lib.sira_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                         ll, ll, i, f, f, i, p]
    lib.sira_flash_attention.restype = i
    lib.sira_flash_bwd_delta.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.sira_flash_bwd_delta.restype = i
    lib.sira_flash_bwd_dkdv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                        i, i, ll, ll, i, f, f, i, p]
    lib.sira_flash_bwd_dkdv.restype = i
    lib.sira_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                      ll, ll, i, f, f, i, p]
    lib.sira_flash_bwd_dq.restype = i
    lib.sira_flash_bwd_dkdv_tc.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                           i, i, i, i, ll, ll, i, f, f, i, p]
    lib.sira_flash_bwd_dkdv_tc.restype = i
    lib.sira_flash_bwd_dq_tc.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         i, ll, ll, i, f, f, i, p]
    lib.sira_flash_bwd_dq_tc.restype = i
    lib.sira_flash_bwd_dkdv_tc256.argtypes = \
        lib.sira_flash_bwd_dkdv_tc.argtypes
    lib.sira_flash_bwd_dkdv_tc256.restype = i
    lib.sira_flash_bwd_dq_tc256.argtypes = lib.sira_flash_bwd_dq_tc.argtypes
    lib.sira_flash_bwd_dq_tc256.restype = i


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib, build_seconds
    if _lib is None:
        out = build_dir() / f"libsira_kernels_{_digest()}.so"
        if not out.exists():
            t0 = time.perf_counter()
            _build(out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
    return _lib


MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_Y = 65535


def check_grid(name: str, blocks_x: int, blocks_y: int) -> None:
    """Raise if a launch of ``blocks_x`` by ``blocks_y`` thread blocks
    exceeds what the card takes: the launch would be refused with a bare
    error number."""
    if blocks_x > MAX_GRID_X or blocks_y > MAX_GRID_Y:
        raise ValueError(
            f"{name} kernel: {blocks_x} x {blocks_y} thread blocks exceed "
            f"the grid limit of {MAX_GRID_X} x {MAX_GRID_Y}; split the "
            f"input")


def check_launch(name: str, err: int) -> None:
    """Raise if the launch of kernel ``name`` was refused (``err`` is the
    ``cudaError_t`` its launcher returned); a refused launch never runs and
    a later synchronize does not report it."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name!r} failed to launch: cudaError {err}")
