#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root, no arguments, one card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (first
use), then runs six phases and prints one JSON object per line:

  env          torch/CUDA versions, the card, the kernels' build seconds,
               the HGMMA (16-bit wgmma) instructions of flash_attention
               and the IGMMA (int8 wgmma) instructions of int_matmul in
               the built library
  kernel_grid  every kernel against its plain PyTorch version on the card,
               over the CPU tests' shape grid and the main paths' real
               shapes, int_matmul on both of its routes over an edge grid
               of K, N and M, multithreshold on both of its routes over
               an edge grid of N and C (INT32_MIN/MAX, +-inf, NaN, equal
               thresholds, views off 16 bytes), quantize on misaligned
               views and ragged totals; integers and the dequant
               epilogue must be equal,
               flash attention within 2e-5 (float32) or, on the
               tensor-core kernel, one output ulp plus 2^-8 max|v|
               (bfloat16) / 2^-10 max|v| (float16): twice the effect of
               rounding P to 16 bits
  main_path    workload -> build_flow -> compile() -> inference for the
               four QNN workloads, TFC/CNV at the paper's widths and
               CNV-w2a8 (8-bit activations: N = 255 tails), batch 256:
               float64 mode bit-exact against the numpy interpreter,
               float32 mode (fused epilogues) to 1e-5; ms per batch, ms
               per op type from one ``profile()`` call, the int_matmul and
               multithreshold launches by route (each multithreshold call
               on the route ``route_for`` gives it; CNV-w2a8 must take the
               search) and the calls' shapes
  no_fallback  the launch counts of one inference equal what the plan says
               (so no route ran a plain version instead of its kernel)
  kernel_times each kernel's device time, wrapper, plain version, bound
               and library call at the main paths' shapes; int_matmul on
               both routes at every call of CNV(64,32) and TFC(784), both
               routes' device time at the other configurations' calls,
               and the tensor-core kernel's ring depth swept; both
               multithreshold routes swept over N (the crossover), the
               multithreshold bound by bytes or by the compares of a
               search, M*C*ceil(log2(N+1))
  lm_prefill   the LM slice: qwen2-1.5b at full width (28 layers) with
               seeded random weights.  float32, B=1, S=1024: logits with
               the flash-attention kernel against plain attention, and
               token-by-token ``decode_step`` against ``forward``; one
               kernel launch per layer.  bfloat16 (the published dtype):
               at B=1, S=2048 the logits through the kernel against a
               float32 forward of the same weights, no further from it
               than 1.5x the logits through the plain attention; ms per
               prefill, tokens/s and peak memory at B=4, S=2048 and B=1,
               S=32768

then a ``{"kernels": [...]}`` line (per kernel: launches on its path,
max abs error against the plain version, and at the main path's shape
``ms``, the kernel's time on the device, beside ``wrapper_ms``, one eager
call of its wrapper, the plain version, the card's bound and a library
call where one exists), the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and no result line is printed.  Without a CUDA device it
exits with code 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.core import build_flow                      # noqa: E402
from repro_torch.core.workloads import (WORKLOADS, make_cnv,  # noqa: E402
                                        make_tfc)
from repro_torch.kernels import _build, ops as kops          # noqa: E402
from repro_torch.kernels.int_matmul import (                 # noqa: E402
    CUDA_CORES, ROUTES, TENSOR_CORES, int_matmul as int_matmul_kernel,
    k_major, route_for)
from repro_torch.kernels.multithreshold import (             # noqa: E402
    ROUTES as MT_ROUTES, SEARCH, route_for as mt_route_for)
from repro_torch.kernels.flash_attention import (            # noqa: E402
    flash_attention_fwd, tolerance as fa_tolerance)
from repro_torch.kernels.ref import flash_attention_ref      # noqa: E402
from repro_torch.models import attention as lm_attention     # noqa: E402
from repro_torch.models import get_model                     # noqa: E402
from repro_torch.obs.trace import (Tracer, get_tracer,       # noqa: E402
                                   set_tracer)

DEV = torch.device("cuda")
BATCH = 256
GRAPH_LAUNCHES = 20      # wrapper calls per CUDA graph in ``device_ms``

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# 3.35 TB/s; int8 tensor cores 1979 TOP/s; bf16/fp16 tensor cores 989
# TFLOP/s; 67 TFLOP/s float32 outside the tensor cores, used here for
# int32 multiply-adds, for compares, which have no tensor-core path, and
# for exact float32 attention.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
ALU_OPS_PER_S = 67e12

# the LM slice: qwen2-1.5b's attention layer (B=1, S=4096) and its runs
LM_ARCH = "qwen2-1.5b"
LM_SEED = 0
FA_LAYER = dict(B=1, S=4096, H=12, KV=2, hd=128)
LM_F32 = (1, 1024)                        # (B, S) of the float32 checks
LM_BF16_CHECK = (1, 2048)                 # (B, S) of the bfloat16 check
LM_BF16 = ((4, 2048, 3), (1, 32768, 2))   # (B, S, timed calls), bfloat16


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def dev(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, launches: int, reps: int = 5) -> float:
    """Milliseconds the device takes per call of ``fn``: ``launches`` calls
    are captured into one CUDA graph and the graph is replayed, so the
    host's time per call (Python, ``torch.empty``, the launch) is left
    out and what remains is the kernel and the gap to the next one."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, reps, warmup=1) / launches


def max_abs_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    check(err == 0.0, f"{what}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


def bound(nbytes: float, ops: float, ops_per_s: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# --------------------------------------------------------------------------
# phase: env
# --------------------------------------------------------------------------

def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = _build.load()                   # builds the kernels from csrc/
    load_s = time.perf_counter() - t0
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must not run in TF32")
    sass = sass_mma(lib._name)
    check(sass["hgmma"]["flash_kernel_tc"] > 0,
          f"the 16-bit flash_attention kernel has no HGMMA: {sass}")
    check(sass["igmma"]["int8_matmul_tc"] > 0,
          f"the int8 int_matmul kernel has no IGMMA: {sass}")
    return dict(phase="env", python=sys.version.split()[0],
                torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                kernel_build_s=round(_build.build_seconds, 2),
                kernel_load_s=round(load_s, 2), sass_hgmma=sass["hgmma"],
                sass_igmma=sass["igmma"], sass_gmma_opcodes=sass["opcodes"])


def sass_mma(library: str) -> dict:
    """Warpgroup MMA instructions in the built library, from ``cuobjdump
    --dump-sass``: HGMMA (16-bit wgmma) in the flash_attention kernels
    (``flash_kernel_tc``) and elsewhere, IGMMA (integer wgmma) in the
    int8 int_matmul kernels (``int8_matmul_tc``) and elsewhere, and every
    distinct opcode that ends in GMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", library],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = dict(hgmma=dict(flash_kernel_tc=0, other=0),
                  igmma=dict(int8_matmul_tc=0, other=0), opcodes=set())
    func = ""
    for line in sass.splitlines():
        if "Function :" in line:
            func = line
            continue
        for word in line.replace(";", " ").split():
            op = word.split(".")[0]
            if op.endswith("GMMA"):
                counts["opcodes"].add(op)
                if op == "HGMMA":
                    counts["hgmma"]["flash_kernel_tc" if "flash_kernel_tc"
                                    in func else "other"] += 1
                elif op == "IGMMA":
                    counts["igmma"]["int8_matmul_tc" if "int8_matmul_tc"
                                    in func else "other"] += 1
                break
    counts["opcodes"] = sorted(counts["opcodes"])
    return counts


# --------------------------------------------------------------------------
# phase: kernel_grid — each kernel against its plain version, on the card
# --------------------------------------------------------------------------

# the int8 edge grid of both int_matmul routes: every K, N and M crossed
IM_GRID_K = (8, 9, 16, 27, 32, 33, 49, 144, 576, 2304)
IM_GRID_N = (1, 8, 10, 16, 64, 256, 257)
IM_GRID_M = (1, 63, 65, 129, 4096)


def grid_int_matmul(rng) -> dict:
    worst, cases = 0.0, 0
    by_route = {r: 0 for r in ROUTES}

    def one(x, w, what, route=None, **kw):
        nonlocal worst, cases
        got = kops.int_matmul(x, w, use_kernel=True, route=route, **kw)
        want = kops.int_matmul(x, w, use_kernel=False, **kw)
        worst = max(worst, max_abs_err(
            got, want, f"int_matmul {what} route={route} {kw}"))
        cases += 1
        if route is not None:
            by_route[route] += 1

    def both(x, w, what, **kw):
        for route in ROUTES:
            one(x, w, what, route, **kw)

    # the CPU tests' shapes on the automatic route, int8 and int32
    shapes = [(128, 128, 128), (1, 49, 10), (7, 3, 5), (130, 200, 10),
              (8, 64, 100), (300, 9, 1), (256, 64, 10)]
    for dt in (np.int8, np.int32):
        for m, k, n in shapes:
            x = dev(rng.integers(-128, 128, (m, k)).astype(dt))
            w = dev(rng.integers(-8, 8, (k, n)).astype(dt))
            s = dev(rng.uniform(0.01, 0.1, n).astype(np.float32))
            b = dev(rng.normal(size=n).astype(np.float32))
            tag = f"{np.dtype(dt).name} {m}x{k}x{n}"
            run = both if dt == np.int8 else one
            run(x, w, tag + " wide")
            run(x, w, tag + " narrow", acc_bits=12)
            run(x, w, tag + " narrow->i32", acc_bits=12,
                out_dtype=torch.int32)
            run(x, w, tag + " dequant", scale=s, bias=b)
            run(x, w, tag + " dequant no bias", scale=s, acc_bits=12)
            run(x, w, tag + " scalar scale", scale=s[:1])
        # an accumulator that overflows int16: the wrap must match
        x = dev(rng.integers(-100, 101, (128, 128)).astype(dt))
        w = dev(rng.integers(-100, 101, (128, 128)).astype(dt))
        (both if dt == np.int8 else one)(
            x, w, f"{np.dtype(dt).name} int16 overflow", acc_bits=12)
    # int32 products that wrap modulo 2^32
    x = dev(rng.integers(-2 ** 20, 2 ** 20, (9, 33)).astype(np.int32))
    w = dev(rng.integers(-2 ** 20, 2 ** 20, (33, 6)).astype(np.int32))
    one(x, w, "int32 wrap")
    # the int8 edge grid, both routes, both weight layouts (row-major
    # (K, N) and the K-major view the lowering stores) and five output
    # forms in turn
    forms = [dict(), dict(acc_bits=12), dict(acc_bits=13,
                                               out_dtype=torch.int32),
             dict(scale=True, bias=True), dict(scale=True, acc_bits=12)]
    i = 0
    for k in IM_GRID_K:
        for n in IM_GRID_N:
            w = dev(rng.integers(-8, 8, (k, n)).astype(np.int8))
            s = dev(rng.uniform(0.01, 0.1, n).astype(np.float32))
            b = dev(rng.normal(size=n).astype(np.float32))
            for m in IM_GRID_M:
                x = dev(rng.integers(-128, 128, (m, k)).astype(np.int8))
                kw = dict(forms[i % len(forms)])
                if "scale" in kw:
                    kw["scale"] = s
                if "bias" in kw:
                    kw["bias"] = b
                wl = k_major(w) if i % 2 else w
                both(x, wl, f"{m}x{k}x{n} "
                            f"{'K-major' if i % 2 else 'row-major'} w", **kw)
                i += 1
    # an int16 overflow in narrow mode at a main-path depth
    x = dev(rng.integers(-128, 128, (1000, 576)).astype(np.int8))
    w = dev(rng.integers(-128, 128, (576, 64)).astype(np.int8))
    both(x, w, "int16 overflow 1000x576x64", acc_bits=15)
    both(x, w, "int16 overflow to int32", acc_bits=15, out_dtype=torch.int32)
    # x a view at an odd byte offset (no TMA: the producer loads it), and
    # a view whose rows are wider than K
    for k in (64, 27):
        flat = dev(rng.integers(-128, 128, 300 * k + 1).astype(np.int8))
        x = flat[1:].view(300, k)
        w = dev(rng.integers(-8, 8, (k, 24)).astype(np.int8))
        both(x, w, f"odd offset 300x{k}x24", acc_bits=14)
        wide = dev(rng.integers(-128, 128, (300, k + 16)).astype(np.int8))
        both(wide[:, 16:], w, f"row pitch {k + 16} 300x{k}x24")
    # a forced tensor-core launch it cannot take raises, nothing runs
    xi = dev(rng.integers(-8, 8, (64, 64)).astype(np.int32))
    before = dict(_build.LAUNCH_COUNTS)
    try:
        kops.int_matmul(xi, xi, use_kernel=True, route=TENSOR_CORES)
    except ValueError:
        cases += 1
    else:
        check(False, "the tensor-core int_matmul took int32 operands")
    check(dict(_build.LAUNCH_COUNTS) == before,
          "a refused tensor-core int_matmul launched a kernel")
    # the main path's largest call (CNV(64,32) 2nd conv, int8, 12-bit
    # accumulator to int32) and the dense 784 -> 64 layer in int32
    x = dev(rng.integers(-2, 2, (BATCH * 32 * 32, 576)).astype(np.int8))
    w = dev(rng.integers(-2, 2, (576, 64)).astype(np.int8))
    both(x, k_major(w), "int8 262144x576x64", acc_bits=12,
         out_dtype=torch.int32)
    x = dev(rng.integers(0, 256, (BATCH, 784)).astype(np.int32))
    w = dev(rng.integers(-2, 2, (784, 64)).astype(np.int32))
    one(x, w, "int32 256x784x64", acc_bits=20, out_dtype=torch.int32)
    return dict(cases=cases, cases_by_forced_route=by_route,
                max_abs_err=worst)


# the edge grid of both multithreshold routes: every N and C crossed, in
# int32, float32 and float64
MT_GRID_N = (0, 1, 2, 3, 7, 15, 16, 31, 63, 64, 127, 128, 255)
MT_GRID_C = (1, 4, 8, 16, 17, 33, 64, 130, 256)
MT_GRID_M = (5, 37, 300, 1000)
MT_OUT = (torch.int8, torch.int16, torch.int32)


def offset_view(a: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of ``a`` whose data lies ``nbytes`` past a 16-byte
    boundary (a view into a larger buffer)."""
    size = a.element_size()
    flat = torch.empty(a.numel() + 32 // size, dtype=a.dtype,
                       device=a.device)
    lead = (-flat.data_ptr() % 16 + nbytes) // size
    view = flat[lead:lead + a.numel()].view(a.shape)
    view.copy_(a)
    check(view.data_ptr() % 16 == nbytes, "offset_view missed its offset")
    return view


def mt_edge_case(rng, m, c, n, dt):
    """x (m, c) and ascending thresholds (n, c) of numpy type ``dt`` with
    the edge values: INT32_MIN/MAX (int32), +-inf (floats) in x and T, NaN
    in x, a run of equal thresholds, rows of exact ties."""
    if dt == np.int32:
        info = np.iinfo(np.int32)
        pool = np.array([info.min, info.min + 1, info.max - 1, info.max, 0,
                         -1, 1], np.int64)
        t = rng.integers(-300, 300, (n, c))
        x = rng.integers(-350, 350, (m, c))
        xpool = pool
    else:
        pool = np.array([np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30])
        t = rng.integers(-1200, 1200, (n, c)) / 4
        x = rng.integers(-1400, 1400, (m, c)) / 4
        xpool = np.append(pool, np.nan)
    t = np.where(rng.random((n, c)) < 0.1, rng.choice(pool, (n, c)), t)
    x = np.where(rng.random((m, c)) < 0.1, rng.choice(xpool, (m, c)), x)
    if n > 4:
        t[:3] = t[3]                     # a run of equal thresholds
    t = np.sort(t.astype(dt), axis=0)
    x = x.astype(dt)
    if n and m > 2:                      # rows of exact ties
        x[1] = t[n // 2]
        x[2] = t[-1]
    return x, t


def grid_multithreshold(rng) -> dict:
    worst, cases = 0.0, 0
    by_route = {r: 0 for r in MT_ROUTES}

    def one(x, t, what, route=None, **kw):
        nonlocal worst, cases
        got = kops.multithreshold(x, t, use_kernel=True, route=route, **kw)
        want = kops.multithreshold(x, t, use_kernel=False, **kw)
        worst = max(worst, max_abs_err(
            got, want, f"multithreshold {what} route={route} {kw}"))
        cases += 1
        if route is not None:
            by_route[route] += 1

    # the CPU tests' shapes and the main path's, on the automatic route
    shapes = [(5, 3, 3), (1, 10, 15), (33, 130, 7), (256, 128, 255),
              (BATCH * 32 * 32, 64, 3), (BATCH * 32 * 32, 64, 15),
              (BATCH * 16 * 16, 64, 255), (BATCH * 16 * 16, 16, 255)]
    for dt in (np.int32, np.float32, np.float64):
        for m, c, n in shapes:
            # quarter-grid values (truncated to whole numbers for int32):
            # exact ties are frequent, and ties count
            x = dev((rng.integers(-2000, 2000, (m, c)) / 4).astype(dt))
            t = dev(np.sort((rng.integers(-1600, 1600, (n, c)) / 4
                             ).astype(dt), axis=0))
            for kw in (dict(out_bias=-1), dict(out_dtype=torch.int32),
                       dict(out_bias=3, out_dtype=torch.int16)):
                one(x, t, f"{np.dtype(dt).name} {m}x{c} N={n}", **kw)
    # the edge grid, each route forced; every fifth x one element past a
    # 16-byte boundary (4 bytes; 8 for float64: no 16-byte loads), output
    # types and biases in turns
    i = 0
    for dt in (np.int32, np.float32, np.float64):
        for n in MT_GRID_N:
            for c in MT_GRID_C:
                m = MT_GRID_M[i % len(MT_GRID_M)]
                xn, tn = mt_edge_case(rng, m, c, n, dt)
                x, t = dev(xn), dev(tn)
                if i % 5 == 0:
                    x = offset_view(x, x.element_size())
                kw = dict(out_bias=(0, -1, 3, -128)[i % 4],
                          out_dtype=MT_OUT[i % 3])
                for route in MT_ROUTES:
                    one(x, t, f"edge {np.dtype(dt).name} {m}x{c} N={n}"
                              f"{' offset' if i % 5 == 0 else ''}",
                        route, **kw)
                i += 1
    x = torch.full((8, 4), 10_000, dtype=torch.int32, device=DEV)
    t = torch.arange(255, dtype=torch.int32, device=DEV)[:, None] \
        .expand(255, 4)
    out = kops.multithreshold(x, t, use_kernel=True)
    check(out.dtype == torch.int16 and int(out.max()) == 255
          and int(out.min()) == 255, "N=255 output wrapped")
    return dict(cases=cases + 1, cases_by_forced_route=by_route,
                max_abs_err=worst)


def grid_quantize(rng) -> dict:
    worst, cases = 0.0, 0
    # totals that are not a multiple of 4, per-channel C that is not either
    shapes = [(1, 1), (3, 10), (257, 5), (256, 128), (7, 3), (33, 7),
              (BATCH * 3 * 16, 16), (BATCH * 3 * 32, 32), (BATCH, 49),
              (BATCH, 784)]
    for dt in (np.float32, np.float64):
        for m, c in shapes:
            for offset in (0, 4, 8):     # x on 16 bytes, and views off it
                if offset == 4 and dt == np.float64:
                    continue
                x = dev((rng.normal(size=(m, c)) * 3).astype(dt))
                if offset:
                    x = offset_view(x, offset)
                s = dev(rng.uniform(0.01, 0.3, c).astype(np.float32))
                z = dev(rng.integers(-2, 3, c).astype(np.float32))
                for kw in (dict(), dict(qmin=-8, qmax=7),
                           dict(qmin=0, qmax=255, out_dtype=torch.int32)):
                    for sc, zp in ((s, z), (s[:1], z[:1])):
                        got = kops.quantize(x, sc, zp, use_kernel=True, **kw)
                        want = kops.quantize(x, sc, zp, use_kernel=False,
                                             **kw)
                        worst = max(worst, max_abs_err(
                            got, want, f"quantize {np.dtype(dt).name} {m}x{c}"
                                       f" offset {offset} {kw}"))
                        cases += 1
        # x / s lands exactly on k + 0.5: round half to even
        k = np.arange(-12, 12)
        x = dev(((k + 0.5) * 0.25).astype(dt).reshape(4, 6))
        s = torch.tensor([0.25], device=DEV)
        z = torch.zeros(1, device=DEV)
        got = kops.quantize(x, s, z, qmin=-8, qmax=7, out_dtype=torch.int32,
                            use_kernel=True)
        want = np.clip(np.round(k + 0.5), -8, 7).reshape(4, 6)
        check(np.array_equal(got.cpu().numpy(), want),
              "quantize does not round half to even")
        cases += 1
    return dict(cases=cases, max_abs_err=worst)


def flash_err(got: torch.Tensor, want: torch.Tensor, v: torch.Tensor,
              what: str) -> float:
    """Max abs error of the kernel against its plain version; raises
    beyond ``flash_attention.tolerance``: 2e-5 (absolute and relative) in
    float32; in bfloat16 / float16 one ulp of the plain version's output
    plus twice the effect of rounding P to 16 bits (2^-8 max|v| in bf16,
    2^-10 max|v| in f16)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: dtype/shape {got.dtype}{tuple(got.shape)} vs "
          f"{want.dtype}{tuple(want.shape)}")
    d = (got.double() - want.double()).abs()
    check(bool((d <= fa_tolerance(want, v)).all())
          and bool(torch.isfinite(got).all()),
          f"{what}: kernel differs from its plain version (max abs err "
          f"{float(d.max())})")
    return float(d.max())


# (name, B, Sq, Sk, H, KV, hd, keywords): each in float32, bfloat16 and
# float16; the CPU tests' grid (the reference's own kernel test), then
# ragged lengths, window, q_offset, cap, masked rows, non-causal, hd 16 to
# 256, a chunked prefill
FA_GRID = [
    ("gqa", 2, 128, 128, 4, 2, 64, {}),
    ("cap", 1, 256, 256, 8, 8, 64, dict(logit_cap=50.0)),
    ("gqa3", 2, 128, 128, 6, 2, 32, {}),
    ("ragged", 2, 100, 100, 4, 2, 32, {}),
    ("window", 1, 300, 300, 4, 2, 16, dict(window=37)),
    ("q_offset", 2, 24, 88, 4, 2, 40, dict(q_offset=64)),
    ("q_offset window cap", 1, 33, 97, 4, 2, 16,
     dict(q_offset=64, window=16, logit_cap=30.0)),
    ("fully masked rows", 1, 16, 32, 4, 2, 16, dict(q_offset=64, window=8)),
    ("not causal", 1, 40, 70, 2, 1, 16, dict(causal=False, window=12)),
    ("hd 256 cap", 1, 130, 130, 8, 4, 256, dict(logit_cap=50.0)),
    ("hd 256 window cap", 1, 700, 700, 8, 4, 256,
     dict(window=256, logit_cap=50.0)),
    ("hd 128", 2, 200, 200, 12, 2, 128, {}),
    ("hd 64", 1, 150, 150, 4, 2, 64, {}),
    ("chunked prefill", 1, 1000, 3048, 12, 2, 128, dict(q_offset=2048)),
]


def grid_flash_attention() -> dict:
    worst, cases = 0.0, 0
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = FA_LAYER
    grid = [(name, B, Sq, Sk, H, KV, hd, dt, kw)
            for name, B, Sq, Sk, H, KV, hd, kw in FA_GRID
            for dt in (torch.float32, torch.bfloat16, torch.float16)]
    # the slice's real layer shape
    grid += [("layer", L["B"], L["S"], L["S"], L["H"], L["KV"], L["hd"], dt,
              {}) for dt in (torch.float32, torch.bfloat16, torch.float16)]
    for name, B, Sq, Sk, H, KV, hd, dt, kw in grid:
        q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).to(dt)
        k = torch.randn((B, Sk, KV, hd), generator=gen, device=DEV).to(dt)
        v = torch.randn((B, Sk, KV, hd), generator=gen, device=DEV).to(dt)
        got = flash_attention_fwd(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        worst = max(worst, flash_err(
            got, want, v, f"flash_attention {name} {str(dt)[6:]} B{B} Sq{Sq} "
                          f"Sk{Sk} H{H} KV{KV} hd{hd} {kw}"))
        cases += 1
        del q, k, v, got, want
    # the tensor-core kernel refuses 16-bit rows that are not 16 bytes
    x = torch.zeros((1, 8, 2, 12), dtype=torch.bfloat16, device=DEV)
    try:
        flash_attention_fwd(x, x[:, :, :1], x[:, :, :1])
    except ValueError:
        cases += 1
    else:
        check(False, "flash_attention took bf16 with hd = 12")
    return dict(cases=cases, max_abs_err=worst)


def phase_kernel_grid() -> dict:
    rng = np.random.default_rng(0)
    out = dict(phase="kernel_grid",
               int_matmul=grid_int_matmul(rng),
               multithreshold=grid_multithreshold(rng),
               quantize=grid_quantize(rng),
               flash_attention=grid_flash_attention())
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# kernel times at the main path's shapes
# --------------------------------------------------------------------------

def time_int_matmul(rng, m, k, n, dt, acc_bits, fused, per_batch=None
                    ) -> dict:
    """Both routes at one shape (int32 operands: the CUDA cores only), the
    weight K-major as the lowering stores it; the automatic route's time
    is ``ms``.  ``torch._int_mm`` where it takes the shape (int8, K and N
    multiples of 8, M > 16)."""
    tdt = torch.int8 if dt == np.int8 else torch.int32
    x = dev(rng.integers(-2, 2, (m, k)).astype(dt))
    w_rm = dev(rng.integers(-2, 2, (k, n)).astype(dt))
    w = k_major(w_rm) if tdt == torch.int8 else w_rm
    s = dev(rng.uniform(0.01, 0.1, n).astype(np.float32)) if fused else None
    b = dev(rng.normal(size=n).astype(np.float32)) if fused else None
    kw = dict(acc_bits=acc_bits,
              out_dtype=torch.float32 if fused else torch.int32)
    routes = ROUTES if tdt == torch.int8 else (CUDA_CORES,)
    auto = route_for(m, k, n, tdt)
    per_route = {}
    for r in routes:
        def kernel(r=r):
            return kops.int_matmul(x, w, s, b, use_kernel=True, route=r,
                                   **kw)
        per_route[r] = dict(ms=device_ms(kernel, GRAPH_LAUNCHES),
                            wrapper_ms=time_ms(kernel, 10))
    plain = time_ms(lambda: kops.int_matmul(x, w, s, b, use_kernel=False,
                                            **kw), 3, warmup=1)
    size = np.dtype(dt).itemsize
    b_ms, by = bound(m * k * size + k * n * size + m * n * 4
                     + (8 * n if fused else 0), 2.0 * m * k * n,
                     INT8_OPS_PER_S if size == 1 else ALU_OPS_PER_S)
    lib = None
    if tdt == torch.int8 and k % 8 == 0 and n % 8 == 0 and m > 16:
        # timed here only; the port never calls it
        lib = time_ms(lambda: torch._int_mm(x, w_rm), 10)
    return dict(shape=f"{np.dtype(dt).name} {m}x{k}x{n} acc{acc_bits}"
                      f"{' fused' if fused else ''}",
                route=auto, ms=per_route[auto]["ms"],
                wrapper_ms=per_route[auto]["wrapper_ms"], plain_ms=plain,
                bound_ms=b_ms, bound_by=by, library_ms=lib,
                launches_per_batch=per_batch, **per_route)


def route_table(rng, calls) -> list:
    """Device ms of both int_matmul routes at each distinct int8 call of
    a configuration (what ``route_for`` is chosen from)."""
    rows = []
    for m, k, n, dt, acc_bits, fused, count in calls:
        if dt != "int8":
            continue
        x = dev(rng.integers(-2, 2, (m, k)).astype(np.int8))
        w = k_major(dev(rng.integers(-2, 2, (k, n)).astype(np.int8)))
        s = dev(np.full(n, 0.05, np.float32)) if fused else None
        kw = dict(acc_bits=acc_bits,
                  out_dtype=torch.float32 if fused else torch.int32)
        row = dict(shape=f"{m}x{k}x{n}", calls=count,
                   route=route_for(m, k, n, torch.int8))
        for r in ROUTES:
            row[r] = device_ms(
                lambda r=r: kops.int_matmul(x, w, s, use_kernel=True,
                                            route=r, **kw), GRAPH_LAUNCHES)
        rows.append(row)
    return rows


def stage_sweep(rng, m, k, n, stages) -> dict:
    """Device ms of the tensor-core kernel at each ring depth."""
    x = dev(rng.integers(-2, 2, (m, k)).astype(np.int8))
    w = k_major(dev(rng.integers(-2, 2, (k, n)).astype(np.int8)))
    ms = {}
    for st in stages:
        ms[st] = device_ms(
            lambda st=st: int_matmul_kernel(
                x, w, acc_bits=12, out_dtype=torch.int32,
                route=TENSOR_CORES, stages=st), GRAPH_LAUNCHES)
    return dict(shape=f"{m}x{k}x{n}", ms_by_stages=ms)


def mt_bound(m, c, n, dt):
    """Bytes (x and T read once, an int32 out written once) against the
    compares of a search, M*C*ceil(log2(N + 1)): the least work of the
    function, not the M*C*N of a linear count."""
    size = np.dtype(dt).itemsize
    return bound(m * c * size + n * c * size + m * c * 4,
                 float(m) * c * int(n).bit_length(), ALU_OPS_PER_S)


def mt_inputs(rng, m, c, n, dt):
    x = dev(rng.integers(-500, 500, (m, c)).astype(dt))
    t = dev(np.sort(rng.integers(-400, 400, (n, c)), axis=0).astype(dt))
    return x, t


def mt_route_ms(x, t) -> dict:
    """Device ms per launch of each multithreshold route, forced."""
    return {r: device_ms(lambda r=r: kops.multithreshold(
        x, t, use_kernel=True, route=r, out_dtype=torch.int32),
        GRAPH_LAUNCHES) for r in MT_ROUTES}


def time_multithreshold(rng, m, c, n, dt, per_batch=None) -> dict:
    """The automatic route's time is ``ms``; both routes' beside it."""
    x, t = mt_inputs(rng, m, c, n, dt)
    kw = dict(out_dtype=torch.int32)

    def kernel():
        return kops.multithreshold(x, t, use_kernel=True, **kw)

    def library():    # timed here only; the port never calls it
        return torch.searchsorted(t.T.contiguous(), x.T.contiguous(),
                                  right=True)
    wrapper = time_ms(kernel, 10)
    by_route = mt_route_ms(x, t)
    auto = mt_route_for(m, c, n, x.dtype)
    plain = time_ms(
        lambda: kops.multithreshold(x, t, use_kernel=False, **kw),
        2, warmup=1)
    check(torch.equal(library().T.to(torch.int32), kernel()),
          f"multithreshold {m}x{c} N={n}: torch.searchsorted disagrees")
    lib = time_ms(library, 5, warmup=1)
    b_ms, by = mt_bound(m, c, n, dt)
    return dict(shape=f"{np.dtype(dt).name} {m}x{c} N={n}", route=auto,
                ms=by_route[auto], ms_by_route=by_route, wrapper_ms=wrapper,
                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
                launches_per_batch=per_batch)


def mt_sweep(rng, m, c, dt, ns) -> dict:
    """Both routes at each N (what ``route_for``'s crossover comes
    from)."""
    rows = []
    for n in ns:
        x, t = mt_inputs(rng, m, c, n, dt)
        b_ms, by = mt_bound(m, c, n, dt)
        rows.append(dict(N=n, route=mt_route_for(m, c, n, x.dtype),
                         bound_ms=b_ms, bound_by=by, **mt_route_ms(x, t)))
    return dict(shape=f"{np.dtype(dt).name} {m}x{c}", rows=rows)


def time_quantize(rng, m, c, dt) -> dict:
    x = dev((rng.normal(size=(m, c)) * 3).astype(dt))
    s = torch.tensor([1.0 / 127], device=DEV)
    z = torch.zeros(1, device=DEV)
    kw = dict(qmin=0, qmax=255, out_dtype=torch.int32)
    def kernel():
        return kops.quantize(x, s, z, use_kernel=True, **kw)
    wrapper = time_ms(kernel, 20)
    ms = device_ms(kernel, GRAPH_LAUNCHES)
    plain = time_ms(lambda: kops.quantize(x, s, z, use_kernel=False, **kw),
                    20)
    size = np.dtype(dt).itemsize
    # divide, add, round, two clamps per element
    b_ms, by = bound(m * c * size + 8 + m * c * 4, 5.0 * m * c,
                     ALU_OPS_PER_S)
    # no single PyTorch call computes it: torch.quantize_per_tensor
    # multiplies by a reciprocal and adds the zero point after rounding
    return dict(shape=f"{np.dtype(dt).name} {m}x{c}", ms=ms,
                wrapper_ms=wrapper, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, library_ms=None)


def time_flash_attention(dt) -> dict:
    L = FA_LAYER
    B, S, H, KV, hd = L["B"], L["S"], L["H"], L["KV"], L["hd"]
    gen = torch.Generator(device=DEV).manual_seed(1)
    q = torch.randn((B, S, H, hd), generator=gen, device=DEV).to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(dt)
    v = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(dt)

    def kernel():
        return flash_attention_fwd(q, k, v)

    def library():       # timed here only; the port never calls it
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    wrapper = time_ms(kernel, 10)
    ms = device_ms(kernel, GRAPH_LAUNCHES)
    plain = time_ms(lambda: flash_attention_ref(q, k, v), 3, warmup=1)
    lib = time_ms(library, 10)
    lib_diff = float((library().double() - kernel().double()).abs().max())
    size = q.element_size()
    # the causal mask keeps S(S+1)/2 query-key pairs: the work these
    # inputs need
    ops = 4.0 * B * H * hd * (S * (S + 1) // 2)
    b_ms, by = bound((2 * q.numel() + k.numel() + v.numel()) * size, ops,
                     ALU_OPS_PER_S if dt == torch.float32
                     else BF16_OPS_PER_S)
    return dict(shape=f"{str(dt)[6:]} B{B} S{S} H{H} KV{KV} hd{hd} causal",
                ms=ms, tflops=ops / ms / 1e9, wrapper_ms=wrapper,
                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
                library_tflops=ops / lib / 1e9,
                library="F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
                library_max_abs_diff=lib_diff,
                bound_peak="989 TFLOP/s bf16 tensor cores"
                if dt != torch.float32 else "67 TFLOP/s float32 (exact "
                "float32 has no tensor-core path)")


def phase_kernel_times(configs) -> dict:
    """The first entry of each list is the shape the ``kernels`` line
    reports: the largest call of CNV-w2a2 (ch=64, img=32) at batch 256,
    and for flash attention one bfloat16 layer of qwen2-1.5b at S=4096.
    ``int_matmul`` has one row per distinct call of CNV(64,32) and
    TFC(784) at batch 256 (as recorded in ``main_path``), then the int32
    route; ``int_matmul_routes`` both routes at every distinct int8 call
    of the other configurations."""
    rng = np.random.default_rng(1)
    hw = BATCH * 32 * 32
    calls = {r["name"]: r["int_matmul_calls"] for r in configs}
    wide = calls[IM_TIMED[0]] + calls[IM_TIMED[1]]
    first = [c for c in wide if c[:3] == [hw, 576, 64]]
    check(len(first) == 1, f"CNV(64,32) has no single {hw}x576x64 call")
    rows = [time_int_matmul(rng, m, k, n, np.dtype(dt).type, acc, fused,
                            count)
            for m, k, n, dt, acc, fused, count in first + [
                c for c in wide if c not in first]]
    rows.append(time_int_matmul(rng, BATCH, 784, 64, np.int32, 20, False))
    return dict(
        phase="kernel_times",
        note="ms: device time per launch, from replays of a CUDA graph of "
             f"{GRAPH_LAUNCHES} wrapper calls; wrapper_ms, plain_ms, "
             "library_ms: per eager call by CUDA events after warm-up, "
             "host time included; inputs above the L2 size are cold by "
             "their size, smaller ones are warm",
        int_matmul=rows,
        int_matmul_routes={name: route_table(rng, c)
                           for name, c in calls.items()
                           if name not in IM_TIMED},
        int_matmul_stages=[stage_sweep(rng, hw, 576, 64, range(2, 9)),
                           stage_sweep(rng, hw // 16, 2304, 256,
                                       range(2, 5))],
        multithreshold=[
            time_multithreshold(rng, hw, 64, 3, np.int32, 2),
            time_multithreshold(rng, hw, 64, 15, np.int32),
            time_multithreshold(rng, hw // 4, 64, 255, np.int32),
            time_multithreshold(rng, hw, 64, 3, np.float32),
            time_multithreshold(rng, hw, 64, 3, np.float64),
            time_multithreshold(rng, hw, 64, 15, np.float64),
            time_multithreshold(rng, hw // 4, 64, 255, np.float64),
            time_multithreshold(rng, BATCH, 64, 3, np.int32),
            # CNV-w2a8's tails at batch 256 (two launches each but the last)
            time_multithreshold(rng, BATCH * 256, 16, 255, np.int32, 2),
            time_multithreshold(rng, BATCH * 64, 32, 255, np.int32, 2),
            time_multithreshold(rng, BATCH * 16, 64, 255, np.int32, 2),
            time_multithreshold(rng, BATCH, 32, 255, np.float32, 1),
        ],
        multithreshold_sweep=[
            mt_sweep(rng, hw, 64, np.int32, MT_SWEEP_N),
            mt_sweep(rng, BATCH * 256, 16, np.int32, MT_SWEEP_N),
            mt_sweep(rng, hw // 4, 64, np.float64, MT_SWEEP_N),
        ],
        quantize=[
            time_quantize(rng, BATCH * 3 * 32, 32, np.float32),
            time_quantize(rng, BATCH * 3 * 16, 16, np.float32),
            time_quantize(rng, BATCH, 49, np.float32),
            time_quantize(rng, BATCH * 3 * 32, 32, np.float64),
            time_quantize(rng, BATCH, 784, np.float32),
        ],
        flash_attention=[time_flash_attention(torch.bfloat16),
                         time_flash_attention(torch.float32)])


# --------------------------------------------------------------------------
# phases: main_path and no_fallback
# --------------------------------------------------------------------------

CONFIGS = [(name, fn, {}) for name, fn in WORKLOADS.items()] + [
    ("CNV-w2a2(ch=64,img=32)", make_cnv, dict(ch=64, img=32)),
    ("TFC-w2a2(in_dim=784)", make_tfc, dict(in_dim=784)),
    # 8-bit activations: seven tails of N = 255 thresholds
    ("CNV-w2a8", make_cnv, dict(wbits=2, abits=8)),
]
# the configuration whose tails must take the search route
MT_SEARCH_CONFIG = "CNV-w2a8"
# the N of kernel_times' sweep of both multithreshold routes
MT_SWEEP_N = (3, 7, 15, 31, 63, 127, 255)
# the configurations whose int_matmul calls kernel_times times in full
IM_TIMED = ("CNV-w2a2(ch=64,img=32)", "TFC-w2a2(in_dim=784)")


@contextlib.contextmanager
def record_int_matmul(calls: list):
    """Record (M, K, N, operand dtype, acc_bits, fused) of every
    ``int_matmul`` call the lowered model makes."""
    kernel = kops.int_matmul

    def recorder(x, w, scale=None, bias=None, **kw):
        calls.append((int(x.shape[0]), int(x.shape[1]), int(w.shape[1]),
                      str(x.dtype)[6:], int(kw.get("acc_bits", 32)),
                      scale is not None))
        return kernel(x, w, scale, bias, **kw)
    kops.int_matmul = recorder
    try:
        yield
    finally:
        kops.int_matmul = kernel


@contextlib.contextmanager
def record_multithreshold(calls: list):
    """Record (M, C, N, compare dtype) of every ``multithreshold`` call
    the lowered model makes."""
    kernel = kops.multithreshold

    def recorder(x, t, **kw):
        calls.append((int(x.shape[0]), int(x.shape[1]), int(t.shape[0]),
                      str(x.dtype)[6:]))
        return kernel(x, t, **kw)
    kops.multithreshold = recorder
    try:
        yield
    finally:
        kops.multithreshold = kernel


def feeds_for(model, batch: int, seed: int) -> dict:
    shape = (batch,) + tuple(model.metadata["input_shape"][1:])
    (inp,) = model.graph.inputs
    r = model.input_ranges[inp]
    lo = np.broadcast_to(np.asarray(r.lo, np.float64), shape)
    hi = np.broadcast_to(np.asarray(r.hi, np.float64), shape)
    return {inp: np.random.default_rng(seed).uniform(lo, hi, size=shape)}


def expected_launches(model, compiled) -> dict:
    """Launches one inference must make, from the plan: one per quantize
    and multithreshold node, one per group of each integer matmul/conv."""
    groups = {n.name: int(n.attrs.get("groups", 1))
              for n in model.graph.nodes if n.op_type == "Conv"}
    want = dict(int_matmul=0, multithreshold=0, quantize=0)
    for op in compiled.plan:
        if op.kind in ("int_matmul", "fused:int_matmul+epilogue"):
            want["int_matmul"] += 1
        elif op.kind in ("int_conv", "fused:int_conv+epilogue"):
            want["int_matmul"] += groups[op.node_name]
        elif op.kind in want:
            want[op.kind] += 1
    return want


def profile_by_op(compiled, feeds) -> dict:
    """One ``profile()`` call: ms per op type, each step timed on the host
    with a device synchronise after it (so the steps do not overlap and
    their sum exceeds a normal call's time)."""
    tracer, prev = Tracer(enabled=True), get_tracer()
    set_tracer(tracer)
    try:
        compiled.profile(feeds)
    finally:
        set_tracer(prev)
    by_op: dict = {}
    for sp in tracer.spans:
        if sp.name.startswith("kernel:"):
            op = sp.name.split(":")[1]
            by_op[op] = by_op.get(op, 0.0) + sp.dur_us / 1e3
    return {k: round(v, 4) for k, v in by_op.items()}


def run_config(name, factory, kwargs) -> dict:
    t0 = time.perf_counter()
    model = build_flow(factory(**kwargs)).model
    flow_s = time.perf_counter() - t0

    # float64, kernels on the card: the integer core is bit-exact against
    # the numpy interpreter, the outputs agree to 1e-12
    exact = model.compile(dtype=torch.float64)
    check(exact.device.type == "cuda", "compile() did not pick the card")
    check(len(exact.int_tensors) > 0, f"{name}: no integer tensors")
    exact = model.compile(dtype=torch.float64,
                          extra_outputs=exact.int_tensors)
    small = feeds_for(model, 4, seed=0)
    want = model.execute(small, record_all=True)
    got = exact(small)
    for t in exact.int_tensors:
        check(got[t].dtype == np.int32
              and np.array_equal(got[t].astype(np.float64), want[t]),
              f"{name}: integer tensor {t} is not bit-exact")
    for o in model.graph.outputs:
        check(np.allclose(got[o], want[o], rtol=1e-12, atol=1e-12),
              f"{name}: float64 output {o} differs from the interpreter")

    # float32 with fused epilogues at the full batch
    fast = model.compile()
    check(fast.dtype == torch.float32 and fast.device.type == "cuda",
          "default compile() must be float32 on the card")
    feeds = feeds_for(model, BATCH, seed=1)
    (inp,) = model.graph.inputs
    before = dict(_build.LAUNCH_COUNTS)
    calls: list = []
    mt_calls: list = []
    with record_int_matmul(calls), record_multithreshold(mt_calls):
        out = fast(feeds)
    moved = {k: v - before.get(k, 0)
             for k, v in _build.LAUNCH_COUNTS.items()}
    expect = expected_launches(model, fast)
    launched = {k: moved.get(k, 0) for k in expect}
    by_route = {r: moved.get(f"int_matmul:{r}", 0) for r in ROUTES}
    check(sum(by_route.values()) == launched["int_matmul"],
          f"{name}: int_matmul launches by route {by_route} do not add up "
          f"to {launched['int_matmul']}")
    # multithreshold: each call on the route route_for gives its shape
    mt_by_route = {r: moved.get(f"multithreshold:{r}", 0) for r in MT_ROUTES}
    mt_expect = {r: 0 for r in MT_ROUTES}
    for m, c, n, dt in mt_calls:
        mt_expect[mt_route_for(m, c, n, getattr(torch, dt))] += 1
    check(mt_by_route == mt_expect
          and sum(mt_by_route.values()) == launched["multithreshold"],
          f"{name}: multithreshold launches by route {mt_by_route}, "
          f"route_for gives {mt_expect}, total {launched['multithreshold']}")
    if name == MT_SEARCH_CONFIG:
        check(mt_by_route[SEARCH] > 0,
              f"{name}: no multithreshold launch took the search route")
    ref = model.execute({inp: feeds[inp][:4]})
    for o in model.graph.outputs:
        check(out[o].shape[0] == BATCH and out[o].dtype == np.float32
              and bool(np.isfinite(out[o]).all()),
              f"{name}: float32 output {o} has a wrong shape or is not "
              f"finite")
        scale = max(float(np.abs(ref[o]).max()), 1.0)
        check(np.allclose(out[o][:4].astype(np.float64), ref[o], rtol=1e-5,
                          atol=1e-5 * scale),
              f"{name}: float32 output {o} differs from the interpreter")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fast(feeds)                      # returns numpy: ends synchronised
    ms = (time.perf_counter() - t0) / reps * 1e3
    distinct = sorted(set(calls), key=calls.index)
    mt_distinct = sorted(set(mt_calls), key=mt_calls.index)
    return dict(
        int_matmul_calls=[list(c) + [calls.count(c)] for c in distinct],
        int_matmul_launches_by_route=by_route,
        multithreshold_calls=[list(c) + [mt_calls.count(c)]
                              for c in mt_distinct],
        multithreshold_launches_by_route=mt_by_route,
        step_ms_by_op=profile_by_op(fast, feeds),
        name=name, flow_s=round(flow_s, 3), nodes=len(model.graph.nodes),
        kernel_calls=fast.kernel_calls,
        kernel_calls_float64=exact.kernel_calls,
        acc_bits={op.node_name: op.acc_bits for op in fast.plan
                  if op.acc_bits is not None},
        int_tensors_exact=len(exact.int_tensors), batch=BATCH,
        ms_per_batch=ms, samples_per_s=BATCH / ms * 1e3,
        launches=launched, expected_launches=expect)


def phase_main_path() -> dict:
    # every count to 0 just before the main path, read just after: the
    # launches of the kernel_grid comparisons do not count
    _build.reset_launch_counts()
    results = [run_config(*cfg) for cfg in CONFIGS]
    total = {k: _build.LAUNCH_COUNTS.get(k, 0)
             for k in ("int_matmul", "multithreshold", "quantize")}
    for k, v in total.items():
        check(v > 0, f"the main path never launched kernel {k}")
    by_route = {r: _build.LAUNCH_COUNTS.get(f"int_matmul:{r}", 0)
                for r in ROUTES}
    check(by_route[TENSOR_CORES] > 0,
          "the main path never launched the tensor-core int_matmul")
    mt_by_route = {r: _build.LAUNCH_COUNTS.get(f"multithreshold:{r}", 0)
                   for r in MT_ROUTES}
    for r, v in mt_by_route.items():
        check(v > 0, f"the main path never launched multithreshold route {r}")
    return dict(phase="main_path", configs=results, launches=total,
                int_matmul_launches_by_route=by_route,
                multithreshold_launches_by_route=mt_by_route)


def phase_no_fallback(results) -> dict:
    for r in results:
        check(r["launches"] == r["expected_launches"],
              f"{r['name']}: launched {r['launches']}, the plan needs "
              f"{r['expected_launches']}")
    return dict(phase="no_fallback", ok=True,
                per_config={r["name"]: r["launches"] for r in results})


# --------------------------------------------------------------------------
# phase: lm_prefill — the LM slice at full width
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention():
    """Route the model's prefill attention to the plain version on the
    card (what the kernel's logits are compared with)."""
    kernel = lm_attention.flash_attention
    lm_attention.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        lm_attention.flash_attention = kernel


def lm_model(cfg):
    return get_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(LM_SEED))


def lm_tokens(cfg, B, S):
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 1)
    return torch.randint(0, cfg.vocab, (B, S), generator=gen, device=DEV)


def lm_float32_checks(cfg) -> dict:
    """float32 at ``LM_F32``: kernel against plain attention, decode
    against prefill.  Tolerances relative to the logit scale: 1e-4 for the
    attention route (float32 sums in another order), 1e-3 for decode (the
    reference's own test allows rtol 1e-3: every product has other shapes
    and so other cuBLAS reductions)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = lm_model(cfg32)
    B, S = LM_F32
    toks = lm_tokens(cfg, B, S)
    V = cfg.vocab
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _build.LAUNCH_COUNTS["flash_attention"]
    got = model(toks)
    peak = torch.cuda.max_memory_allocated()
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == cfg.n_layers,
          f"float32 forward launched flash_attention {launches} times, "
          f"not once per layer ({cfg.n_layers})")
    check(got.shape == (B, S, cfg.vocab_padded)
          and bool(torch.isfinite(got[..., :V]).all()),
          "float32 logits: wrong shape or not finite")
    with plain_attention():
        want = model(toks)
    scale = float(want[..., :V].abs().max())
    err = float((got[..., :V] - want[..., :V]).abs().max())
    check(err <= 1e-4 * scale, f"float32 logits: kernel vs plain attention "
                               f"{err} > 1e-4 * {scale}")
    del want
    t0 = time.perf_counter()
    cache = model.init_cache(B, S)
    dec_err = 0.0
    for t in range(S):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
        dec_err = max(dec_err, float((lg[:, 0, :V] - got[:, t, :V])
                                     .abs().max()))
    decode_s = time.perf_counter() - t0
    check(dec_err <= 1e-3 * scale, f"decode_step vs forward {dec_err} > "
                                   f"1e-3 * {scale}")
    del model, cache, got, lg
    torch.cuda.empty_cache()
    return dict(dtype="float32", B=B, S=S, launches_per_forward=launches,
                logit_scale=scale, kernel_vs_plain_max_abs_err=err,
                decode_vs_forward_max_abs_err=dec_err,
                decode_all_steps_s=decode_s,
                memory_allocated_before=resident, max_memory_allocated=peak)


def lm_bf16_accuracy(model, cfg) -> dict:
    """bfloat16 at ``LM_BF16_CHECK``: the truth is a float32 forward of a
    float32 copy of the bf16 model's own weights.  The bf16 logits through
    the kernel must lie no further from it than 1.5x the bf16 logits
    through the plain attention (which rounds nothing inside attention):
    the kernel's rounding of P may add to the error of a bf16 forward, but
    must not dominate it."""
    B, S = LM_BF16_CHECK
    toks = lm_tokens(cfg, B, S)
    V = cfg.vocab
    ref = get_model(dataclasses.replace(cfg, dtype=torch.float32))
    ref.params = copy.deepcopy(model.params).to(torch.float32)
    truth = ref(toks)[..., :V]
    del ref
    before = _build.LAUNCH_COUNTS["flash_attention"]
    got = model(toks)[..., :V]
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == cfg.n_layers,
          f"bf16 B={B} S={S}: {launches} flash_attention launches, not "
          f"{cfg.n_layers}")
    with plain_attention():
        plain = model(toks)[..., :V]
    scale = float(truth.abs().max())

    def dist(x):
        d = x.float() - truth
        return float(d.abs().max()) / scale, \
            float(d.square().mean().sqrt()) / scale
    kernel_max, kernel_rms = dist(got)
    plain_max, plain_rms = dist(plain)
    check(bool(torch.isfinite(got).all()), "bf16 logits are not finite")
    check(kernel_max <= 1.5 * plain_max,
          f"bf16 logits through the kernel {kernel_max} of the logit scale "
          f"from the float32 truth, > 1.5 x the plain attention's "
          f"{plain_max}")
    del truth, got, plain
    torch.cuda.empty_cache()
    return dict(dtype="bfloat16", B=B, S=S, check="vs float32 forward of "
                "the same weights", logit_scale=scale,
                kernel_max_rel_err=kernel_max, plain_max_rel_err=plain_max,
                kernel_rms_rel_err=kernel_rms, plain_rms_rel_err=plain_rms,
                launches_per_forward=launches)


def lm_bf16_run(model, cfg, B, S, reps) -> dict:
    toks = lm_tokens(cfg, B, S)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _build.LAUNCH_COUNTS["flash_attention"]
    out = model(toks)                              # warm-up and checks
    peak = torch.cuda.max_memory_allocated()       # before the checks
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == cfg.n_layers,
          f"bf16 B={B} S={S}: {launches} flash_attention launches, not "
          f"{cfg.n_layers}")
    check(out.shape == (B, S, cfg.vocab_padded) and out.dtype ==
          torch.bfloat16 and bool(torch.isfinite(out[..., :cfg.vocab]).all())
          and bool((out[..., cfg.vocab:] == -1e30).all()),
          f"bf16 B={B} S={S}: logits wrong in shape, type or value")
    del out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        model(toks)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    return dict(dtype="bfloat16", B=B, S=S, ms_per_prefill=ms,
                tokens_per_s=B * S / ms * 1e3, reps=reps,
                launches_per_forward=launches,
                memory_allocated_before=resident, max_memory_allocated=peak)


def phase_lm_prefill() -> dict:
    # counts to 0 just before this path, read just after
    _build.reset_launch_counts()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab_padded) == (28, 1536, 12, 2, 8960, 152064),
          f"{LM_ARCH} is not at its published width")
    runs = [lm_float32_checks(cfg)]
    model = lm_model(cfg)
    runs.append(lm_bf16_accuracy(model, cfg))
    runs += [lm_bf16_run(model, cfg, B, S, reps) for B, S, reps in LM_BF16]
    del model
    torch.cuda.empty_cache()
    return dict(phase="lm_prefill", arch=LM_ARCH, seed=LM_SEED,
                params=cfg.param_count(), runs=runs,
                note="ms_per_prefill: host clock around forward calls "
                     "ended by a synchronize, after one warm call",
                launches=dict(flash_attention=_build.LAUNCH_COUNTS[
                    "flash_attention"]))


# --------------------------------------------------------------------------

KERNEL_META = {
    "int_matmul": dict(
        source="src/repro_torch/kernels/csrc/int_matmul.cu",
        replaces="src/repro/kernels/int_matmul.py:53"),
    "multithreshold": dict(
        source="src/repro_torch/kernels/csrc/multithreshold.cu",
        replaces="src/repro/kernels/multithreshold.py:60"),
    "quantize": dict(
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:26"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:66"),
}


def main() -> None:
    env = phase_env()
    emit(env)
    grid = phase_kernel_grid()
    emit(grid)
    main_path = phase_main_path()
    emit(main_path)
    emit(phase_no_fallback(main_path["configs"]))
    times = phase_kernel_times(main_path["configs"])
    emit(times)
    lm = phase_lm_prefill()           # last: it holds the card's memory
    emit(lm)
    launches = dict(main_path["launches"], **lm["launches"])
    kernels = []
    for name, meta in KERNEL_META.items():
        t = times[name][0]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=launches[name],
            max_abs_err=grid[name]["max_abs_err"], ms=t["ms"],
            wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"]))
    emit(dict(kernels=kernels))
    print(env["nvidia_smi"], flush=True)
    emit(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
