#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

Run from the repository root, no arguments, one card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (first
use), then runs fourteen phases and prints one JSON object per line:

  env          torch/CUDA versions, the card, the kernels' build seconds,
               the HGMMA (16-bit wgmma) instructions of flash_attention's
               forward and of the tensor-core backward's dK/dV and dQ
               kernels, both tilings (hd <= 128 and 128 < hd <= 256; each
               counted apart) and the IGMMA (int8 wgmma)
               instructions of int_matmul in the built library; ptxas's
               registers and spilled bytes of the backward's tensor-core
               kernels (0 spilled)
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
               float32 mode (fused epilogues) to 1e-5 against it and,
               over the whole batch, against the float64 plan; ms per
               batch, ms per op type from one ``profile()`` call, the
               int_matmul and multithreshold launches by route (each
               multithreshold call on the route ``route_for`` gives it;
               CNV-w2a8 must take the search) and the calls' shapes
  no_fallback  the launch counts of one inference equal what the plan says
               (so no route ran a plain version instead of its kernel)
  sira_flow    the affine domain and the dataflow DSE.  The seven
               main_path configurations again with affine-proven plans
               (``build_flow(..., domain="affine")``), under the same
               checks and launch counts, each kernel's launches counted
               from 0 over this phase; per-op accumulator bits beside the
               interval plans', and ms per batch of both plans timed in
               turns in one process (median of 5 rounds of 3 calls,
               every round kept).  HSW-w3a4 in both
               domains must raise the reference's LoweringError.  Then
               ``build_flow(..., steps=DATAFLOW_STEPS)`` in both domains on
               all five workloads (pynq-z1, 1000 FPS): every column
               ``scripts/check_bench.py`` marks exact equals
               ``benchmarks/baselines/BENCH_dataflow.json``, the banded
               ones lie in its bands; the LUT/DSP/BRAM estimates are
               printed beside the baseline's.  They are outputs of the
               analytical FPGA model, computed on the host, not
               measurements of the card
  qat_chain    accumulator-aware QAT (``repro_torch.qat``) at
               ``BENCH_qat.json``'s width, mlp16-32x32-4, w4/a4, 8-bit
               inputs, 80 steps, seed 0, budgets 0, 14, 12, 10: each trains
               on the card (every param and master on CUDA, every loss
               finite, params and masters inside the caps), its trained
               weights are exported, proven (SIRA bits <= budget on every
               constrained layer) and priced (pynq-z1; SIRA LUTs and DSPs
               must not grow over 14 -> 12 -> 10), and the built model runs
               a batch of 256 of its own inputs through the kernels (float64
               plan bit-exact, float32 within 1e-5, launches = plan); the
               same run on the CPU gives step 1's loss within 1e-5; six
               steps straight equal three + resume bit for bit on the card
               under deterministic algorithms (budget 12); ms per train
               step, seconds per budget, ms per compiled batch
  examples     the four example twins of ``examples_torch/`` in this
               process, each ``main([..., "--torch-device", "cuda"])`` at
               its defaults (the reference's sizes), ``sira_report`` also
               with ``--workload TFC-w2a2 --verify``; their printed lines
               go to stderr.  Per twin: its seconds, its returned numbers
               and its launches of each hand-written kernel, counted from
               0 before it.  quickstart's launches equal its plan's
               (``expected_launches`` of TFC's plan, which this phase
               builds again and holds to the twin's plan per kind); the
               others launch none of the four: serve_quantized's prefill
               chunks and decode steps both go through ``decode_paged``'s
               plain ``paged_attention`` (as in the reference), train_qat
               (its A2Q invariant checked) trains in plain PyTorch, and
               sira_report proves and prices in numpy
  kernel_times each kernel's device time, wrapper, plain version, bound
               and library call at the main paths' shapes; int_matmul on
               both routes at every call of CNV(64,32) and TFC(784), both
               routes' device time at the other configurations' calls,
               and the tensor-core kernel's ring depth swept; both
               multithreshold routes swept over N (the crossover), the
               multithreshold bound by bytes or by the compares of a
               search, M*C*ceil(log2(N+1)); flash attention's forward
               also with its log-sum-exp (the training forward), and the
               three backward kernels (D, dK/dV, dQ; bf16 dK/dV and dQ on
               both routes, tensor_cores and cuda_cores) at the same
               layer shape beside SDPA's backward, and at gemma2-2b's
               layer (1 x 8192, 8 heads over 4, hd 256) causal beside
               SDPA's backward and the backend it chose, then with
               gemma2's window 4096 and soft-cap 50 (the kernels alone)
  lm_prefill   the LM slice: qwen2-1.5b at full width (28 layers) with
               seeded random weights.  float32, B=1, S=1024, at 7 of
               the 28 layers (the one cut): logits with the
               flash-attention kernel against plain attention, and
               token-by-token ``decode_step`` against ``forward``; one
               kernel launch per layer.  bfloat16 (the published dtype):
               at B=1, S=2048 the logits through the kernel against a
               float32 forward of the same weights, no further from it
               than 1.5x the logits through the plain attention; ms per
               prefill, tokens/s and peak memory at B=4, S=2048 and B=1,
               S=32768, and the B=1, S=32768 prefill profiled once (its
               kernels, for the launch phase's count)
  lm_families  the MoE, Mamba2 and Zamba2 families at their published
               widths with seeded random weights: granite-moe-3b-a800m,
               qwen2-moe-a2.7b, mamba2-780m and zamba2-2.7b.  float32,
               B=1, S=512 (two SSD chunks), MoE at no-drop capacity:
               logits with the flash-attention kernel against plain
               attention (1e-4 of the logit scale), ``decode_step`` over
               all 512 positions against ``forward`` (1e-3), 8 / 4 / 0 /
               3 launches per forward (cut in depth: granite-moe at 8 of
               its 32 layers, qwen2-moe at 4 of 24, zamba2 at 18 of 54);
               MoE routing is logged, and a float32 near-tie
               that flips an expert between two runs must be one (margin
               < 1e-5) and ends the positions compared.  One MoE layer
               at capacity 1.25, B=1, S=2048, against the float64
               no-dispatch oracle (1e-4 of max|y|), with its share of
               dropped slots.  bfloat16: at B=1, S=2048 the logits
               against a float32 forward of the same weights (no further
               than 1.5x the plain attention's; mamba2 reports its
               distance), prefills timed at B=4, S=2048 and, for the
               long-context configs mamba2 and zamba2, B=1, S=32768
  serve        the serving engine (``repro_torch.serve``) on qwen2-1.5b
               at full width with seeded weights (after the earlier
               phases' models are freed).  The SIRA KV spec: the default
               (each layer's decision and reason) and the all-int8 one
               the int8 pool uses (``max_step`` raised), its pool half
               the bf16 pool.  float32: a 1024-token prompt through
               ``decode_paged`` in chunks of 256 (page 16) and 64 tokens
               one at a time against one ``Model.forward`` (1e-4 / 1e-3
               of the logit scale with the fp pool; the int8 pool's
               distance and top-1 agreement reported); six requests
               (four, then two after 3 steps; 4 slots) batched, with
               n-gram speculation, with a prefix cache over a shared
               256-token prefix and with half the worst-case pool, fp and
               int8 pools: every greedy stream equals the request served
               alone but for one near-tie flip (top-2 logits of the
               common prefix within 1e-5 of their scale), at least one
               preemption, fewer prefill chunks with the prefix cache.
               bfloat16, 8 slots, max_seq 4096: 16 requests (prompts
               128-2048, 16-64 new tokens; eight, then eight after 3
               steps) timed with the fp pool, the int8 pool, n-gram
               speculation and a prefix cache (a shared 1024-token
               prefix): the engine's metrics (tokens/s, TTFT p50/p99,
               occupancy, acceptance, prefix hit rate), ms per decode
               step at 8 active slots, ms per 256-token prefill chunk,
               peak memory, the int8 streams' agreement with the fp ones,
               and one decode step profiled (device ms by operator, idle
               share).  Then mamba2-780m, float32, static mode: four
               512-token prompts batched equal each served alone; a
               mixed-length batch and paged mode refused.  No kernel of
               this repo is on the serving path (paged attention is plain
               PyTorch, as in the reference); flash_attention runs in the
               ``Model.forward`` oracles
  lm_train     the LM's gradient and training (after the earlier phases'
               models are freed).  The backward kernels over an edge grid
               (float32, bf16, f16; hd 64 to 256; GQA groups 1, 2 and
               6; q_offset, window, soft-cap, ragged lengths, rows that
               see no key, 16 x 12 heads; the layer shape 1 x 4096): the
               forward's lse within 1e-5 of the plain one, D within
               1e-5 of rowsum(dO*out), dq, dk, dv on each route the
               case takes (bf16/f16 on tensor_cores, hd 256 on its own
               tiling, and, forced, on cuda_cores) within
               ``flash_attention.grad_tolerance`` of the plain backward
               on the same out and lse (tensor_cores: with its term for
               rounding P and dS), bit-equal over two calls, their
               distance to float64 autograd reported.  qwen2-1.5b at full
               width, 1 x 1024: in float32, ``Model.loss``'s gradient
               through the kernels within 1e-4 of each leaf's largest
               element through the plain attention, 28 launches of each
               kernel; in bf16 (tensor_cores), each leaf no further from
               the float32 gradient than 1.5x the plain attention's bf16
               gradient, plus 1e-3 of its norm.  Then
               ``launch.train`` at published widths (bf16 params, float32
               masters, 2 x 2048 tokens a step in 2 microbatches, 20
               steps) under deterministic algorithms: the reference's
               lines, one forward and three backward launches per layer
               and microbatch (dK/dV and dQ all on tensor_cores), the
               loss falling, ms per step, tokens/s,
               the model-FLOP share, peak memory, one more step profiled
               (device ms by kernel family, idle share); then the same
               run with a checkpoint every 10 steps killed at step 10,
               and the same command resumes there and ends in the
               straight run's state, bit for bit
  gemma2_train gemma2-2b (head dim 256, window 4096 on its even layers,
               soft-cap 50) on the tensor-core backward's hd-256 tiling.
               bf16 at its published widths cut to 2 of its 26 layers,
               1 x 6144 (the window cuts the last 2048 queries of layer
               0): each leaf of ``Model.loss``'s gradient through the
               kernels no further from the float32 gradient than 1.5x
               the plain attention's bf16 gradient, plus 1e-3 of its
               norm, 2 launches of dK/dV and dQ, all on tensor_cores.
               Then ``launch.train`` at published widths and depth (bf16
               params, float32 masters, 2 x 1536 tokens a step in 2
               microbatches, 12 steps): the reference's lines, 26 forward
               and 26 launches of each backward kernel per microbatch
               (dK/dV and dQ all on tensor_cores), the loss falling, ms
               per step, tokens/s, the model-FLOP share, peak memory, one
               more step profiled
  launch       tensor parallelism (``launch/``, last): two ranks, each its
               own process (``launch/ranks.py``), gloo, both on cuda:0
               (NCCL refuses two ranks on one card; gloo stages the
               tensors through the host).  qwen2-1.5b at full width,
               float32, seeded, split over the "model" axis (each rank 6
               query heads, 1 KV head, half the vocabulary): (a) the
               1 x 1024 prefill through each rank's ``Model.forward``
               within 1e-4 of the logit scale of the whole model, the
               same logits on both ranks, 28 flash_attention launches per
               rank and forward; (b) ``ServingEngine(ServingConfig(
               mesh=layout))``, 4 greedy requests (prompts 64-256, 32 new
               tokens), fp and int8 pools (``max_step`` 1.4), ``wo``,
               ``w_down`` x1024: both ranks' streams equal, and equal to
               the whole engine's but for one near-tie flip; each rank's
               pool half the whole pool's bytes; (c) ``compressed_psum``
               on 1M float32 elements within 2·Σ_r scale_r of the plain
               sum, bytes counted; (d) the dry run
               (``launch/dryrun.py``) at layout (1, 1) on the bf16 1 x
               32768 prefill (measured again through its CLI's
               ``--measure``)
               and on lm_train's step (its numbers, not run again): the
               count of each program on meta tensors
               (``roofline/op_cost.py``), whose launches of each
               hand-written kernel must equal the real call's (28
               flash_attention a forward; 56 of each backward kernel a
               step, on tensor_cores) and whose launches of every kind
               stand beside the profiler's kernels of one call; counted
               and predicted (``roofline/cost.py``) FLOPs and bytes,
               each with its roofline; predicted parameter and optimizer
               bytes equal to the real ones, predicted and measured peak
               memory, the counted roofline's compute and memory
               seconds, the bound's share of the measured time and the
               model-FLOP utilisation

then a ``{"kernels": [...]}`` line (the four TPU kernels' counterparts
and the backward kernels, dK/dV and dQ once per route and once more for
the tensor_cores route's hd-256 tiling at gemma2's layer; per kernel:
launches on its path and
on each phase's path,
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
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device is available", file=sys.stderr)
    sys.exit(2)

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config                  # noqa: E402
from repro_torch.core import LoweringError, build_flow       # noqa: E402
from repro_torch.core.workloads import (ALL_WORKLOADS,        # noqa: E402
                                        WORKLOADS, make_cnv, make_tfc)
from repro_torch.dataflow.report import (dataflow_flows,     # noqa: E402
                                         report_row)
from repro_torch.kernels import _build, ops as kops          # noqa: E402
from repro_torch.kernels.int_matmul import (                 # noqa: E402
    CUDA_CORES, ROUTES, TENSOR_CORES, int_matmul as int_matmul_kernel,
    k_major, route_for, work as int_matmul_work)
from repro_torch.kernels.multithreshold import (             # noqa: E402
    ROUTES as MT_ROUTES, SEARCH, route_for as mt_route_for,
    work as multithreshold_work)
from repro_torch.kernels.quantize import (                   # noqa: E402
    work as quantize_work)
from repro_torch.kernels.flash_attention import (            # noqa: E402
    BWD_KERNELS, CUDA_CORES, ROUTES as BWD_ROUTES, TENSOR_CORES, bwd_delta,
    bwd_dkdv, bwd_dq, bwd_work as flash_bwd_work, flash_attention_bwd,
    flash_attention_fwd, flash_attention_fwd_lse, grad_tolerance,
    route_for as bwd_route_for, tolerance as fa_tolerance,
    work as flash_work)
from repro_torch.kernels.ref import (                         # noqa: E402
    DEAD_LSE, flash_attention_bwd_magnitudes, flash_attention_bwd_ref,
    flash_attention_lse_ref, flash_attention_ref)
from repro_torch.configs import ShapeCell                   # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun           # noqa: E402
from repro_torch.launch import train as lm_trainer      # noqa: E402
from repro_torch.launch.mesh import make_layout              # noqa: E402
from repro_torch.launch.ranks import (Procs, run_ranks,      # noqa: E402
                                      start_oracle)
from repro_torch.models import attention as lm_attention     # noqa: E402
from repro_torch.models import moe as lm_moe                 # noqa: E402
from repro_torch.models.convert import ParamTree             # noqa: E402
from repro_torch.models import get_model                     # noqa: E402
from repro_torch.obs.trace import (Tracer, get_tracer,       # noqa: E402
                                   set_tracer)
from repro_torch.dataflow import compare_sira_vs_baseline  # noqa: E402
from repro_torch.qat import (QATConfig, check_budget_invariant,  # noqa: E402
                             proven_layer_bits, run_qat)
from repro_torch.serve import (KVCacheSpec, PagedKVCache,      # noqa: E402
                               Request, ServingConfig, ServingEngine,
                               derive_kv_spec)
from repro_torch.tree import (flatten, leaves, tree_map,     # noqa: E402
                              unflatten)
from examples_torch import (quickstart, serve_quantized,      # noqa: E402
                            sira_report, train_qat)

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
# gemma2-2b: its attention layer at S=8192 (its own window and soft-cap),
# the CUDA graph's calls when timing its backward (fewer: the cuda_cores
# route takes tens of ms a call there), and its training
GEMMA2_ARCH = "gemma2-2b"
GEMMA2_LAYER = dict(B=1, S=8192, H=8, KV=4, hd=256)
GEMMA2_MASK = dict(window=4096, logit_cap=50.0)
GEMMA2_BWD_LAUNCHES = 5
LM_F32 = (1, 1024)                        # (B, S) of the float32 checks
# their depth: 7 of the 28 layers (the token-by-token decode over 1024
# positions took 56 s at full depth and 24.7 s at 14 layers on hosts of
# one H100 80GB HBM3, 700 W; the whole script then took 677 s)
LM_F32_LAYERS = 7
LM_BF16_CHECK = (1, 2048)                 # (B, S) of the bfloat16 check
LM_BF16 = ((4, 2048, 3), (1, 32768, 2))   # (B, S, timed calls), bfloat16
LM_PROFILED = (1, 32768)    # the bf16 prefill also profiled once (launch)

# the lm_families slice: the MoE, Mamba2 and Zamba2 configs at their
# published widths, and the flash_attention launches of one forward
FAMILY_WIDTHS = {
    "granite-moe-3b-a800m": dict(n_layers=32, d_model=1536, n_heads=24,
                                 n_kv_heads=8, vocab=49155,
                                 moe=(40, 8, 0, 512), launches=32),
    "qwen2-moe-a2.7b": dict(n_layers=24, d_model=2048, n_heads=16,
                            n_kv_heads=16, vocab=151936,
                            moe=(60, 4, 4, 1408), launches=24),
    "mamba2-780m": dict(n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
                        vocab=50280, ssm=(128, 64, 2), launches=0),
    "zamba2-2.7b": dict(n_layers=54, d_model=2560, n_heads=32,
                        n_kv_heads=32, vocab=32000, ssm=(64, 64, 2),
                        attn_every=6, launches=9),
}
# the float32 checks' depth cuts: qwen2-moe at 4 of its 24 layers (a
# float32 copy of all 24 next to the bf16 weights would take ~86 GB);
# granite-moe at 8 of 32 and zamba2 at 18 of 54 (three shared-attention
# groups), whose token-by-token decode over 512 positions took 63 s and
# 37 s at full depth (one H100 80GB HBM3's host, 700 W)
FAMILY_F32_LAYERS = {"qwen2-moe-a2.7b": 4, "granite-moe-3b-a800m": 8,
                     "zamba2-2.7b": 18}
FAMILY_F32 = (1, 512)          # (B, S): two 256-token SSD chunks
FAMILY_ORACLE = (1, 2048)      # (B, S) of the MoE dispatch check
FAMILY_BF16 = (4, 2048, 3)     # (B, S, timed calls), bfloat16
FAMILY_LONG = (1, 32768, 2)    # the same, supports_long_context configs
# two router probabilities closer than this are a tie to float32 rounding
ROUTING_TIE = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


#: host seconds at the last phase line (the first: the script's start)
_LAST_EMIT = [time.perf_counter()]


def emit(obj: dict, timed: bool = True) -> None:
    """Print a line; a phase's line gets ``phase_s``, the host seconds
    since the previous phase line (the env line's: since the start)."""
    now = time.perf_counter()
    if timed:
        obj = dict(obj, phase_s=now - _LAST_EMIT[0])
        _LAST_EMIT[0] = now
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

#: the tensor-core backward's kernels (symbol names), each counted apart in
#: the HGMMA census and held to 0 spilled bytes in ptxas's build log: the
#: hd-256 tiling's first, since a name is matched as a substring
BWD_TC_KERNELS = ("flash_bwd_dkdv_tc256", "flash_bwd_dq_tc256",
                  "flash_bwd_dkdv_tc", "flash_bwd_dq_tc")


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
    check(all(sass["hgmma"][n] > 0 for n in BWD_TC_KERNELS),
          f"a tensor-core backward kernel has no HGMMA: {sass}")
    check(sass["igmma"]["int8_matmul_tc"] > 0,
          f"the int8 int_matmul kernel has no IGMMA: {sass}")
    ptxas = ptxas_report(pathlib.Path(lib._name).with_suffix(".log"),
                         BWD_TC_KERNELS)
    check(all(ptxas[n]["instances"] > 0 and ptxas[n]["spill_bytes"] == 0
              for n in BWD_TC_KERNELS),
          f"ptxas spills in the tensor-core backward (or no build log): "
          f"{ptxas}")
    return dict(phase="env", python=sys.version.split()[0],
                torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                kernel_build_s=round(_build.build_seconds, 2),
                kernel_load_s=round(load_s, 2), sass_hgmma=sass["hgmma"],
                sass_igmma=sass["igmma"], sass_gmma_opcodes=sass["opcodes"],
                ptxas=ptxas)


def ptxas_report(log: pathlib.Path, names) -> dict:
    """From the build log (``nvcc -Xptxas=-v``): for each kernel name,
    its instances (template instantiations), their most registers a
    thread and their most spilled bytes (stores + loads)."""
    out = {n: dict(instances=0, registers=0, spill_bytes=0) for n in names}
    if not log.exists():
        return out
    func = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = next((n for n in names if n in m.group(1)), None)
            if func:
                out[func]["instances"] += 1
            continue
        if func is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[func]["spill_bytes"] = max(out[func]["spill_bytes"],
                                           int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[func]["registers"] = max(out[func]["registers"],
                                         int(m.group(1)))
    return out


def sass_mma(library: str) -> dict:
    """Warpgroup MMA instructions in the built library, from ``cuobjdump
    --dump-sass``: HGMMA (16-bit wgmma) in the forward flash_attention
    kernel (``flash_kernel_tc``), in each tensor-core backward kernel
    (``BWD_TC_KERNELS``) and elsewhere, IGMMA (integer wgmma) in the int8
    int_matmul kernels (``int8_matmul_tc``) and elsewhere, and every
    distinct opcode that ends in GMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", library],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    hg_names = ("flash_kernel_tc",) + BWD_TC_KERNELS
    counts = dict(hgmma=dict({n: 0 for n in hg_names}, other=0),
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
                    counts["hgmma"][next((n for n in hg_names if n in func),
                                         "other")] += 1
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
# 256, a chunked prefill, the MoE and hybrid configs' layer shapes
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
    # the lm_families slice's attention shapes; hd 80 is a partial second
    # 64-column TMA chunk of the 128-wide tensor-core kernel
    ("zamba2 hd 80", 1, 300, 300, 32, 32, 80, {}),
    ("qwen2-moe", 1, 256, 256, 16, 16, 128, {}),
    ("granite-moe", 1, 256, 256, 24, 8, 64, {}),
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
    ops, nbytes = int_matmul_work(m, k, n, tdt, kw["out_dtype"],
                                  scale=fused, bias=fused)
    b_ms, by = bound(nbytes, ops, INT8_OPS_PER_S if tdt == torch.int8
                     else ALU_OPS_PER_S)
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
    """The kernel's work (``kernels/multithreshold.py work``: x and T read
    once, an int32 out written once, against the compares of a search,
    M*C*ceil(log2(N + 1))) at the card's peaks."""
    ops, nbytes = multithreshold_work(m, c, n, torch_dtype(dt), torch.int32)
    return bound(nbytes, ops, ALU_OPS_PER_S)


def torch_dtype(dt) -> torch.dtype:
    """The torch type of numpy type ``dt``."""
    return torch.from_numpy(np.zeros(0, dtype=dt)).dtype


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
    # divide, add, round, two clamps per element (kernels/quantize.py)
    ops, nbytes = quantize_work(m, c, x.dtype, torch.int32, 1)
    b_ms, by = bound(nbytes, ops, ALU_OPS_PER_S)
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
    # the training forward: the same kernel writing its log-sum-exp
    ms_lse = device_ms(lambda: flash_attention_fwd_lse(q, k, v),
                       GRAPH_LAUNCHES)
    plain = time_ms(lambda: flash_attention_ref(q, k, v), 3, warmup=1)
    lib = time_ms(library, 10)
    lib_diff = float((library().double() - kernel().double()).abs().max())
    # the causal mask keeps S(S+1)/2 query-key pairs: the work these
    # inputs need (kernels/flash_attention.py work)
    ops, nbytes = flash_work(q.shape, k.shape, dt, causal=True)
    b_ms, by = bound(nbytes, ops, ALU_OPS_PER_S if dt == torch.float32
                     else BF16_OPS_PER_S)
    return dict(shape=f"{str(dt)[6:]} B{B} S{S} H{H} KV{KV} hd{hd} causal",
                ms=ms, tflops=ops / ms / 1e9, ms_with_lse=ms_lse,
                wrapper_ms=wrapper,
                plain_ms=plain, bound_ms=b_ms, bound_by=by, library_ms=lib,
                library_tflops=ops / lib / 1e9,
                library="F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
                library_max_abs_diff=lib_diff,
                bound_peak="989 TFLOP/s bf16 tensor cores"
                if dt != torch.float32 else "67 TFLOP/s float32 (exact "
                "float32 has no tensor-core path)")


def sdpa_backend(by_kernel: dict) -> str:
    """The SDPA backend a profile's kernels belong to, by name."""
    names = " ".join(by_kernel).lower()
    for word, backend in (("cudnn", "CUDNN_ATTENTION"),
                          ("flash", "FLASH_ATTENTION"),
                          ("fmha", "EFFICIENT_ATTENTION")):
        if word in names:
            return backend
    return "MATH"


def time_flash_attention_bwd(dt, layer=FA_LAYER, mask=None,
                             launches=GRAPH_LAUNCHES) -> dict:
    """The backward kernels at ``layer`` (causal; ``mask``: a window and
    a soft-cap), dK/dV and dQ on each route the type and head take
    (``bwd_routes``), in the same call: each one's device time (replays
    of a CUDA graph of ``launches`` calls), one eager wrapper call, its
    bound and its plain version; the library call is SDPA's backward
    (all three gradients, with autograd, backward only; without a
    ``mask`` only, the function SDPA computes), with the backend it chose
    (from one profiled call).  The ``tensor_cores`` dK/dV launch is two
    kernels (the per-head partials, then their GQA sum): one profiled
    call splits its device time between them."""
    L = layer
    B, S, H, KV, hd = L["B"], L["S"], L["H"], L["KV"], L["hd"]
    gen = torch.Generator(device=DEV).manual_seed(2)
    q = torch.randn((B, S, H, hd), generator=gen, device=DEV).to(dt)
    k = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(dt)
    v = torch.randn((B, S, KV, hd), generator=gen, device=DEV).to(dt)
    dout = torch.randn((B, S, H, hd), generator=gen, device=DEV).to(dt)
    kw = {**dict(causal=True, window=0, q_offset=0, logit_cap=0.0),
          **(mask or {})}
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    delta = bwd_delta(out, dout)
    fns = {BWD_KERNELS[0]: lambda: bwd_delta(out, dout)}
    for route in bwd_routes(dt, hd):
        fns[f"{BWD_KERNELS[1]}:{route}"] = lambda r=route: bwd_dkdv(
            q, k, v, dout, lse, delta, route=r, **kw)
        fns[f"{BWD_KERNELS[2]}:{route}"] = lambda r=route: bwd_dq(
            q, k, v, dout, lse, delta, route=r, **kw)
    plain_bwd = time_ms(lambda: flash_attention_bwd_ref(
        q, k, v, out, lse, dout, **kw), 2, warmup=1)
    lib_ms = backend = None
    if not mask:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_grad = dout.transpose(1, 2)

        def library():      # timed here only; the port never calls it
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_grad,
                                       retain_graph=True)
        lib_ms = time_ms(library, 5)
        backend = sdpa_backend(device_profile(library)["by_kernel"])
    what = dict(causal=True, window=kw["window"], q_offset=0)
    fwd_ops, _ = flash_work(q.shape, k.shape, dt, **what)
    peak = ALU_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
    # kernels/flash_attention.py bwd_work: each input read once, each
    # output written once; dK/dV makes S, dP, dV and dK (2x the forward's
    # products), dQ makes S, dP and dQ (1.5x)
    work = {name: flash_bwd_work(name, q.shape, k.shape, dt, **what)
            for name in BWD_KERNELS}
    shape = (f"{str(dt)[6:]} B{B} S{S} H{H} KV{KV} hd{hd} causal"
             + "".join(f" {n} {kw[n]}" for n in ("window", "logit_cap")
                       if kw[n]))
    rows = {}
    for name, fn in fns.items():
        base = name.split(":")[0]
        ms = device_ms(fn, launches)
        ops, nbytes = work[base]
        b_ms, by = bound(nbytes, ops, peak)
        rows[name] = dict(
            shape=shape, ms=ms, wrapper_ms=time_ms(fn, 3),
            plain_ms=time_ms(lambda: (dout.float() * out.float()).sum(-1),
                             5) if base == BWD_KERNELS[0] else plain_bwd,
            bound_ms=b_ms, bound_by=by,
            library_ms=None if base == BWD_KERNELS[0] else lib_ms)
    by_route = {}
    for route in bwd_routes(dt, hd):
        by_route[route] = rows[BWD_KERNELS[0]]["ms"] + sum(
            rows[f"{n}:{route}"]["ms"] for n in BWD_KERNELS[1:])
    split = None
    if TENSOR_CORES in by_route:
        prof = device_profile(fns[f"{BWD_KERNELS[1]}:{TENSOR_CORES}"])
        split = {kname[:80]: ms for kname, (ms, _) in
                 prof["by_kernel"].items() if "flash_bwd_dkdv" in kname}
    # the whole backward at its least work, whatever its kernels: the
    # five products of the forward's size but S, made once (2.5x the
    # forward's); q, k, v, out, dO and the log-sum-exp read once, dq, dk
    # and dv written once.  The kernels' own bounds add up to more: dQ
    # makes S and dP again (3.5x in all)
    n, nk = q.numel(), k.numel()
    b_total, b_total_by = bound((4 * n + 4 * nk) * q.element_size()
                                + 4 * B * H * S, 2.5 * fwd_ops, peak)
    res = dict(dtype=str(dt)[6:], shape=shape, kernels=rows,
               backward_ms=by_route,
               backward_tflops={r: 2.5 * fwd_ops / t / 1e9
                                for r, t in by_route.items()},
               dkdv_tensor_cores_split_ms=split,
               backward_bound_ms=b_total, backward_bound_by=b_total_by,
               kernels_bound_ms={r: rows[BWD_KERNELS[0]]["bound_ms"] + sum(
                   rows[f"{n}:{r}"]["bound_ms"] for n in BWD_KERNELS[1:])
                   for r in by_route},
               library_backward_ms=lib_ms, library_backend=backend,
               library_tflops=2.5 * fwd_ops / lib_ms / 1e9 if lib_ms
               else None,
               plain_backward_ms=plain_bwd,
               library="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) backward (dq, dk, dv) by "
                       "torch.autograd.grad" if lib_ms else
                       "none: SDPA has no soft-cap",
               note="library_ms of dkdv and dq: SDPA's whole backward; "
                    "plain_ms of dkdv and dq: the whole plain backward; "
                    "backward_ms: D + dK/dV + dQ per route, beside "
                    "backward_bound_ms (the whole backward's least "
                    "work, 2.5x the forward's products) and "
                    "kernels_bound_ms (the sum of the kernels' bounds); "
                    "dkdv_tensor_cores_split_ms: one profiled call")
    del q, k, v, dout, out, lse, delta, fns
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
                         time_flash_attention(torch.float32)],
        flash_attention_bwd=[time_flash_attention_bwd(torch.bfloat16),
                             time_flash_attention_bwd(torch.float32)],
        # gemma2's layer: causal (where SDPA computes the same function),
        # then with its window and soft-cap, the kernels alone
        flash_attention_bwd_hd256=[
            time_flash_attention_bwd(torch.bfloat16, GEMMA2_LAYER,
                                     launches=GEMMA2_BWD_LAUNCHES),
            time_flash_attention_bwd(torch.bfloat16, GEMMA2_LAYER,
                                     GEMMA2_MASK,
                                     launches=GEMMA2_BWD_LAUNCHES)])


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


def run_config(name, factory, kwargs, domain="interval") -> dict:
    t0 = time.perf_counter()
    model = build_flow(factory(**kwargs), domain=domain).model
    flow_s = time.perf_counter() - t0
    check(model.domain == domain, f"{name}: the flow lost its domain")
    return check_plans(name, model, feeds_for(model, 4, seed=0),
                       feeds_for(model, BATCH, seed=1), flow_s)


def check_plans(name, model, small, feeds, flow_s) -> dict:
    """Both plans of a built model on the card: the float64 plan's
    integer tensors bit-exact against the numpy interpreter on ``small``,
    the float32 plan (fused epilogues) on the batch ``feeds`` against the
    interpreter and the float64 plan; launches per route, ms per batch."""
    domain = model.domain
    # float64, kernels on the card: the integer core is bit-exact against
    # the numpy interpreter, the outputs agree to 1e-12
    exact = model.compile(dtype=torch.float64)
    check(exact.device.type == "cuda", "compile() did not pick the card")
    check(len(exact.int_tensors) > 0, f"{name}: no integer tensors")
    exact = model.compile(dtype=torch.float64,
                          extra_outputs=exact.int_tensors)
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
    batch = len(next(iter(feeds.values())))
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
    # the whole batch against the float64 plan, bit-exact above
    ref_batch = exact(feeds)
    for o in model.graph.outputs:
        check(out[o].shape[0] == batch and out[o].dtype == np.float32
              and bool(np.isfinite(out[o]).all()),
              f"{name}: float32 output {o} has a wrong shape or is not "
              f"finite")
        scale = max(float(np.abs(ref[o]).max()), 1.0)
        check(np.allclose(out[o][:4].astype(np.float64), ref[o], rtol=1e-5,
                          atol=1e-5 * scale),
              f"{name}: float32 output {o} differs from the interpreter")
        check(np.allclose(out[o].astype(np.float64), ref_batch[o],
                          rtol=1e-5, atol=1e-5 * scale),
              f"{name}: float32 output {o} at batch {batch} differs from "
              f"the float64 plan")
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
        name=name, domain=domain, flow_s=round(flow_s, 3),
        nodes=len(model.graph.nodes),
        kernel_calls=fast.kernel_calls,
        kernel_calls_float64=exact.kernel_calls,
        acc_bits={op.node_name: op.acc_bits for op in fast.plan
                  if op.acc_bits is not None},
        int_tensors_exact=len(exact.int_tensors), batch=batch,
        ms_per_batch=ms, samples_per_s=batch / ms * 1e3,
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
# phase: sira_flow — affine-proven plans on the card, the dataflow report
# --------------------------------------------------------------------------

PAIRED_ROUNDS = 5        # rounds of sira_flow's interval/affine timing
DATAFLOW_DEVICE = "pynq-z1"
DATAFLOW_FPS = 1000.0
BENCH_DATAFLOW = "BENCH_dataflow.json"
# the columns printed beside the baseline's
DATAFLOW_SHOWN = ("sira_luts", "baseline_luts", "lut_reduction",
                  "sira_dsps", "baseline_dsps", "dsp_reduction",
                  "sira_brams", "baseline_brams", "acc_bits_sum_interval",
                  "acc_bits_sum_affine", "affine_luts_saved")


def load_check_bench():
    """The repository's benchmark gate, ``scripts/check_bench.py``: its
    rules say which columns are exact and how wide the bands are."""
    spec = importlib.util.spec_from_file_location(
        "check_bench", ROOT / "scripts" / "check_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dataflow_report() -> list:
    gate = load_check_bench()
    metrics = gate.RULES[BENCH_DATAFLOW]["metrics"]
    baseline = json.loads((ROOT / "benchmarks" / "baselines" /
                           BENCH_DATAFLOW).read_text())
    check((baseline["device"], baseline["target_fps"])
          == (DATAFLOW_DEVICE, DATAFLOW_FPS),
          "the dataflow baseline was made at another design point")
    base_rows = {r["workload"]: r for r in baseline["results"]}
    rows = []
    for name, factory in ALL_WORKLOADS.items():
        flows = dataflow_flows(factory(), device=DATAFLOW_DEVICE,
                               target_fps=DATAFLOW_FPS)
        for domain, res in flows.items():
            check([s.name for s in res.steps][-2:]
                  == ["DataflowEstimate", "DataflowFold"]
                  and all(res.model.metadata.get(k) is not None for k in (
                      "dataflow_report", "dataflow_estimate", "folding")),
                  f"{name} ({domain}): the dataflow steps left no result")
        row = report_row(name, flows)
        base = base_rows[name]
        compared = [gate._compare_metric(
            name, m, kind, floor, base.get(m), row.get(m), timing_tol=1.5,
            ratio_tol=0.5, estimate_tol=0.05)
            for m, (kind, floor) in metrics.items() if kind != "timing"]
        failed = [(c.metric, c.base, c.fresh, c.note) for c in compared
                  if c.failed]
        check(not failed, f"{name}: dataflow columns off the baseline: "
              f"{failed}")
        exact = [m for m, (kind, _) in metrics.items() if kind == "exact"]
        check(all(row[m] == base[m] for m in exact),
              f"{name}: an exact dataflow column differs")
        rows.append(dict(
            workload=name, exact_columns_equal=len(exact),
            banded_columns_within=len(compared) - len(exact),
            port={m: row[m] for m in DATAFLOW_SHOWN},
            baseline={m: base[m] for m in DATAFLOW_SHOWN},
            flows_s=round(sum(s.seconds for r in flows.values()
                              for s in r.steps), 3)))
    return rows


def paired_ms(name, factory, kwargs) -> dict:
    """ms per batch of the interval and the affine float32 plan of one
    configuration in one process: host clock, three calls per turn, the
    plans in turns (interval, affine, affine, interval, ...); median and
    every round."""
    models = {d: build_flow(factory(**kwargs), domain=d).model
              for d in ("interval", "affine")}
    plans = {d: m.compile() for d, m in models.items()}
    feeds = feeds_for(models["interval"], BATCH, seed=1)
    for plan in plans.values():
        plan(feeds)                       # warm
    rounds: dict = {d: [] for d in plans}
    for r in range(PAIRED_ROUNDS):
        for d in (("interval", "affine") if r % 2 == 0
                  else ("affine", "interval")):
            t0 = time.perf_counter()
            for _ in range(3):
                plans[d](feeds)           # returns numpy: ends synchronised
            rounds[d].append((time.perf_counter() - t0) / 3 * 1e3)
    return {d: dict(median=statistics.median(v), rounds=v)
            for d, v in rounds.items()}


def phase_sira_flow(interval_results) -> dict:
    """The main path's configurations with affine-proven plans; every
    count to 0 just before, read just after."""
    _build.reset_launch_counts()
    results = [run_config(*cfg, domain="affine") for cfg in CONFIGS]
    total = {k: _build.LAUNCH_COUNTS.get(k, 0)
             for k in ("int_matmul", "multithreshold", "quantize")}
    for k, v in total.items():
        check(v > 0, f"the affine plans never launched kernel {k}")
    for r in results:
        check(r["launches"] == r["expected_launches"],
              f"{r['name']} (affine): launched {r['launches']}, the plan "
              f"needs {r['expected_launches']}")
    interval = {r["name"]: r for r in interval_results}
    per_config = []
    for cfg, r in zip(CONFIGS, results):
        i = interval[r["name"]]
        ms = paired_ms(*cfg)
        check(bool(r["acc_bits"])
              and len(r["acc_bits"]) == len(i["acc_bits"])
              and all(a <= b for a, b in zip(r["acc_bits"].values(),
                                             i["acc_bits"].values())),
              f"{r['name']}: an affine accumulator is wider than the "
              f"interval one")
        per_config.append(dict(
            name=r["name"],
            acc_bits_interval=list(i["acc_bits"].values()),
            acc_bits_affine=list(r["acc_bits"].values()),
            ms_per_batch_interval=ms["interval"]["median"],
            ms_per_batch_affine=ms["affine"]["median"],
            ms_rounds_interval=ms["interval"]["rounds"],
            ms_rounds_affine=ms["affine"]["rounds"],
            int_tensors_exact=r["int_tensors_exact"],
            launches=r["launches"],
            int_matmul_launches_by_route=r["int_matmul_launches_by_route"],
            multithreshold_launches_by_route=r[
                "multithreshold_launches_by_route"]))
    # HSW-w3a4 is held to analysis parity: neither plan lowers
    for domain in ("interval", "affine"):
        model = build_flow(ALL_WORKLOADS["HSW-w3a4"](), domain=domain).model
        try:
            model.compile()
        except LoweringError as e:
            check("HardSwish" in str(e), f"HSW-w3a4: {e}")
        else:
            check(False, f"HSW-w3a4 ({domain}) lowered; the reference "
                  f"raises LoweringError")
    return dict(phase="sira_flow", batch=BATCH, configs=per_config,
                launches=total,
                dataflow_note="LUT/DSP/BRAM below are outputs of the "
                              "analytical FPGA model (pynq-z1, 1000 FPS), "
                              "computed on the host: not chip measurements",
                dataflow=dataflow_report())


# --------------------------------------------------------------------------
# phase: qat_chain — accumulator-aware QAT on the card, SIRA and the DSE on
# the trained weights, the trained model through the kernels
# --------------------------------------------------------------------------

BENCH_QAT = "BENCH_qat.json"
QAT_BUDGETS = (0, 14, 12, 10)     # loosest first, as the benchmark sweeps
QAT_RESUME_BUDGET = 12
QAT_TIMED_STEPS = (10, 80)        # ms per train step: median over these
QAT_STEP1_RTOL = 1e-5             # step-1 loss, CPU against the card


def qat_bench() -> dict:
    """``BENCH_qat.json``: the QAT model's published width and run (read
    as data; its rows are printed beside the card's)."""
    bench = json.loads((ROOT / "benchmarks" / "baselines" /
                        BENCH_QAT).read_text())
    m = re.fullmatch(r"mlp(\d+)-([\dx]+)-(\d+)", bench["arch"])
    check(m is not None, f"unknown QAT arch {bench['arch']!r}")
    check([r["budget"] for r in bench["results"]] == list(QAT_BUDGETS),
          "BENCH_qat.json sweeps other budgets")
    bench["config"] = dict(
        in_dim=int(m[1]), hidden=tuple(int(h) for h in m[2].split("x")),
        classes=int(m[3]), weight_bits=bench["weight_bits"],
        act_bits=bench["act_bits"], zero_center=bench["zero_center"],
        steps=bench["steps"], seed=bench["seed"])
    return bench


def within_caps(model, params) -> bool:
    """Params inside each constrained layer's caps (tests/test_qat.py)."""
    for i, (layer, budget) in enumerate(zip(params["layers"],
                                            model.budgets())):
        if budget is None:
            continue
        v = layer["W"].double().cpu().numpy() / model.w_scales[i]
        cap_pos, cap_neg = budget.caps()
        if cap_neg >= 0:
            ok = bool((np.maximum(v, 0).sum(0) <= cap_pos + 1e-3).all()
                      and (np.maximum(-v, 0).sum(0) <= cap_neg + 1e-3).all())
        else:
            ok = bool((np.abs(v).sum(0) <= cap_pos + 1e-3).all())
        if not ok:
            return False
    return True


def qat_budget(bench, budget: int) -> dict:
    """Train at ``budget`` on the card, prove and price the trained
    weights, run the exported model through the kernels, and train the
    same run on the CPU for step 1's loss."""
    cfg = QATConfig(budget=budget, **bench["config"])
    t0 = time.perf_counter()
    res = run_qat(cfg, device=DEV)
    train_s = time.perf_counter() - t0
    state = res.state
    check(all(t.is_cuda for t in leaves((state.params, state.opt))),
          f"budget {budget}: a param or optimizer tensor left the card")
    check(len(res.losses) == cfg.steps
          and bool(np.isfinite(res.losses).all()),
          f"budget {budget}: a loss is not finite")
    check(within_caps(res.model, state.params)
          and within_caps(res.model, state.opt.master),
          f"budget {budget}: params or masters outside the caps")

    t1 = time.perf_counter()
    result, bits = proven_layer_bits(res.model, state.params,
                                     name=f"qat-b{budget}")
    flow_s = time.perf_counter() - t1
    if budget:       # raises unless proven <= budget on every layer
        check_budget_invariant(res.model, state.params, bits)
    comp = compare_sira_vs_baseline(result.model, device=bench["device"])

    x = res.model.synth_batch(cfg.steps, BATCH)["tokens"].astype(np.float64)
    plans = check_plans(f"qat-b{budget}", result.model, {"X": x},
                        {"X": x}, flow_s)
    check(plans["launches"] == plans["expected_launches"],
          f"budget {budget}: launched {plans['launches']}, the plan needs "
          f"{plans['expected_launches']}")

    cpu = run_qat(cfg, device="cpu")
    step1 = abs(res.losses[0] - cpu.losses[0]) / abs(cpu.losses[0])
    check(step1 <= QAT_STEP1_RTOL,
          f"budget {budget}: step-1 loss on the card {res.losses[0]} vs "
          f"the CPU {cpu.losses[0]}")
    lo, hi = QAT_TIMED_STEPS
    return dict(
        budget=budget, proven_bits=bits, task_loss=res.final_loss,
        sira_luts=comp.sira.luts, sira_dsps=comp.sira.dsps,
        baseline_luts=comp.baseline.luts, baseline_dsps=comp.baseline.dsps,
        train_s=train_s, seconds=time.perf_counter() - t0,
        ms_per_train_step=statistics.median(
            res.step_seconds[lo - 1:hi]) * 1e3,
        step1_loss_card=res.losses[0], step1_loss_cpu=cpu.losses[0],
        step1_rel_diff=step1,
        max_abs_loss_diff_steps_2_on=max(
            abs(a - b) for a, b in zip(res.losses[1:], cpu.losses[1:])),
        ms_per_compiled_batch=plans["ms_per_batch"],
        int_tensors_exact=plans["int_tensors_exact"],
        int_matmul_calls=plans["int_matmul_calls"],
        # the route route_for gives each call (M, K, N, operand type)
        int_matmul_routes=[route_for(c[0], c[1], c[2], getattr(torch, c[3]))
                           for c in plans["int_matmul_calls"]],
        int_matmul_launches_by_route=plans["int_matmul_launches_by_route"],
        multithreshold_calls=plans["multithreshold_calls"],
        multithreshold_launches_by_route=plans[
            "multithreshold_launches_by_route"],
        launches=plans["launches"])


def qat_resume(bench) -> dict:
    """Six steps straight equal a kill after the step-3 checkpoint and a
    resume in fresh objects, on the card, under deterministic algorithms
    (a nondeterministic op raises instead of passing by luck)."""
    cfg = dict(bench["config"], steps=6)
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    prev_mode = torch.are_deterministic_algorithms_enabled()
    # cuBLAS refuses deterministic mode without a fixed workspace
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a, b = pathlib.Path(tmp, "a"), pathlib.Path(tmp, "b")
            straight = run_qat(QATConfig(budget=QAT_RESUME_BUDGET,
                                         ckpt_dir=str(a), ckpt_every=3,
                                         **cfg), device=DEV)
            b.mkdir()
            shutil.copy(a / "ckpt_00000003.npz", b)
            resumed = run_qat(QATConfig(budget=QAT_RESUME_BUDGET,
                                        ckpt_dir=str(b), ckpt_every=3,
                                        **cfg), device=DEV)
    finally:
        torch.use_deterministic_algorithms(prev_mode)
        if prev_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
    pairs = list(zip(leaves((straight.state.params, straight.state.opt)),
                     leaves((resumed.state.params, resumed.state.opt))))
    check(resumed.resumed_from == 3
          and resumed.losses[:3] == straight.losses[:3]
          and all(x.is_cuda == y.is_cuda and torch.equal(x, y)
                  for x, y in pairs),
          "QAT resume on the card is not bit-exact")
    return dict(budget=QAT_RESUME_BUDGET, steps=6, resumed_from=3,
                tensors_equal=len(pairs), deterministic_algorithms=True)


def phase_qat_chain(card: str) -> dict:
    """Every count to 0 just before this path, read just after."""
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls must run at full precision: TF32 would move "
          "the fake-quant rounding boundaries")
    bench = qat_bench()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [qat_budget(bench, b) for b in QAT_BUDGETS]
    for prev, row in zip(rows[1:], rows[2:]):       # 14 -> 12 -> 10
        check(row["sira_luts"] <= prev["sira_luts"] + 1e-9
              and row["sira_dsps"] <= prev["sira_dsps"],
              f"SIRA resources grew from budget {prev['budget']} to "
              f"{row['budget']}")
    resume = qat_resume(bench)
    total = {k: _build.LAUNCH_COUNTS.get(k, 0)
             for k in ("int_matmul", "multithreshold", "quantize")}
    for k, v in total.items():
        check(v > 0, f"the QAT chain never launched kernel {k}")
    shown = ("proven_bits", "task_loss", "sira_luts", "sira_dsps",
             "baseline_luts", "baseline_dsps")
    return dict(
        phase="qat_chain", card=card, arch=bench["arch"],
        config=dict(bench["config"], batch=QATConfig.batch,
                    input_bits=QATConfig.input_bits),
        budgets=rows,
        baseline={r["budget"]: {k: r[k] for k in shown}
                  for r in bench["results"]},
        luts_dsps_monotone_14_12_10=True,
        luts_le_unconstrained=rows[1]["sira_luts"] <= rows[0]["sira_luts"],
        resume=resume, seconds=time.perf_counter() - t0,
        note="ms_per_train_step: host clock, median over steps "
             f"{QAT_TIMED_STEPS[0]}-{QAT_TIMED_STEPS[1]}, each step ending "
             "when its loss reaches the host; ms_per_compiled_batch: the "
             f"float32 plan, host clock, batch {BATCH}; LUT/DSP: the "
             "analytical FPGA model (pynq-z1), not chip measurements; the "
             "init differs from the reference's (torch.Generator), so only "
             "the invariants are checked against BENCH_qat.json's rows",
        launches=total)


# --------------------------------------------------------------------------
# phase: examples — the example twins, in-process on the card
# --------------------------------------------------------------------------

#: (twin, its arguments besides --torch-device), in the order they run:
#: quickstart first, train_qat last (``phase_examples`` reads them so)
EXAMPLE_RUNS = [
    (quickstart, []),
    (sira_report, []),
    (sira_report, ["--workload", "TFC-w2a2", "--verify"]),
    (serve_quantized, []),
    (train_qat, []),
]
#: a twin's returned numbers left off the phase line: token streams and
#: every step's loss (their ends are on it)
EXAMPLE_BULK = ("streams_fp", "streams_int8", "losses")


def run_example(module, argv) -> dict:
    """One twin's ``main`` on the card, every count from 0 just before it;
    its seconds, numbers and the launches it made."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = module.main(argv + ["--torch-device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(
        example=module.__name__.rsplit(".", 1)[-1], argv=argv,
        seconds=seconds,
        launches={k: _build.LAUNCH_COUNTS.get(k, 0) for k in KERNEL_META},
        # every count the run moved: routes and the backward kernels too
        launches_all={k: v for k, v in _build.LAUNCH_COUNTS.items() if v},
        numbers={k: v for k, v in out.items() if k not in EXAMPLE_BULK})


def phase_examples(card: str) -> dict:
    runs = [run_example(m, argv) for m, argv in EXAMPLE_RUNS]
    qs = runs[0]
    model = build_flow(make_tfc(), verify="equivalence").model
    plan = model.compile()
    check(plan.kernel_calls == qs["numbers"]["kernel_calls"],
          f"quickstart planned {qs['numbers']['kernel_calls']}, TFC's plan "
          f"is {plan.kernel_calls}")
    want = expected_launches(model, plan)
    got = {k: qs["launches"][k] for k in want}
    check(got == want and qs["launches"]["flash_attention"] == 0,
          f"quickstart launched {qs['launches']}, its plan needs {want}")

    qat = runs[-1]["numbers"]
    check(qat["invariant_checked"]
          and all(b <= budget for b, budget in zip(qat["proven_bits"],
                                                   qat["budgets"])),
          f"train_qat: proven bits {qat['proven_bits']} over budgets "
          f"{qat['budgets']}")
    for r in runs[1:]:
        check(not r["launches_all"],
              f"{r['example']} {r['argv']} launched {r['launches_all']}")
    total = {k: sum(r["launches"][k] for r in runs) for k in KERNEL_META}
    return dict(
        phase="examples", card=card, runs=runs,
        quickstart_expected_launches=want,
        note="each twin at its defaults (the reference's sizes) on the "
             "card, seconds on the host clock (first calls included); only "
             "quickstart's compiled step launches hand-written kernels: "
             "serve_quantized prefills and decodes through decode_paged's "
             "plain paged_attention, train_qat trains in plain PyTorch, "
             "sira_report proves and prices in numpy",
        launches=total)


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


@contextlib.contextmanager
def routing_log():
    """Record every MoE layer's routing, in call order: its expert ids
    (sorted per token) and the top-(k+1) router probabilities."""
    log, route = [], lm_moe.route

    def recorded(params, x, **kw):
        r = route(params, x, **kw)
        k = r.gate_idx.shape[-1]
        log.append((r.gate_idx.sort(dim=-1).values,
                    r.probs.topk(k + 1, dim=-1).values))
        return r
    lm_moe.route = recorded
    try:
        yield log
    finally:
        lm_moe.route = route


def routing_by_layer(log, n_layers):
    """A forward's log (one (B, S, .) entry per layer) or a decode's (one
    (B, 1, .) entry per step and layer) → ids, top (n_layers, B, S, .)."""
    steps = len(log) // n_layers
    return tuple(torch.stack([torch.cat([log[t * n_layers + i][j]
                                         for t in range(steps)], dim=1)
                              for i in range(n_layers)]) for j in (0, 1))


def first_routing_flip(ref_log, log, n_layers, S) -> tuple:
    """(first position whose routing differs between the two runs in any
    layer, or S; tokens and layers that differ).  Two float32 runs that
    sum in other orders may flip the k-th and (k+1)-th expert of a token
    whose two probabilities tie to rounding; every flip must be such a
    near-tie (margin < ROUTING_TIE), and positions from the first flip on
    are then not compared (a flip changes that token's expert output and,
    through attention, every later position; never an earlier one)."""
    if not ref_log:
        return S, 0
    ids_a, top_a = routing_by_layer(ref_log, n_layers)
    ids_b, _ = routing_by_layer(log, n_layers)
    diff = (ids_a != ids_b).any(dim=-1)               # (layers, B, S)
    if not bool(diff.any()):
        return S, 0
    margin = float((top_a[..., -2] - top_a[..., -1])[diff].max())
    check(margin < ROUTING_TIE, f"routing differs where the k-th and "
                                f"(k+1)-th probabilities are {margin} "
                                f"apart: not a near-tie")
    return int(diff.any(dim=0).any(dim=0).nonzero()[0]), int(diff.sum())


def lm_float32_checks(model, B, S) -> dict:
    """float32 at B x S: kernel against plain attention, decode against
    prefill.  Tolerances relative to the logit scale: 1e-4 for the
    attention route (float32 sums in another order), 1e-3 for decode (the
    reference's own test allows rtol 1e-3: every product has other shapes
    and so other cuBLAS reductions).  MoE layers log their routing, and
    a near-tie that flips between two runs ends the positions compared
    (``first_routing_flip``)."""
    cfg = model.cfg
    toks = lm_tokens(cfg, B, S)
    V = cfg.vocab
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _build.LAUNCH_COUNTS["flash_attention"]
    with routing_log() as log_k:
        got = model(toks)
    peak = torch.cuda.max_memory_allocated()
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == attn_launches(cfg),
          f"float32 forward launched flash_attention {launches} times, "
          f"not {attn_launches(cfg)}")
    check(got.shape == (B, S, cfg.vocab_padded)
          and bool(torch.isfinite(got[..., :V]).all()),
          "float32 logits: wrong shape or not finite")
    out = dict(dtype="float32", B=B, S=S, launches_per_forward=launches)
    scale = float(got[..., :V].abs().max())
    if launches:
        with plain_attention(), routing_log() as log_p:
            want = model(toks)
        n, flips = first_routing_flip(log_k, log_p, cfg.n_layers, S)
        scale = float(want[..., :V].abs().max())
        err = float((got[:, :n, :V] - want[:, :n, :V]).abs().max())
        check(err <= 1e-4 * scale, f"float32 logits: kernel vs plain "
                                   f"attention {err} > 1e-4 * {scale}")
        out.update(kernel_vs_plain_max_abs_err=err,
                   kernel_vs_plain_positions=n,
                   kernel_vs_plain_routing_flips=flips)
        del want
    t0 = time.perf_counter()
    cache = model.init_cache(B, S)
    err = torch.zeros((B, S), device=DEV)
    with routing_log() as log_d:
        for t in range(S):
            lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
            err[:, t] = (lg[:, 0, :V] - got[:, t, :V]).abs().amax(dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    n, flips = first_routing_flip(log_k, log_d, cfg.n_layers, S)
    dec_err = float(err[:, :n].max())
    check(dec_err <= 1e-3 * scale, f"decode_step vs forward {dec_err} > "
                                   f"1e-3 * {scale}")
    del cache, got, lg
    torch.cuda.empty_cache()
    out.update(logit_scale=scale, decode_vs_forward_max_abs_err=dec_err,
               decode_vs_forward_positions=n,
               decode_vs_forward_routing_flips=flips,
               decode_all_steps_s=decode_s,
               memory_allocated_before=resident, max_memory_allocated=peak)
    return out


def attn_launches(cfg) -> int:
    """flash_attention launches per forward: one per attention layer; the
    hybrid applies its one shared block after every ``attn_every``
    Mamba2 layers, and Mamba2 has none."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def lm_bf16_accuracy(model, cfg, truth_params=None) -> dict:
    """bfloat16 at ``LM_BF16_CHECK``: the truth is a float32 forward of a
    float32 copy of the bf16 model's own weights (``truth_params`` when the
    caller holds one).  The bf16 logits through the kernel must lie no
    further from it than 1.5x the bf16 logits through the plain attention
    (which rounds nothing inside attention): the kernel's rounding of P
    may add to the error of a bf16 forward, but must not dominate it.  A
    model without attention (Mamba2) reports its distance, finite."""
    B, S = LM_BF16_CHECK
    toks = lm_tokens(cfg, B, S)
    V = cfg.vocab
    ref = get_model(dataclasses.replace(cfg, dtype=torch.float32))
    ref.params = truth_params if truth_params is not None else \
        copy.deepcopy(model.params).to(torch.float32)
    truth = ref(toks)[..., :V]
    del ref
    before = _build.LAUNCH_COUNTS["flash_attention"]
    got = model(toks)[..., :V]
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == attn_launches(cfg),
          f"bf16 B={B} S={S}: {launches} flash_attention launches, not "
          f"{attn_launches(cfg)}")
    scale = float(truth.abs().max())

    def dist(x):
        d = x.float() - truth
        return float(d.abs().max()) / scale, \
            float(d.square().mean().sqrt()) / scale
    kernel_max, kernel_rms = dist(got)
    check(bool(torch.isfinite(got).all()), "bf16 logits are not finite")
    out = dict(dtype="bfloat16", B=B, S=S, check="vs float32 forward of "
               "the same weights", logit_scale=scale,
               kernel_max_rel_err=kernel_max, kernel_rms_rel_err=kernel_rms,
               launches_per_forward=launches)
    if launches:
        with plain_attention():
            plain = model(toks)[..., :V]
        plain_max, plain_rms = dist(plain)
        check(kernel_max <= 1.5 * plain_max,
              f"bf16 logits through the kernel {kernel_max} of the logit "
              f"scale from the float32 truth, > 1.5 x the plain "
              f"attention's {plain_max}")
        out.update(plain_max_rel_err=plain_max, plain_rms_rel_err=plain_rms)
        del plain
    del truth, got
    torch.cuda.empty_cache()
    return out


def lm_bf16_run(model, cfg, B, S, reps) -> dict:
    toks = lm_tokens(cfg, B, S)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = _build.LAUNCH_COUNTS["flash_attention"]
    out = model(toks)                              # warm-up and checks
    peak = torch.cuda.max_memory_allocated()       # before the checks
    launches = _build.LAUNCH_COUNTS["flash_attention"] - before
    check(launches == attn_launches(cfg),
          f"bf16 B={B} S={S}: {launches} flash_attention launches, not "
          f"{attn_launches(cfg)}")
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
    out = dict(dtype="bfloat16", B=B, S=S, ms_per_prefill=ms,
               tokens_per_s=B * S / ms * 1e3, reps=reps,
               launches_per_forward=launches,
               memory_allocated_before=resident, max_memory_allocated=peak)
    if cfg.name == LM_ARCH and (B, S) == LM_PROFILED:
        # the kernels the profiler sees in one call, which the launch
        # phase sets beside the dry run's count of the same program
        prof = device_profile(lambda: model(toks))
        out["profile"] = dict(kernels=prof["kernels"],
                              wall_ms=prof["wall_ms"],
                              device_busy_ms=prof["device_busy_ms"],
                              idle_share=prof["idle_share"])
    return out


def float32_model(arch: str):
    """The float32 model of ``arch``'s checks: qwen2-1.5b drawn in float32
    at ``LM_F32_LAYERS`` of its layers (``lm_prefill``), a family a
    float32 copy of its seeded bf16 weights, cut to ``FAMILY_F32_LAYERS``
    (drawing the cut model draws the same first layers: the init draws
    the embedding and head, then the layers in order), MoE at no-drop
    capacity (``lm_families``)."""
    cfg = get_config(arch)
    if arch == LM_ARCH:
        return lm_model(dataclasses.replace(cfg, dtype=torch.float32,
                                            n_layers=LM_F32_LAYERS))
    cfg_cut = dataclasses.replace(
        cfg, n_layers=FAMILY_F32_LAYERS.get(arch, cfg.n_layers))
    p32 = lm_model(cfg_cut).params.to(torch.float32)
    cfg32 = dataclasses.replace(cfg_cut, dtype=torch.float32)
    if cfg.family == "moe":
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    m32 = get_model(cfg32)
    m32.params = p32
    return m32


#: the jobs of the float32 checks, longest first
FLOAT32_JOBS = [f"float32:{a}" for a in (
    LM_ARCH, "granite-moe-3b-a800m", "zamba2-2.7b", "mamba2-780m",
    "qwen2-moe-a2.7b")]
#: processes such checks run in at once (their models and the parent's
#: fit the card's 80 GB together)
MAX_WORKERS = 3


def run_worker(job: str, out: str) -> None:
    """``chip_smoke.py --worker JOB OUT``: one check job in a process of
    its own, its result and the kernel launches it counted (from 0 in
    this process) in OUT.  Jobs: ``float32:ARCH`` (``lm_float32_checks``
    of ``float32_model(ARCH)``), ``serve_inv:fp`` / ``serve_inv:int8``
    (``serve_invariants`` on ``serve_float32_model``) and
    ``serve_static``."""
    kind, _, arg = job.partition(":")
    if kind == "float32":
        model = float32_model(arg)
        _build.reset_launch_counts()
        res = lm_float32_checks(model, *(LM_F32 if arg == LM_ARCH
                                         else FAMILY_F32))
    elif kind == "serve_inv":
        m32, spec_i8 = serve_float32_model()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve_invariants(m32, arg, "fp" if arg == "fp" else spec_i8)
        res["seconds"] = time.perf_counter() - t0
    elif kind == "serve_static":
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve_static()
        res["seconds"] = time.perf_counter() - t0
    else:
        raise ValueError(f"unknown worker job {job!r}")
    res["launches"] = {k: _build.LAUNCH_COUNTS[k] for k in KERNEL_META}
    pathlib.Path(out).write_text(json.dumps(res))


class Workers(Procs):
    """Check jobs (``run_worker``), each in a process of its own, at most
    ``MAX_WORKERS`` at a time, in the order given.  The checks that run
    this way are host-bound token-by-token decodes; nothing timed runs
    beside them (each phase waits for its jobs before it times).  A
    failed check fails its process, and ``wait`` and ``result`` raise
    with the end of its output; ``stop`` kills what still runs."""

    def __init__(self, tmp: pathlib.Path, jobs):
        self.tmp, self.results = tmp, {}
        super().__init__(
            {job: [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
                   job, str(self._out(job))] for job in jobs},
            tmp, max_parallel=MAX_WORKERS, cwd=str(ROOT))

    def _out(self, job: str) -> pathlib.Path:
        return self.tmp / f"{job}.json"

    def result(self, job: str) -> dict:
        if job not in self.results:
            self.wait()
            self.results[job] = json.loads(self._out(job).read_text())
        return self.results[job]


def phase_lm_prefill(f32: Workers) -> dict:
    # counts to 0 just before this path, read just after (with the count
    # of the process that ran the float32 checks)
    _build.reset_launch_counts()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab_padded) == (28, 1536, 12, 2, 8960, 152064),
          f"{LM_ARCH} is not at its published width")
    model = lm_model(cfg)
    accuracy = lm_bf16_accuracy(model, cfg)     # beside the float32 checks
    f32_s = f32.wait()
    runs = [f32.result(FLOAT32_JOBS[0]), accuracy]
    runs += [lm_bf16_run(model, cfg, B, S, reps) for B, S, reps in LM_BF16]
    del model
    torch.cuda.empty_cache()
    return dict(phase="lm_prefill", arch=LM_ARCH, seed=LM_SEED,
                params=cfg.param_count(), runs=runs,
                float32_checks_s=f32_s,
                note="ms_per_prefill: host clock around forward calls "
                     "ended by a synchronize, after one warm call; the "
                     "float32 checks of this phase and of lm_families ran "
                     "in processes of their own, at most "
                     f"{MAX_WORKERS} at a time, beside the bf16 "
                     "accuracy check (so their decode seconds are not "
                     "those of a card to themselves); the timed runs ran "
                     "alone",
                launches=dict(flash_attention=_build.LAUNCH_COUNTS[
                    "flash_attention"] + runs[0]["launches"][
                        "flash_attention"]))


# --------------------------------------------------------------------------
# phase: lm_families — MoE, Mamba2 and the Zamba2 hybrid at full width
# --------------------------------------------------------------------------

def check_widths(cfg, want: dict) -> None:
    got = dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
               vocab=cfg.vocab, launches=attn_launches(cfg))
    if cfg.family == "moe":
        m = cfg.moe
        got["moe"] = (m.n_experts, m.top_k, m.n_shared, m.d_expert)
    else:
        got["ssm"] = (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.expand)
    if cfg.family == "hybrid":
        got["attn_every"] = cfg.attn_every
    check(got == want, f"{cfg.name} is not at its published width: {got}")


def first_layers(params, n: int) -> ParamTree:
    """A ParamTree of ``params``'s embedding, head, norms and first ``n``
    layers, sharing their storage."""
    tree = params.tree()
    tree["layers"] = tree["layers"][:n]
    return ParamTree(tree)


def moe_dispatch_check(layer, cfg) -> dict:
    """One full-width MoE layer (float32 weights) at the published
    capacity, B x S = ``FAMILY_ORACLE``: ``apply_moe`` (queue ranks,
    dispatch into (B, E, C, d), batched experts, gather) against
    ``apply_moe_direct`` (float64, each expert on its own tokens, no
    dispatch) with the same routing and keep mask, within 1e-4 of max|y|:
    a dispatch fault moves a token's output by O(1).  The input is normal
    noise plus one direction all tokens share (half its rms), as a
    residual stream has: it makes some experts popular, so slots are
    dropped (iid noise alone spreads 2048 tokens below the capacity)."""
    B, S = FAMILY_ORACLE
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 2)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=DEV) + \
        0.5 * torch.randn((cfg.d_model,), generator=gen, device=DEV)
    kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor)
    r = lm_moe.route(layer, x, **kw)
    y, _ = lm_moe.apply_moe(layer, x, act=cfg.mlp_act, **kw)
    want = lm_moe.apply_moe_direct(layer, x, r, act=cfg.mlp_act)
    scale = float(want.abs().max())
    err = float((y.double() - want).abs().max())
    check(bool(torch.isfinite(y).all()) and err <= 1e-4 * scale,
          f"{cfg.name}: apply_moe vs the no-dispatch oracle {err} > 1e-4 * "
          f"{scale}")
    dropped = float(1.0 - r.in_cap.float().mean())
    check(dropped > 0, f"{cfg.name}: no slot dropped at capacity {r.C}")
    return dict(B=B, S=S, capacity_factor=cfg.moe.capacity_factor,
                capacity=r.C, dropped_slot_share=dropped, max_abs_err=err,
                y_scale=scale)


def lm_family(arch: str, f32: Workers) -> dict:
    """One config: float32 checks at ``FAMILY_F32`` (at no-drop capacity
    for MoE, as the reference's decode test; run by ``f32``, in a process
    of their own: ``float32_model``), the MoE dispatch against
    its oracle, the bf16 logits against a float32 forward of the same
    weights, and bf16 prefills timed.  The float32 model is a float32 copy
    of the bf16 model's weights (its first ``FAMILY_F32_LAYERS`` layers
    where cut)."""
    cfg = get_config(arch)
    check_widths(cfg, FAMILY_WIDTHS[arch])
    model = lm_model(cfg)
    cut = FAMILY_F32_LAYERS.get(arch, cfg.n_layers)
    cfg_cut = dataclasses.replace(cfg, n_layers=cut)
    p32 = first_layers(model.params, cut).to(torch.float32)
    out = dict(arch=arch, family=cfg.family, params=cfg.param_count(),
               float32_layers=cut, float32=f32.result(f"float32:{arch}"))
    if cfg.family == "moe":
        out["dispatch"] = moe_dispatch_check(p32.layers[0].moe, cfg)
    m16 = model
    if cut != cfg.n_layers:
        m16 = get_model(cfg_cut)
        m16.params = first_layers(model.params, cut)
    out["bfloat16_check"] = lm_bf16_accuracy(m16, cfg_cut, truth_params=p32)
    del m16, p32
    torch.cuda.empty_cache()
    runs = [FAMILY_BF16] + ([FAMILY_LONG] if cfg.supports_long_context
                            else [])
    out["runs"] = [lm_bf16_run(model, cfg, B, S, reps)
                   for B, S, reps in runs]
    del model
    torch.cuda.empty_cache()
    return out


def phase_lm_families(f32: Workers) -> dict:
    t0 = time.perf_counter()
    # counts to 0 just before this path, read just after (with the counts
    # of the processes that ran the float32 checks)
    _build.reset_launch_counts()
    archs = [lm_family(arch, f32) for arch in FAMILY_WIDTHS]
    return dict(phase="lm_families", seed=LM_SEED, archs=archs,
                seconds=time.perf_counter() - t0,
                cut="qwen2-moe-a2.7b: float32 checks and the bf16 check at "
                    "4 of its 24 layers; everything else at full depth",
                note="ms_per_prefill: host clock around forward calls "
                     "ended by a synchronize, after one warm call",
                launches=dict(flash_attention=_build.LAUNCH_COUNTS[
                    "flash_attention"] + sum(
                        a["float32"]["launches"]["flash_attention"]
                        for a in archs)))


# --------------------------------------------------------------------------
# phase: serve — the serving engine, qwen2-1.5b at full width
# --------------------------------------------------------------------------

SERVE_PAGE = 16
SERVE_CHUNK = 256
SERVE_F32 = (1024, 64)          # paged vs forward: prompt, decoded tokens
# the float32 invariants: (prompt, new tokens) per request, four first and
# two after 3 steps; the prefix variant's suffixes after a shared prefix
SERVE_INV = dict(batch_slots=4, max_seq=1024, prefill_chunk=SERVE_CHUNK,
                 page_size=SERVE_PAGE)
SERVE_INV_REQS = ((512, 32), (496, 32), (480, 24), (464, 28), (64, 20),
                  (160, 16))
SERVE_PREFIX = 256
SERVE_PREFIX_REQS = ((200, 24), (40, 16), (120, 32), (8, 20), (256, 28),
                     (64, 16))
# static mode: (arch, requests, prompt, new tokens, layers), float32; the
# one cut: 6 of mamba2's 48 layers (its host-bound decode step, ~48 ms at
# full depth, would take ~120 s over the batched and the four solo runs;
# 12 layers took 34 s on one H100 80GB HBM3's host, 700 W)
SERVE_STATIC = ("mamba2-780m", 4, 512, 32, 6)
# bf16 serving, timed: 16 requests (prompt 128-2048, 16-64 new tokens:
# cut from 32-128, whose four variants took 95 s on one H100 80GB HBM3's
# host, 700 W; a cut in depth would change the decode step that is
# timed, fewer tokens only how many such steps there are), eight first
# and eight after 3 steps; the prefix variant's shared prefix
SERVE_BF16 = dict(batch_slots=8, max_seq=4096, prefill_chunk=SERVE_CHUNK,
                  page_size=SERVE_PAGE)
SERVE_BF16_N = 16
SERVE_BF16_NEW = (16, 65)     # new tokens a request: [low, high)
SERVE_BF16_PREFIX = 1024
# two top logits closer than this (of the logit scale) are a tie to
# float32 rounding: the one divergence allowed between two streams
STREAM_TIE = 1e-5
# the seeded init with tied embeddings makes every position's own input
# token win greedy decoding (its logit ~d against a spread of ~sqrt(d)),
# so every stream would repeat its last prompt token and every stream check
# would pass whatever attention did.  The serve phase multiplies each
# layer's residual-branch outputs (wo, w_down) by this gain, reached in
# steps of 4 with a probe at each (in the phase's line): on these seeded
# weights no probe position predicts its own token at 256, but greedy
# streams still sit on one token; from 1024 they move
SERVE_BRANCH_GAIN = 1024.0
SERVE_SELF_SHARE = 0.1     # at most this share of self-predictions then


def serve_requests(vocab, lens, seed, prefix_len=0):
    """Greedy requests of (prompt, new tokens) ``lens``, request_id the
    index, with prompts drawn from ``seed`` after a shared prefix of
    ``prefix_len`` tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=(prefix_len,))
    return [Request(prompt=np.concatenate(
                        [prefix, rng.integers(0, vocab, size=(int(n),))]),
                    max_new_tokens=int(m), request_id=i)
            for i, (n, m) in enumerate(lens)]


def paged_logits(model, spec, toks, n_prefill):
    """Logits (S, V) of ``toks`` (S,) through ``decode_paged`` against a
    fresh page pool of ``spec``: the first ``n_prefill`` tokens in chunks
    of ``SERVE_CHUNK``, then one token per call."""
    cfg, S = model.cfg, toks.shape[0]
    cache = PagedKVCache(cfg, spec, 1, S, page_size=SERVE_PAGE, device=DEV)
    check(cache.grow(0, S), "paged_logits: pool too small")
    table, scales = cache.slot_table(0), spec.scales(DEV)
    out = torch.empty((S, cfg.vocab), device=DEV)
    with torch.inference_mode():
        starts = list(range(0, n_prefill, SERVE_CHUNK)) + \
            list(range(n_prefill, S))
        for i, start in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else S
            lg, _ = model.decode_paged(
                toks[None, start:end], cache.pages, table,
                torch.tensor([start], device=DEV), page_size=SERVE_PAGE,
                kv_scales=scales)
            out[start:end] = lg[0, :, :cfg.vocab].float()
    return out


def serve_paged_vs_forward(model, spec_i8) -> dict:
    """float32: a ``SERVE_F32[0]``-token prompt through ``decode_paged`` in
    chunks of 256 (page 16), then ``SERVE_F32[1]`` tokens one at a time
    (teacher forcing), against one ``Model.forward`` of the whole sequence
    through the flash-attention kernel: within 1e-4 (prefill positions)
    and 1e-3 (decode positions) of the logit scale with the fp pool, the
    bars of ``lm_prefill``; the all-int8 pool's distance and top-1
    agreement reported, with no bar."""
    cfg = model.cfg
    P, D = SERVE_F32
    toks = lm_tokens(cfg, 1, P + D)[0]
    with torch.inference_mode():
        truth = model(toks[None])[0, :, :cfg.vocab]
    scale = float(truth.abs().max())
    out = dict(dtype="float32", prompt=P, decoded=D, chunk=SERVE_CHUNK,
               page_size=SERVE_PAGE, logit_scale=scale)
    for name, spec in (("fp", KVCacheSpec.all_fp(cfg.n_layers)),
                       ("int8", spec_i8)):
        got = paged_logits(model, spec, toks, P)
        err = (got - truth).abs().amax(dim=-1)
        res = dict(prefill_max_abs_err=float(err[:P].max()),
                   decode_max_abs_err=float(err[P:].max()),
                   rms_rel_err=float((got - truth).square().mean().sqrt())
                   / scale,
                   top1_agreement=float((got.argmax(-1) ==
                                         truth.argmax(-1)).float().mean()))
        if name == "fp":
            check(res["prefill_max_abs_err"] <= 1e-4 * scale,
                  f"paged prefill vs forward {res['prefill_max_abs_err']} "
                  f"> 1e-4 * {scale}")
            check(res["decode_max_abs_err"] <= 1e-3 * scale,
                  f"paged decode vs forward {res['decode_max_abs_err']} "
                  f"> 1e-3 * {scale}")
        out[name] = res
        del got
    return out


def stream_check(prompt, got, want, logits_of) -> dict:
    """Two greedy streams of one prompt are equal, or first differ at a
    near-tie: where the logits of their common prefix (``logits_of``) have
    their two top tokens, the two streams' picks, within ``STREAM_TIE`` of
    the logit scale.  The comparison ends at that flip (at most one)."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if n is None:
        check(len(got) == len(want), f"stream lengths {len(got)} and "
                                     f"{len(want)} differ")
        return dict(equal=len(want))
    seq = torch.as_tensor(np.concatenate([prompt, want[:n]]), device=DEV)
    lg = logits_of(seq)
    top = torch.topk(lg, 2)
    margin, scale = float(top.values[0] - top.values[1]), \
        float(lg.abs().max())
    check(set(top.indices.tolist()) == {got[n], want[n]}
          and margin < STREAM_TIE * scale,
          f"streams differ at token {n} ({got[n]} vs {want[n]}) where the "
          f"top-2 logits are {margin} apart of {scale}: not a near-tie")
    return dict(equal=n, flip=dict(position=n, margin=margin,
                                   logit_scale=scale))


def serve_midstream(engine, reqs, first):
    """Submit ``first`` requests, step 3 times, submit the rest, run."""
    handles = [engine.submit(r) for r in reqs[:first]]
    for _ in range(3):
        engine.step()
    handles += [engine.submit(r) for r in reqs[first:]]
    engine.run()
    return [engine.scheduler.outputs[h] for h in handles]


def serve_invariants(model, spec_name, spec) -> dict:
    """float32, greedy, ``SERVE_INV``: every request's stream in four
    variants (continuous batching, n-gram speculation, prefix caching over
    a shared 256-token prefix, a pool of half the worst case) equals the
    same request served alone on the same pool type, but for one near-tie
    flip.  The near-tie's logits come from ``Model.forward`` (fp pool) or
    a paged prefill on the pool's spec (int8: what the stream saw)."""
    cfg = model.cfg
    if spec_name == "fp":
        def logits_of(seq):
            with torch.inference_mode():
                return model(seq[None])[0, -1, :cfg.vocab].float()
    else:
        def logits_of(seq):
            return paged_logits(model, spec, seq, seq.shape[0])[-1]
    worst = SERVE_INV["batch_slots"] * -(-SERVE_INV["max_seq"] //
                                         SERVE_PAGE) + 1
    inv = serve_requests(cfg.vocab, SERVE_INV_REQS, LM_SEED + 3)
    pre = serve_requests(cfg.vocab, SERVE_PREFIX_REQS, LM_SEED + 4,
                         SERVE_PREFIX)
    solo = ServingEngine(model, ServingConfig(
        **dict(SERVE_INV, batch_slots=1), kv_cache=spec))
    want = {id(r): solo.generate([r])[0] for r in inv + pre}
    cold_chunks = sum(-(-len(r.prompt) // SERVE_CHUNK) for r in pre)
    out = dict(solo_decode_steps=solo.metrics.decode_steps)
    for variant, reqs, kw in (
            ("batched", inv, {}),
            ("ngram", inv, dict(spec_decode="ngram", spec_k=4)),
            ("prefix", pre, dict(prefix_cache=True)),
            ("preempt", inv, dict(num_pages=worst // 2))):
        eng = ServingEngine(model, ServingConfig(**SERVE_INV, **kw,
                                                 kv_cache=spec))
        got = serve_midstream(eng, reqs, 4)
        checks = [stream_check(r.prompt, g, want[id(r)], logits_of)
                  for r, g in zip(reqs, got)]
        m = eng.metrics.summary()
        res = dict(flips=[dict(request=i, **c["flip"])
                          for i, c in enumerate(checks) if "flip" in c],
                   tokens_compared=sum(c["equal"] for c in checks),
                   tokens=sum(len(g) for g in got),
                   distinct_tokens=[len(set(g)) for g in got],
                   **{k: m[k] for k in ("decode_steps", "prefill_chunks",
                                        "preemptions", "spec_proposed",
                                        "spec_accepted", "prefix_hit_rate")})
        check(sum(len(set(g)) for g in got) > len(got),
              f"{variant}: every stream repeats one token (a vacuous check)")
        if variant == "ngram":
            check(m["spec_steps"] > 0, "n-gram speculation never verified")
        if variant == "prefix":
            check(m["prefix_hit_rate"] > 0 and
                  m["prefill_chunks"] < cold_chunks,
                  f"prefix cache: hit rate {m['prefix_hit_rate']}, "
                  f"{m['prefill_chunks']} chunks vs {cold_chunks} cold")
            res["cold_prefill_chunks"] = cold_chunks
        if variant == "preempt":
            check(m["preemptions"] >= 1, f"no preemption with "
                                         f"{worst // 2} pages")
            res["num_pages"] = worst // 2
        out[variant] = res
        del eng
    return out


def serve_branch_gain(model) -> dict:
    """Multiply every layer's ``wo`` and ``w_down`` by 4 (exact in bf16)
    up to ``SERVE_BRANCH_GAIN``, probing each gain on 256 tokens: the share
    of positions whose greedy pick is their own input token, the distinct
    picks, the logit scale and the median top-2 margin."""
    cfg = model.cfg
    toks = lm_tokens(cfg, 1, 256)
    gain, probes = 1.0, []
    while True:
        with torch.inference_mode():
            lg = model(toks)[0, :, :cfg.vocab].float()
        picks, top = lg.argmax(-1), lg.topk(2, dim=-1).values
        probes.append(dict(
            gain=gain, self_share=float((picks == toks[0]).float().mean()),
            distinct_picks=int(picks.unique().numel()),
            logit_scale=float(lg.abs().max()),
            median_top2_margin=float((top[:, 0] - top[:, 1]).median())))
        if gain >= SERVE_BRANCH_GAIN:
            break
        with torch.no_grad():
            for p in model.params["layers"]:
                p["attn"]["wo"].mul_(4.0)
                p["mlp"]["w_down"].mul_(4.0)
        gain *= 4.0
    check(probes[-1]["self_share"] <= SERVE_SELF_SHARE,
          f"branch gain {gain}: {probes[-1]['self_share']} of the positions "
          f"still predict their own token")
    return dict(gain=gain, probes=probes)


def serve_spec_report(model):
    """The SIRA spec at full width: the default (every layer's decision
    and reason) and the one the int8 pool uses, derived with ``max_step``
    raised to the default's worst step rounded up to a tenth, so that
    every layer goes int8."""
    t0 = time.perf_counter()
    default = derive_kv_spec(model)
    derive_s = time.perf_counter() - t0

    def steps(spec):
        return [float(max(l.k_amax.max(), l.v_amax.max()) / 127.0)
                for l in spec.layers]
    worst = max(steps(default))
    max_step = math.ceil(worst * 10) / 10
    spec_i8 = derive_kv_spec(model, max_step=max_step)
    check(spec_i8.n_int8 == model.cfg.n_layers,
          f"max_step {max_step}: {spec_i8.n_int8} int8 layers")
    reasons: dict = {}
    for l in default.layers:
        reasons[l.reason or "int8"] = reasons.get(l.reason or "int8", 0) + 1
    report = dict(default=dict(max_step=0.5, n_int8=default.n_int8,
                               layers=len(default.layers),
                               reasons=[l.reason for l in default.layers],
                               reason_counts=reasons,
                               step_per_layer=steps(default),
                               derive_s=derive_s),
                  int8_pool=dict(max_step=max_step, n_int8=spec_i8.n_int8,
                                 step_per_layer=steps(spec_i8),
                                 k_scale_per_layer=[
                                     l.k_scale.tolist()
                                     for l in spec_i8.layers]))
    return spec_i8, report


def serve_timed(model, spec, kw, reqs, first) -> dict:
    """One bf16 engine run over ``reqs`` (``first`` submitted, 3 steps,
    the rest): the metrics' summary, TTFT p50/p99, ms per decode step at
    every slot active (median of the ``serve:decode_step`` spans, which
    end after the sampled tokens reach the host), ms per prefill chunk
    (each ``serve:prefill`` span, which ends the same way, over its
    chunks; median), peak device memory."""
    tracer, prev = Tracer(enabled=True), get_tracer()
    eng = ServingEngine(model, ServingConfig(**SERVE_BF16, **kw,
                                             kv_cache=spec))
    pool = eng.cache.hbm_bytes()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        outs = serve_midstream(eng, reqs, first)
    finally:
        set_tracer(prev)
    wall_s = time.perf_counter() - t0
    m = eng.metrics
    full = [sp.dur_us / 1e3 for sp in tracer.spans
            if sp.name == "serve:decode_step"
            and sp.attrs["active"] == SERVE_BF16["batch_slots"]]
    verify = [sp.dur_us / 1e3 for sp in tracer.spans
              if sp.name == "serve:spec_verify"]
    chunk = [sp.dur_us / 1e3 / -(-(sp.attrs["prompt_tokens"] -
                                   sp.attrs["cached_tokens"]) //
                                 SERVE_CHUNK)
             for sp in tracer.spans if sp.name == "serve:prefill"]
    med = lambda xs: statistics.median(xs) if xs else None
    res = dict(summary=m.summary(), wall_s=wall_s,
               distinct_tokens=[len(set(o)) for o in outs],
               ttft_p50_s=m.ttft_percentile(50),
               ttft_p99_s=m.ttft_percentile(99),
               token_latency_p50_s=m.token_latency_percentile(50),
               ms_per_decode_step_all_slots=med(full),
               decode_steps_all_slots=len(full),
               ms_per_verify_step=med(verify),
               ms_per_prefill_chunk=med(chunk),
               pool_bytes=pool, memory_allocated_before=resident,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    check(all(len(o) == r.max_new_tokens for o, r in zip(outs, reqs)),
          "bf16 serving: a request did not get its tokens")
    check(all(0 <= t < model.cfg.vocab for o in outs for t in o),
          "bf16 serving: a token outside the vocabulary")
    return res, outs


def device_profile(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall ms (ended by a
    synchronize), the device's busy ms (the union of its kernels'
    intervals) and idle share, device ms by PyTorch operator (top twelve,
    self time of the kernels they launched) and ``by_kernel``: each
    kernel's name -> [ms, launches]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        acc = by_kernel.setdefault(ev.name, [0.0, 0])
        acc[0] += ev.time_range.elapsed_us() / 1e3
        acc[1] += 1
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    ops = sorted(((a.self_device_time_total / 1e3, a.count, a.key)
                  for a in prof.key_averages()
                  if a.key.startswith("aten::")
                  and a.self_device_time_total > 0), reverse=True)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                idle_share=max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
                kernels=len(spans),
                device_ms_by_op=[dict(op=k, ms=ms, calls=n)
                                 for ms, n, k in ops[:12]],
                device_ms_other_ops=sum(ms for ms, _, _ in ops[12:]),
                by_kernel=by_kernel)


def top_kernels(by_kernel: dict, n: int) -> list:
    return [dict(kernel=k[:100], ms=ms, calls=c) for k, (ms, c) in
            sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:n]]


def serve_decode_profile(model, reqs) -> dict:
    """One decode step with every slot active (``SERVE_BF16``, fp pool),
    profiled after two warm steps."""
    eng = ServingEngine(model, ServingConfig(**SERVE_BF16))
    for r in reqs[:SERVE_BF16["batch_slots"]]:
        eng.submit(dataclasses.replace(r, max_new_tokens=16))
    for _ in range(3):                 # admit + prefill all, then warm
        eng.step()
    check(len(eng.scheduler.active_slots()) == SERVE_BF16["batch_slots"],
          "decode profile: not every slot is active")
    lengths = [eng.scheduler.slots[i].length
               for i in eng.scheduler.active_slots()]
    prof = device_profile(eng.step)
    prof["top_kernels"] = top_kernels(prof.pop("by_kernel"), 8)
    return dict(batch_slots=SERVE_BF16["batch_slots"],
                max_seq=SERVE_BF16["max_seq"], cached_tokens=lengths,
                **prof)


def serve_static() -> dict:
    """Static mode on an SSM at full width, float32: four equal-length
    prompts batched against each served alone (near-tie rule, the
    forward's logits), and the refusals the reference makes: a mixed-
    length batch and paged mode."""
    arch, n, P, new, layers = SERVE_STATIC
    cfg = get_config(arch)
    check_widths(cfg, FAMILY_WIDTHS[arch])
    model = lm_model(dataclasses.replace(cfg, dtype=torch.float32,
                                         n_layers=layers))
    rng = np.random.default_rng(LM_SEED + 6)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(P,)),
                    max_new_tokens=new) for _ in range(n)]
    sc = ServingConfig(batch_slots=n, max_seq=P + new)
    eng = ServingEngine(model, sc)
    check(eng.mode == "static", f"{arch} serves in {eng.mode} mode")
    t0 = time.perf_counter()
    got = eng.generate(reqs)
    batched_s = time.perf_counter() - t0
    solo = ServingEngine(model, sc.replace(batch_slots=1))
    t0 = time.perf_counter()
    want = [solo.generate([r])[0] for r in reqs]
    solo_s = time.perf_counter() - t0

    def logits_of(seq):
        with torch.inference_mode():
            return model(seq[None])[0, -1, :cfg.vocab].float()
    checks = [stream_check(r.prompt, g, w, logits_of)
              for r, g, w in zip(reqs, got, want)]
    refusals = []
    for bad in (lambda: eng.generate([reqs[0], dataclasses.replace(
                    reqs[1], prompt=reqs[1].prompt[:P // 2])]),
                lambda: ServingEngine(model, sc.replace(mode="paged"))):
        try:
            bad()
        except NotImplementedError as e:
            refusals.append(str(e)[:80])
    check(len(refusals) == 2, f"{arch}: a mixed-length batch or paged mode "
                              f"was not refused")
    del model, eng, solo
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, dtype="float32", layers=layers,
                cut=f"{layers} of {cfg.n_layers} layers", requests=n,
                prompt=P, new_tokens=new,
                distinct_tokens=[len(set(g)) for g in got],
                tokens_compared=sum(c["equal"] for c in checks),
                flips=[dict(request=i, **c["flip"])
                       for i, c in enumerate(checks) if "flip" in c],
                batched_s=batched_s, solo_s=solo_s, refusals=refusals)


def serve_bf16(model, spec_i8) -> dict:
    """bf16 (the published dtype), ``SERVE_BF16``, 16 requests from a
    seed, eight first and eight after 3 steps, in four variants: the fp
    pool, the int8 pool, n-gram speculation, the prefix cache (a shared
    1024-token prefix).  Then the int8 streams' agreement with the fp
    ones, and one decode step profiled."""
    rng = np.random.default_rng(LM_SEED + 5)
    lens = list(zip(rng.integers(128, 2049, SERVE_BF16_N),
                    rng.integers(*SERVE_BF16_NEW, SERVE_BF16_N)))
    V = model.cfg.vocab
    reqs = serve_requests(V, lens, LM_SEED + 7)
    pre = serve_requests(V, list(zip(rng.integers(64, 1025, SERVE_BF16_N),
                                     rng.integers(*SERVE_BF16_NEW,
                                                  SERVE_BF16_N))),
                         LM_SEED + 8, SERVE_BF16_PREFIX)
    half = SERVE_BF16_N // 2
    serve_timed(model, "fp", {}, serve_requests(V, ((300, 8), (40, 8)),
                                                LM_SEED + 9), 1)  # warm-up
    runs, streams = {}, {}
    for name, spec, kw, rs in (
            ("fp", "fp", {}, reqs), ("int8", spec_i8, {}, reqs),
            ("ngram", "fp", dict(spec_decode="ngram", spec_k=4), reqs),
            ("prefix", "fp", dict(prefix_cache=True), pre)):
        runs[name], streams[name] = serve_timed(model, spec, kw, rs, half)
        gc.collect()
        torch.cuda.empty_cache()
    fp, i8 = streams["fp"], streams["int8"]
    agree = [sum(a == b for a, b in zip(x, y)) / len(x)
             for x, y in zip(fp, i8)]
    first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                  len(x)) for x, y in zip(fp, i8)]
    return dict(
        dtype="bfloat16", config=SERVE_BF16, requests=SERVE_BF16_N,
        prompt_tokens=[int(n) for n, _ in lens],
        new_tokens=[int(m) for _, m in lens],
        runs=runs,
        int8_vs_fp=dict(mean_token_agreement=float(np.mean(agree)),
                        per_request=agree, first_divergence=first),
        decode_profile=serve_decode_profile(model, reqs))


def serve_float32_model():
    """(the float32 copy of the served bf16 model, the int8 pool's spec):
    seeded bf16 weights, ``wo`` and ``w_down`` x``SERVE_BRANCH_GAIN``
    (``serve_branch_gain``), the spec from ``serve_spec_report``; what
    ``phase_serve`` builds, for a worker process."""
    cfg = get_config(LM_ARCH)
    bf16 = lm_model(cfg)
    serve_branch_gain(bf16)
    spec_i8, _ = serve_spec_report(bf16)
    m32 = get_model(dataclasses.replace(cfg, dtype=torch.float32))
    m32.params = bf16.params.to(torch.float32)
    return m32, spec_i8


#: the serve phase's host-bound checks, run beside its untimed work
SERVE_JOBS = ["serve_inv:fp", "serve_inv:int8", "serve_static"]


def phase_serve(card: str) -> dict:
    t_phase = time.perf_counter()
    gc.collect()                      # the earlier phases' models
    torch.cuda.empty_cache()
    # counts to 0 just before this path, read just after (with the counts
    # of the processes that ran the invariants and the static mode)
    _build.reset_launch_counts()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.vocab) == (28, 1536, 12, 2, 128, 151936),
          f"{LM_ARCH} is not at its published width")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = Workers(pathlib.Path(tmp), SERVE_JOBS)
        try:
            bf16 = lm_model(cfg)
            gain = serve_branch_gain(bf16)
            spec_i8, spec_report = serve_spec_report(bf16)
            pools = {name: PagedKVCache(cfg, spec, SERVE_BF16["batch_slots"],
                                        SERVE_BF16["max_seq"],
                                        page_size=SERVE_PAGE,
                                        device=DEV).hbm_bytes()
                     for name, spec in (
                         ("bf16", KVCacheSpec.all_fp(cfg.n_layers)),
                         ("int8", spec_i8))}
            check(2 * pools["int8"] == pools["bf16"],
                  f"the int8 pool is not half the bf16 pool: {pools}")
            spec_report["pool_bytes"] = pools
            torch.cuda.empty_cache()
            m32 = get_model(dataclasses.replace(cfg, dtype=torch.float32))
            m32.params = copy.deepcopy(bf16.params).to(torch.float32)
            t0 = time.perf_counter()
            paged = serve_paged_vs_forward(m32, spec_i8)
            paged["seconds"] = time.perf_counter() - t0
            del m32
            gc.collect()
            torch.cuda.empty_cache()
            jobs_s = jobs.wait()
            res = {job: jobs.result(job) for job in SERVE_JOBS}
        finally:
            jobs.stop()
    inv = {name: res[f"serve_inv:{name}"] for name in ("fp", "int8")}
    inv["seconds"] = jobs_s
    static = res["serve_static"]
    t0 = time.perf_counter()
    timed = serve_bf16(bf16, spec_i8)
    timed["seconds"] = time.perf_counter() - t0
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: _build.LAUNCH_COUNTS[k] + sum(
        r["launches"][k] for r in res.values()) for k in KERNEL_META}
    return dict(phase="serve", arch=LM_ARCH, seed=LM_SEED, card=card,
                branch_gain=gain, kv_spec=spec_report, paged_vs_forward=paged,
                invariants=inv, bf16=timed, static=static,
                seconds=time.perf_counter() - t_phase,
                note="times: host clock; tokens/s and TTFT from the "
                     "engine's ServingMetrics; no kernel of this repo on "
                     "the serving path (paged attention is plain "
                     "PyTorch): flash_attention runs only in the "
                     "Model.forward oracles; the invariants (fp, int8) "
                     "and the static mode ran in processes of their own "
                     "beside the spec and paged-vs-forward checks "
                     "(invariants.seconds: their wall time together); "
                     "the bf16 runs were timed alone",
                launches=launches)


# --------------------------------------------------------------------------
# phase: lm_train — the LM's gradient through the backward kernels, and
# training at full width through launch/train.py
# --------------------------------------------------------------------------

# (name, B, Sq, Sk, H, KV, hd, keywords): each in float32, bfloat16 and
# float16.  hd 64, 80, 128, 200, 256; GQA groups 1, 2 and 6; Sq = Sk and
# Sq < Sk with q_offset; window and logit_cap (gemma2); lengths no tile
# divides; rows that see no key; a batch whose B x H fills the card
FA_BWD_GRID = [
    ("g6 hd128 ragged", 1, 200, 200, 12, 2, 128, {}),
    ("g1 hd64 cap", 2, 130, 130, 4, 4, 64, dict(logit_cap=30.0)),
    ("g6 hd80 window", 1, 150, 150, 6, 1, 80, dict(window=37)),
    ("hd256 window cap", 1, 100, 100, 4, 2, 256,
     dict(window=40, logit_cap=50.0)),
    # gemma2's head: GQA group 2 with ragged lengths; q_offset with its
    # window and soft-cap
    ("hd256 g2 ragged", 1, 200, 200, 8, 4, 256, {}),
    ("hd256 q_offset window cap", 1, 70, 197, 8, 4, 256,
     dict(q_offset=127, window=64, logit_cap=50.0)),
    # a head between 128 and 256: the last 64-column chunk partly zeros
    ("hd200 g2 q_offset", 1, 90, 130, 4, 2, 200, dict(q_offset=40)),
    ("g6 q_offset", 2, 70, 197, 6, 1, 128, dict(q_offset=127)),
    ("q_offset window cap", 1, 33, 97, 6, 6, 64,
     dict(q_offset=64, window=16, logit_cap=30.0)),
    ("rows that see no key", 1, 16, 32, 4, 2, 64,
     dict(q_offset=64, window=8)),
    ("not causal", 1, 40, 70, 2, 1, 64, dict(causal=False, window=12)),
    ("fills the card", 16, 256, 256, 12, 2, 128, {}),
]
#: the kernel's lse against the plain one, relative to max(1, |lse|)
LSE_TOL = 1e-5
#: kernel (a)'s D against rowsum(dO*out) in float32, relative to the row's
#: sum of |dO*out| (the same float32 products summed in another order)
DELTA_TOL = 1e-5
#: the full-width gradient: float32, B x S, every leaf within this share
#: of its largest element of the gradient through the plain attention
LM_GRAD = (1, 1024)
LM_GRAD_TOL = 1e-4
#: the bf16 gradient at LM_GRAD: each leaf's distance to the float32
#: gradient within this factor of the plain attention's bf16 distance,
#: plus this share of the float32 gradient's norm
LM_GRAD16_FACTOR = 1.5
LM_GRAD16_FLOOR = 1e-3
#: training through launch/train.py at published widths, bf16 params and
#: float32 masters: the global batch and length (4 x 2048 in 2
#: microbatches ran out of the card's 80 GB, so the batch is halved), the
#: microbatches, the steps and the checkpoint interval, the warm steps
#: left out of the median
LM_TRAIN = dict(batch=2, seq=2048, microbatches=2, steps=20, ckpt_every=10,
                warm=3)


#: the backward's kernels per route ("name:route"), as counted and
#: reported: D has one route; dK/dV and dQ two
BWD_ROUTED = (BWD_KERNELS[0],) + tuple(
    f"{n}:{r}" for n in BWD_KERNELS[1:] for r in BWD_ROUTES)


def bwd_routes(dt, hd) -> list:
    """The routes a grid case runs: ``route_for``'s, then ``cuda_cores``
    forced where that is another."""
    first = bwd_route_for(dt, hd)
    return [first] + ([CUDA_CORES] if first != CUDA_CORES else [])


def bwd_grid_case(name, B, Sq, Sk, H, KV, hd, dt, kw, gen) -> dict:
    """One case: the forward's lse against the plain one; D of kernel
    (a) against rowsum(dO*out); on each of ``bwd_routes``, dq, dk, dv of
    the backward kernels against the plain backward (same out and lse)
    within ``grad_tolerance`` (on the ``tensor_cores`` route with its term
    for rounding P and dS) and bit-equal over two calls; the distance to
    float64 autograd through ``flash_attention_ref``, reported."""
    q = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).to(dt)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device=DEV).to(dt)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device=DEV).to(dt)
    dout = torch.randn((B, Sq, H, hd), generator=gen, device=DEV).to(dt)
    what = f"{name} {str(dt)[6:]} B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} {kw}"
    out, lse = flash_attention_fwd_lse(q, k, v, **kw)
    lse_p = flash_attention_lse_ref(q, k, **kw)
    dead = lse_p < DEAD_LSE
    check(bool((dead == (lse < DEAD_LSE)).all()),
          f"{what}: the kernel and the plain lse disagree on which rows "
          f"see no key")
    lse_err = float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1.0))
                    [~dead].max()) if bool((~dead).any()) else 0.0
    check(lse_err <= LSE_TOL, f"{what}: lse {lse_err} from the plain one")
    # kernel (a) alone: D against rowsum(dO*out) in float32, each row
    # within DELTA_TOL of the sum of its terms' magnitudes
    prod = dout.float() * out.float()
    d_plain = prod.sum(-1).permute(0, 2, 1)
    d_err = (bwd_delta(out, dout) - d_plain).abs()
    check(bool((d_err <= DELTA_TOL * prod.abs().sum(-1).permute(
        0, 2, 1)).all()), f"{what}: D differs from rowsum(dO*out) (max abs "
        f"err {float(d_err.max())})")
    del prod, d_plain
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    routes = bwd_routes(dt, hd)
    mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, dout, **kw) \
        if TENSOR_CORES in routes else None
    # float64 autograd through the plain forward: the distance, reported
    x64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    g64 = torch.autograd.grad(flash_attention_ref(*x64, **kw), x64,
                              dout.double())
    del x64
    res = dict(max_abs_err={BWD_KERNELS[0]: float(d_err.max())},
               lse_rel_err=lse_err, rel_err_vs_float64_autograd={})
    for route in routes:
        counted = BWD_KERNELS + tuple(f"{n}:{route}"
                                      for n in BWD_KERNELS[1:])
        before = {n: _build.LAUNCH_COUNTS[n] for n in counted}
        got = flash_attention_bwd(q, k, v, out, lse, dout, route=route,
                                  **kw)
        check(all(_build.LAUNCH_COUNTS[n] == before[n] + 1
                  for n in counted),
              f"{what} {route}: not one launch per kernel")
        again = flash_attention_bwd(q, k, v, out, lse, dout, route=route,
                                    **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what} {route}: two calls of the backward differ")
        errs = {}
        for i, (g, w, gname) in enumerate(zip(got, want,
                                              ("dq", "dk", "dv"))):
            check(g.dtype == dt and g.shape == w.shape
                  and bool(torch.isfinite(g).all()),
                  f"{what} {route}: {gname} wrong in type, shape or value")
            d = (g.double() - w.double()).abs()
            bar = grad_tolerance(w, mags[i] if route == TENSOR_CORES
                                 else None)
            check(bool((d <= bar).all()),
                  f"{what} {route}: {gname} differs from the plain backward "
                  f"(max abs err {float(d.max())}, at max|g| "
                  f"{float(w.abs().max())}; worst err/bar "
                  f"{float((d / bar).max())})")
            errs[gname] = float(d.max())
        res["max_abs_err"][f"{BWD_KERNELS[1]}:{route}"] = max(errs["dk"],
                                                             errs["dv"])
        res["max_abs_err"][f"{BWD_KERNELS[2]}:{route}"] = errs["dq"]
        res["rel_err_vs_float64_autograd"][route] = max(
            float((g.double() - w).abs().max() / w.abs().max().clamp_min(
                1e-30)) for g, w in zip(got, g64))
        del got, again
    return res


def grid_flash_attention_bwd() -> dict:
    """Every case of ``FA_BWD_GRID`` in float32, bfloat16 and float16 and
    the layer in float32 and bfloat16, each on its routes
    (``bwd_routes``)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    L = FA_LAYER
    grid = [(name, B, Sq, Sk, H, KV, hd, dt, kw)
            for name, B, Sq, Sk, H, KV, hd, kw in FA_BWD_GRID
            for dt in (torch.float32, torch.bfloat16, torch.float16)]
    # the slice's real layer shape
    grid += [("layer", L["B"], L["S"], L["S"], L["H"], L["KV"], L["hd"], dt,
              {}) for dt in (torch.float32, torch.bfloat16)]
    worst = dict(max_abs_err={n: 0.0 for n in BWD_ROUTED},
                 max_abs_err_hd256={n: 0.0 for n in BWD_ROUTED},
                 lse_rel_err=0.0, rel_err_vs_float64_autograd={},
                 runs={r: 0 for r in BWD_ROUTES})
    for case in grid:
        r = bwd_grid_case(*case, gen)
        for n, e in r["max_abs_err"].items():
            worst["max_abs_err"][n] = max(worst["max_abs_err"][n], e)
            if case[6] > 128:         # the hd-256 tiling's cases apart
                worst["max_abs_err_hd256"][n] = max(
                    worst["max_abs_err_hd256"][n], e)
        worst["lse_rel_err"] = max(worst["lse_rel_err"], r["lse_rel_err"])
        by = worst["rel_err_vs_float64_autograd"]
        dtn = str(case[7])[6:]
        for route, e in r["rel_err_vs_float64_autograd"].items():
            key = f"{dtn} {route}"
            by[key] = max(by.get(key, 0.0), e)
            worst["runs"][route] += 1
    torch.cuda.synchronize()
    worst["cases"] = len(grid)
    return worst


def loss_grads(model, toks):
    """``Model.loss`` over ``toks`` (inputs and next-token labels) and its
    gradient with respect to every leaf of the model's parameters."""
    flat, spec = flatten(model.param_tree())
    live = [t.detach().requires_grad_(True) for t in flat]
    loss = model.loss(unflatten(spec, live), toks[:, :-1], toks[:, 1:])
    return float(loss.detach()), torch.autograd.grad(loss, live)


def lm_grad_check() -> dict:
    """qwen2-1.5b at full width in float32: ``Model.loss``'s gradient with
    the kernels (one forward and three backward launches per layer)
    against the gradient through the plain attention, leaf by leaf."""
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype=torch.float32)
    model = lm_model(cfg)
    B, S = LM_GRAD
    toks = lm_tokens(cfg, B, S + 1)
    counted = ("flash_attention",) + BWD_KERNELS
    before = {n: _build.LAUNCH_COUNTS[n] for n in counted}
    loss_k, g_k = loss_grads(model, toks)
    launches = {n: _build.LAUNCH_COUNTS[n] - before[n] for n in counted}
    check(all(launches[n] == cfg.n_layers for n in counted),
          f"float32 loss and gradient: launches {launches}, not "
          f"{cfg.n_layers} of each kernel")
    with plain_attention():
        loss_p, g_p = loss_grads(model, toks)
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and err <= LM_GRAD_TOL * scale,
              f"float32 gradient, leaf {i} {tuple(b.shape)}: kernels vs "
              f"plain attention {err} > {LM_GRAD_TOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    n_leaves = len(g_k)
    del model, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    return dict(dtype="float32", B=B, S=S, loss_kernels=loss_k,
                loss_plain=loss_p, leaves=n_leaves,
                max_rel_err_per_leaf=worst, bar=LM_GRAD_TOL,
                launches=launches)


def lm_grad_check_bf16(cfg, B: int, S: int) -> dict:
    """``cfg`` (qwen2-1.5b at full width; gemma2-2b's published widths at
    2 of its layers) in bfloat16: ``Model.loss``'s gradient at B x S
    through the kernels (the ``tensor_cores`` backward, one launch of
    each per layer) against g32, the float32 gradient of a float32 copy
    of the same weights through the plain attention.  Each leaf: ||g -
    g32|| <= LM_GRAD16_FACTOR ||g_plain16 - g32|| + LM_GRAD16_FLOOR
    ||g32||, with g_plain16 the bfloat16 gradient through the plain
    attention (PERF.md §2's bf16-logits rule: the kernels' rounding of P
    and dS may add to a bf16 backward's error, not dominate it)."""
    check(cfg.dtype == torch.bfloat16, f"{cfg.name} is not bfloat16")
    model = lm_model(cfg)
    toks = lm_tokens(cfg, B, S + 1)
    counted = BWD_KERNELS[1:] + tuple(f"{n}:{r}" for n in BWD_KERNELS[1:]
                                      for r in BWD_ROUTES)
    before = {n: _build.LAUNCH_COUNTS[n] for n in counted}
    loss_k, g_k = loss_grads(model, toks)
    launches = {n: _build.LAUNCH_COUNTS[n] - before[n] for n in counted}
    check(all(launches[n] == cfg.n_layers and
              launches[f"{n}:{TENSOR_CORES}"] == cfg.n_layers and
              launches[f"{n}:{CUDA_CORES}"] == 0 for n in BWD_KERNELS[1:]),
          f"bf16 loss and gradient: launches {launches}, not "
          f"{cfg.n_layers} of each on the tensor_cores route")
    with plain_attention():
        loss_p, g_p = loss_grads(model, toks)
    ref = get_model(dataclasses.replace(cfg, dtype=torch.float32))
    ref.params = copy.deepcopy(model.params).to(torch.float32)
    del model
    with plain_attention():
        loss_32, g_32 = loss_grads(ref, toks)
    del ref
    worst, rows = 0.0, 0
    for i, (a, b, c) in enumerate(zip(g_k, g_p, g_32)):
        c = c.double()
        d_k = float((a.double() - c).norm())
        d_p = float((b.double() - c).norm())
        bar = LM_GRAD16_FACTOR * d_p + LM_GRAD16_FLOOR * float(c.norm())
        check(bool(torch.isfinite(a).all()) and d_k <= bar,
              f"bf16 gradient, leaf {i} {tuple(c.shape)}: ||kernels - "
              f"float32|| {d_k} > {bar} (plain bf16 {d_p}, ||g32|| "
              f"{float(c.norm())})")
        worst = max(worst, d_k / bar if bar else 0.0)
        rows += 1
    del g_k, g_p, g_32
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, dtype="bfloat16", B=B,
                S=S, loss_kernels=loss_k, loss_plain=loss_p,
                loss_float32=loss_32, leaves=rows, max_share_of_bar=worst,
                factor=LM_GRAD16_FACTOR, floor=LM_GRAD16_FLOOR,
                launches=launches)


def train_argv(steps: int, ckpt_dir=None) -> list:
    t = LM_TRAIN
    argv = ["--arch", LM_ARCH, "--steps", str(steps), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--microbatches",
            str(t["microbatches"]), "--log-every", "1", "--device", "cuda"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every",
                 str(t["ckpt_every"])]
    return argv


def train_lines_ok(text: str, steps: int) -> bool:
    """The reference's lines: one per step (``--log-every 1``), then the
    loss summary."""
    lines = text.splitlines()
    return len(lines) == steps + 1 and all(
        re.fullmatch(r"step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} lr "
                     r"\d\.\d{2}e[-+]\d{2} \(\d+\.\ds\)", ln)
        for ln in lines[:-1]) and lines[-1].startswith("loss ")


def device_families(by_kernel: dict) -> dict:
    """Device ms of a profile's kernels by family: the flash forward,
    each backward kernel on either route (``flash_bwd_dkdv_tc`` and its
    GQA sum ``flash_bwd_dkdv_sum`` count as dK/dV, ``flash_bwd_dq_tc`` as
    dQ), cuBLAS, the rest."""
    fam = dict(flash_forward=0.0, **{n: 0.0 for n in BWD_KERNELS},
               cublas=0.0, other=0.0)
    names = {"flash_bwd_delta": "flash_attention_bwd_delta",
             "flash_bwd_dkdv": "flash_attention_bwd_dkdv",
             "flash_bwd_dq": "flash_attention_bwd_dq",
             "flash_kernel": "flash_forward"}
    for kernel, (ms, _) in by_kernel.items():
        key = next((v for k, v in names.items() if k in kernel), None)
        if key is None:
            key = "cublas" if any(w in kernel.lower() for w in (
                "gemm", "nvjet", "cutlass", "xmma", "cublas")) else "other"
        fam[key] += ms
    return fam


class _Killed(Exception):
    """Stands for the process being killed (``lm_train_run``)."""


@contextlib.contextmanager
def killed_at(step: int):
    """``launch.train`` runs as if killed when it reaches ``step``: its
    pipeline raises there (after the checkpoint of the step before)."""
    real = lm_trainer.TokenPipeline

    class Killed(real):
        def batch_at(self, s):
            if s == step:
                raise _Killed
            return super().batch_at(s)
    lm_trainer.TokenPipeline = Killed
    try:
        yield
    finally:
        lm_trainer.TokenPipeline = real


def lm_train_run(card: str) -> dict:
    """``launch.train`` at published widths under deterministic
    algorithms (cuBLAS's fixed workspace set for this check only).  A
    straight run of ``steps`` steps: the reference's lines, one forward
    and three backward launches per layer and microbatch (dK/dV and dQ
    on the ``tensor_cores`` route), a falling loss
    (the mean of the last 5 below that of the first 5), ms per step (the
    median after the warm steps), tokens/s, the model-FLOP share, peak
    memory, one more step profiled; its final state is kept on the host.
    Then the same run with a checkpoint every ``ckpt_every`` steps, killed
    when it reaches step ``ckpt_every`` (so its last checkpoint is the
    middle one, as if the final one had been deleted), and the same
    command again: it resumes there, and its final state equals the
    straight run's bit for bit.  (The runs call ``launch.train.run``, the
    body of ``main``, which hands back the state; a checkpoint of this
    state is 21.6 GB, so the runs write two and read one.)"""
    t = LM_TRAIN
    cfg = get_config(LM_ARCH)
    counted = ("flash_attention",) + BWD_KERNELS + BWD_ROUTED[1:]
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    prev_mode = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    try:
        torch.cuda.reset_peak_memory_stats()
        before = {n: _build.LAUNCH_COUNTS[n] for n in counted}
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            first = lm_trainer.run(train_argv(t["steps"]))
        peak = torch.cuda.max_memory_allocated()
        launches = {n: _build.LAUNCH_COUNTS[n] - before[n] for n in counted}
        per_run = cfg.n_layers * t["microbatches"] * t["steps"]
        # bf16: every dK/dV and dQ launch on the tensor cores
        want = {n: per_run if ":" not in n or n.endswith(TENSOR_CORES)
                else 0 for n in counted}
        check(launches == want,
              f"training: launches {launches}, not {per_run} of each "
              f"kernel ({cfg.n_layers} layers x {t['microbatches']} "
              f"microbatches x {t['steps']} steps; dK/dV and dQ on the "
              f"tensor_cores route)")
        check(train_lines_ok(printed.getvalue(), t["steps"]),
              f"training printed {printed.getvalue()[:300]!r}")
        losses = first.losses
        first5 = statistics.mean(losses[:5])
        last5 = statistics.mean(losses[-5:])
        check(all(math.isfinite(x) for x in losses) and last5 < first5,
              f"training: the loss did not fall ({first5} -> {last5})")
        step_s = statistics.median(first.step_seconds[t["warm"]:])
        state_bytes = lm_dryrun.state_bytes(first.state)
        # kept before the profiled step, which updates the donated state
        # in place
        kept = tree_map(lambda x: None if x is None else
                        x.detach().cpu(), first.state)
        prof = device_profile(lambda: first.step_fn(
            first.state, first.pipeline.batch_at(t["steps"])))
        first_s = time.perf_counter() - t0
        del first
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            argv = train_argv(t["steps"], tmp)
            t1 = time.perf_counter()
            with killed_at(t["ckpt_every"]), \
                    contextlib.redirect_stdout(io.StringIO()):
                try:
                    lm_trainer.run(argv)
                except _Killed:
                    pass
            gc.collect()
            torch.cuda.empty_cache()
            middle = pathlib.Path(tmp, f"ckpt_{t['ckpt_every']:08d}.npz")
            check(sorted(os.listdir(tmp)) == [middle.name],
                  f"the killed run left {sorted(os.listdir(tmp))}")
            size = middle.stat().st_size
            killed_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                again = lm_trainer.run(argv)
            again_s = time.perf_counter() - t1
            head = printed.getvalue().splitlines()[0]
            check(again.start_step == t["ckpt_every"] and head ==
                  f"resumed from {middle} at step {t['ckpt_every']}",
                  f"the second run did not resume at step "
                  f"{t['ckpt_every']}: {head!r}")
            pairs = [(a, b) for a, b in zip(leaves(kept),
                                            leaves(again.state))
                     if a is not None or b is not None]
            # compared on the card: a copy to it is faster than one from it
            check(pairs and all(
                a is not None and b is not None
                and torch.equal(a.to(b.device), b.detach())
                for a, b in pairs),
                "the resumed run's state differs from the straight run's")
            del again
    finally:
        torch.use_deterministic_algorithms(prev_mode)
        if prev_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
    tokens = t["batch"] * t["seq"]
    n_active = cfg.active_param_count()
    return dict(
        card=card, dtype="bfloat16 params, float32 masters",
        algorithms="deterministic", **{
            k: t[k] for k in ("batch", "seq", "microbatches", "steps",
                              "ckpt_every")},
        warm_steps=t["warm"], tokens_per_step=tokens, losses=losses,
        loss_first5=first5, loss_last5=last5, ms_per_step=step_s * 1e3,
        tokens_per_s=tokens / step_s,
        model_flop_share=6.0 * n_active * tokens / (step_s * BF16_OPS_PER_S),
        active_params=n_active, max_memory_allocated=peak,
        state_bytes=state_bytes, launches=launches,
        profile=dict(wall_ms=prof["wall_ms"],
                     device_busy_ms=prof["device_busy_ms"],
                     idle_share=prof["idle_share"],
                     kernels=prof["kernels"],
                     device_ms_by_family=device_families(prof["by_kernel"]),
                     top_kernels=top_kernels(prof["by_kernel"], 8)),
        resume=dict(killed_at=t["ckpt_every"], resumed_at=t["ckpt_every"],
                    tensors_equal=len(pairs), checkpoint_bytes=size),
        straight_run_s=first_s, killed_run_s=killed_s,
        resumed_run_s=again_s, seconds=time.perf_counter() - t0)


def phase_lm_train(card: str) -> dict:
    t_phase = time.perf_counter()
    gc.collect()                      # the earlier phases' models
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.vocab) == (28, 1536, 12, 2, 128, 151936),
          f"{LM_ARCH} is not at its published width")
    t0 = time.perf_counter()
    grid = grid_flash_attention_bwd()
    grid["seconds"] = time.perf_counter() - t0
    # counts to 0 just before this path (the grid's launches, which hold
    # the kernels against their plain versions, do not count), read just
    # after
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    grad = lm_grad_check()
    grad["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad16 = lm_grad_check_bf16(get_config(LM_ARCH), *LM_GRAD)
    grad16["seconds"] = time.perf_counter() - t0
    train = lm_train_run(card)
    return dict(phase="lm_train", arch=LM_ARCH, card=card, grid=grid,
                gradient=grad, gradient_bf16=grad16, train=train,
                seconds=time.perf_counter() - t_phase,
                note="ms_per_step: host clock, median after the warm "
                     "steps, each step ending when its loss reaches the "
                     "host, under deterministic algorithms; "
                     "model_flop_share: 6 N_active tokens / (step s x "
                     "989e12); the profile: one more step of the same "
                     "run",
                launches={k: _build.LAUNCH_COUNTS[k]
                          for k in ("flash_attention",) + BWD_KERNELS
                          + BWD_ROUTED[1:]})


# --------------------------------------------------------------------------
# phase: gemma2_train — gemma2-2b (head dim 256) trained at published widths
# --------------------------------------------------------------------------

#: training through launch/train.py at gemma2-2b's published widths and
#: depth, bf16 params and float32 masters: the global batch and length
#: (for the card's 80 GB: 36.6 GB of params and AdamW state and 10.5 GB of
#: float32 gradient sums at 2.6 B params; 2 x 1024 peaked at 67.3 GB,
#: which left over 15 GB, so the length is 1536), the microbatches, the
#: steps and the warm steps left out of the median
GEMMA2_TRAIN = dict(batch=2, seq=1536, microbatches=2, steps=12, warm=2)
#: the gradient check of the windowed layers: gemma2's widths at 2 of its
#: 26 layers (layer 0 local, window 4096; layer 1 global) at B x S, long
#: enough that the window cuts the last S - 4096 queries of layer 0
GEMMA2_GRAD = dict(layers=2, B=1, S=6144)


def gemma2_train_run() -> dict:
    """``launch.train`` at gemma2-2b's published widths (26 layers):
    the reference's lines, one forward and three backward launches per
    layer and microbatch (dK/dV and dQ on the ``tensor_cores`` route,
    head dim 256), the loss falling (the mean of the last 3 steps below
    that of the first 3), ms per step (the median after the warm steps),
    tokens/s, the model-FLOP share, peak memory, one more step
    profiled."""
    t = GEMMA2_TRAIN
    cfg = get_config(GEMMA2_ARCH)
    counted = ("flash_attention",) + BWD_KERNELS + BWD_ROUTED[1:]
    argv = ["--arch", GEMMA2_ARCH, "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--microbatches",
            str(t["microbatches"]), "--log-every", "1", "--device", "cuda"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    # counts to 0 just before the path, read just after
    _build.reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        run = lm_trainer.run(argv)
    launches = {n: _build.LAUNCH_COUNTS[n] for n in counted}
    peak = torch.cuda.max_memory_allocated()
    per_run = cfg.n_layers * t["microbatches"] * t["steps"]
    want = {n: per_run if ":" not in n or n.endswith(TENSOR_CORES) else 0
            for n in counted}
    check(launches == want,
          f"gemma2 training: launches {launches}, not {per_run} of each "
          f"kernel ({cfg.n_layers} layers x {t['microbatches']} "
          f"microbatches x {t['steps']} steps; dK/dV and dQ on the "
          f"tensor_cores route)")
    check(train_lines_ok(printed.getvalue(), t["steps"]),
          f"gemma2 training printed {printed.getvalue()[:300]!r}")
    losses = run.losses
    first3, last3 = statistics.mean(losses[:3]), statistics.mean(
        losses[-3:])
    check(all(math.isfinite(x) for x in losses) and last3 < first3,
          f"gemma2 training: the loss did not fall ({first3} -> {last3})")
    step_s = statistics.median(run.step_seconds[t["warm"]:])
    run_s = time.perf_counter() - t0
    state_bytes = lm_dryrun.state_bytes(run.state)
    prof = device_profile(lambda: run.step_fn(
        run.state, run.pipeline.batch_at(t["steps"])))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    tokens = t["batch"] * t["seq"]
    n_active = cfg.active_param_count()
    return dict(
        dtype="bfloat16 params, float32 masters",
        algorithms="not deterministic", **{
            k: t[k] for k in ("batch", "seq", "microbatches", "steps")},
        warm_steps=t["warm"], tokens_per_step=tokens, losses=losses,
        loss_first3=first3, loss_last3=last3, ms_per_step=step_s * 1e3,
        tokens_per_s=tokens / step_s,
        model_flop_share=6.0 * n_active * tokens / (step_s * BF16_OPS_PER_S),
        active_params=n_active, max_memory_allocated=peak,
        free_of_card=torch.cuda.get_device_properties(0).total_memory
        - peak, state_bytes=state_bytes, launches=launches,
        profile=dict(wall_ms=prof["wall_ms"],
                     device_busy_ms=prof["device_busy_ms"],
                     idle_share=prof["idle_share"],
                     kernels=prof["kernels"],
                     device_ms_by_family=device_families(prof["by_kernel"]),
                     top_kernels=top_kernels(prof["by_kernel"], 8)),
        run_s=run_s, seconds=time.perf_counter() - t0)


def phase_gemma2_train(card: str) -> dict:
    """gemma2-2b, the one registered model with head dim 256, on the
    hd-256 tiling of the tensor-core backward: the bf16 gradient check of
    its windowed layer at 2 of its 26 layers (``GEMMA2_GRAD``), then
    training at published widths (``GEMMA2_TRAIN``)."""
    gc.collect()                      # the earlier phases' models
    torch.cuda.empty_cache()
    cfg = get_config(GEMMA2_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.sliding_window, cfg.attn_softcap) ==
          (26, 2304, 8, 4, 256, 9216, 256000, 4096, 50.0),
          f"{GEMMA2_ARCH} is not at its published width")
    check(bwd_route_for(cfg.dtype, cfg.hd) == TENSOR_CORES,
          f"{GEMMA2_ARCH}'s backward is not on the tensor_cores route")
    g = GEMMA2_GRAD
    check(g["S"] > cfg.sliding_window, "the window does not cut")
    t0 = time.perf_counter()
    grad16 = lm_grad_check_bf16(
        dataclasses.replace(cfg, n_layers=g["layers"]), g["B"], g["S"])
    grad16["seconds"] = time.perf_counter() - t0
    grad16["window_cuts_queries"] = g["S"] - cfg.sliding_window
    train = gemma2_train_run()
    return dict(phase="gemma2_train", arch=GEMMA2_ARCH, card=card,
                gradient_bf16=grad16, train=train,
                note="ms_per_step: host clock, median after the warm "
                     "steps, each step ending when its loss reaches the "
                     "host; model_flop_share: 6 N_active tokens / (step s "
                     "x 989e12); the profile: one more step of the same "
                     "run; launches: the training run's",
                launches=train["launches"])


# --------------------------------------------------------------------------
# phase: launch — qwen2-1.5b over two ranks on the one card, compressed_psum,
# the dry run's prediction against what the phases measured
# --------------------------------------------------------------------------

LAUNCH_PREFILL = (1, 1024)            # (B, S) of the float32 sharded prefill
LAUNCH_PREFILL_TOL = 1e-4             # of max|logits|: lm_prefill's bar
# sharded serving, float32: 4 greedy requests (prompt, new tokens), 4 slots
LAUNCH_SERVE = dict(slots=4, max_seq=512, page=SERVE_PAGE, chunk=SERVE_CHUNK,
                    requests=[(64, 32), (128, 32), (192, 32), (256, 32)],
                    variants=["fp", "int8"], max_step=1.4)
LAUNCH_PSUM_N = 1 << 20
# the dry run's cells that the phases run: lm_prefill's bf16 1 x 32768
# (the prefill_32k cell cut to batch 1, measured again through the dry
# run's CLI) and lm_train's step
LAUNCH_PREFILL_ARGV = ["--arch", LM_ARCH, "--shape", "prefill_32k",
                       "--layout", "1x1", "--batch", "1", "--seq", "32768",
                       "--measure"]
LAUNCH_TRAIN_CELL = ShapeCell("train_2x2048", LM_TRAIN["seq"],
                              LM_TRAIN["batch"], "train")


def launch_ranks() -> dict:
    """Two ranks (layout (1, 2), gloo, both on ``cuda:0``), each its own
    process: (a) the float32 prefill of qwen2-1.5b at full width against
    the whole model, (b) sharded serving against the whole engine (fp
    and int8 pools; ``wo``, ``w_down`` x``SERVE_BRANCH_GAIN``), (c)
    ``compressed_psum`` against the plain sum."""
    cfg = get_config(LM_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(2, dict(
            layout=[1, 2], device=DEV.type, arch=LM_ARCH, dtype="float32",
            seed=LM_SEED, tol=LAUNCH_PREFILL_TOL, prefill_shape=LAUNCH_PREFILL,
            serve_branch_gain=SERVE_BRANCH_GAIN, exact=False, tie=STREAM_TIE,
            psum_n=LAUNCH_PSUM_N, pg_timeout=120.0,
            tasks=["prefill", "serve", "psum"], **LAUNCH_SERVE), tmp,
            timeout_s=400)
        wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        pre = res["prefill"]
        check(res["backend"] == "gloo" and res["device"] ==
              str(torch.device(DEV.type, 0) if DEV.type == "cuda" else DEV),
              f"rank {r}: {res['backend']} on {res['device']}")
        check(pre["flash_launches"] == cfg.n_layers,
              f"rank {r}: {pre['flash_launches']} flash_attention launches "
              f"per sharded forward, not {cfg.n_layers}")
        check(pre["max_abs_err"] <= LAUNCH_PREFILL_TOL * pre["logit_scale"],
              f"rank {r}: sharded prefill {pre['max_abs_err']}")
        for v in LAUNCH_SERVE["variants"]:
            run = res["serve"][v]
            check(2 * run["pool_bytes"] == run["whole_pool_bytes"],
                  f"rank {r} {v}: pool {run['pool_bytes']} of "
                  f"{run['whole_pool_bytes']}")
            check(sum(run["distinct_tokens"]) > len(run["streams"]),
                  f"rank {r} {v}: every stream repeats one token")
        ps = res["psum"]
        check(ps["max_abs_err"] <= ps["bound"], f"rank {r}: psum")
    a, b = ranks
    check(a["prefill"]["digest"] == b["prefill"]["digest"],
          "the ranks' logits differ")
    check(a["psum"]["digest"] == b["psum"]["digest"],
          "the ranks' compressed_psum differ")
    for v in LAUNCH_SERVE["variants"]:
        check(a["serve"][v]["streams"] == b["serve"][v]["streams"],
              f"{v}: the ranks' streams differ")
    serve = {v: {k: a["serve"][v][k] for k in (
        "tokens_compared", "flips", "distinct_tokens", "pool_bytes",
        "whole_pool_bytes", "n_int8", "seconds", "decode_steps",
        "prefill_chunks", "collectives")} for v in LAUNCH_SERVE["variants"]}
    n = LAUNCH_PSUM_N
    psum = dict(a["psum"], elements=n, payload_bytes=dict(
        int8=n, int32_sum=4 * n, float32=4 * n))
    return dict(wall_s=wall, param_bytes=a["param_bytes"],
                whole_param_bytes=a["whole_param_bytes"],
                prefill={k: a["prefill"][k] for k in (
                    "B", "S", "max_abs_err", "logit_scale", "tol",
                    "flash_launches", "collectives", "whole_first_s",
                    "sharded_first_s")},
                prefill_err_rank1=b["prefill"]["max_abs_err"],
                serve=serve, psum=psum,
                launches=sum(res["prefill"]["flash_launches"]
                             for res in ranks),
                rank_seconds=[res["seconds"] for res in ranks])


# (e)-(h): training split over the two ranks, fake-quant, MoE expert
# parallelism, Mamba2/Zamba2 by head and static serving under the layout;
# the whole-model oracle of each runs first, in a process of its own
# lm_train's 1024 tokens of the gradient check as 2 x 512: under (2, 1)
# each data rank takes one row (a row cannot be split over two ranks).
# Cut to 4 of 28 layers: at full depth the oracle's float32 gradient and
# masters are 12.9 GB and the two ranks' (2, 1) step, a float32 copy of
# the model each, 19 s of gloo staging (one H100 80GB HBM3, 700 W)
LAUNCH_TRAIN_F32 = dict(arch=LM_ARCH, dtype="float32", seed=LM_SEED,
                        layers=4, batch=[2, 512], steps=1, microbatches=[1],
                        layouts=[[1, 2], [2, 1]], lr=1e-5, warmup=1,
                        tol_loss=1e-5, tol_grad=LM_GRAD_TOL,
                        tol_master=1e-6)
# the loss of one fake-quant step (QuantSpec(bits=8)), same inputs
LAUNCH_TRAIN_QUANT = dict(LAUNCH_TRAIN_F32, quant_bits=8, tol_grad=None,
                          tol_master=None)
# bf16 (published dtype), timed: lm_train's batch, 10 steps, no oracle
LAUNCH_TRAIN_TIMED = dict(arch=LM_ARCH, seed=LM_SEED,
                          batch=[LM_TRAIN["batch"], LM_TRAIN["seq"]],
                          microbatches=[LM_TRAIN["microbatches"]],
                          layouts=[[1, 2]], steps=10, warm=3, lr=3e-3,
                          warmup=5, oracle=False, remat=False)
LAUNCH_FAMILY_TOL = 1e-4     # of the logit scale: lm_families' bar
LAUNCH_MOE = dict(archs=["granite-moe-3b-a800m", "qwen2-moe-a2.7b"],
                  layers=dict(FAMILY_F32_LAYERS), dtype="float32",
                  seed=LM_SEED, shape=[1, 512], decode=8, layout=[1, 2],
                  tol=LAUNCH_FAMILY_TOL, tie=ROUTING_TIE)
LAUNCH_SSM = dict(LAUNCH_MOE, archs=["mamba2-780m", "zamba2-2.7b"])
# serve's static mamba2 (6 of 48 layers, 4 requests, 32 new tokens) with
# prompts of 128, not 512: static mode prefills token by token, and 544
# split steps took 36 s (one H100 80GB HBM3, 700 W)
LAUNCH_STATIC = dict(archs=[SERVE_STATIC[0]], layers=SERVE_STATIC[4],
                     dtype="float32", seed=LM_SEED, layout=[1, 2],
                     requests=[[128, SERVE_STATIC[3]]] * SERVE_STATIC[1],
                     max_seq=128 + SERVE_STATIC[3],
                     exact=False, tie=STREAM_TIE)
SPLIT_TASKS = ["train", "train_quant", "moe_prefill", "ssm_prefill",
               "static_serve", "train_timed"]
SPLIT_ARGS = dict(layout=[1, 2], pg_timeout=300.0, tasks=SPLIT_TASKS,
                  train=LAUNCH_TRAIN_F32, train_quant=LAUNCH_TRAIN_QUANT,
                  moe_prefill=LAUNCH_MOE, ssm_prefill=LAUNCH_SSM,
                  static_serve=LAUNCH_STATIC, train_timed=LAUNCH_TRAIN_TIMED)


def split_args() -> dict:
    """The arguments of (e)-(h)'s oracle and ranks."""
    # two ranks, each with a float32 copy of the model under (2, 1), share
    # the card: segments that grow keep the caching allocator from
    # stranding memory between the steps' differently sized blocks
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    return dict(SPLIT_ARGS, device=DEV.type)


def launch_split(work: pathlib.Path, oracle: Procs) -> dict:
    """(e)-(h) on two ranks (gloo, both on ``cuda:0``), against the
    whole model's results, which one process computes first and the
    ranks read.  (e) qwen2-1.5b's
    float32 step (4 of 28 layers) under (1, 2) and (2, 1) with ZeRO: each
    leaf's gradient within ``LM_GRAD_TOL`` of its max |g|, the masters
    after the update within 1e-6 of the largest master, the loss within
    1e-5 (2 x 512: (2, 1) gives each data rank a row); then bf16 training under (1, 2), timed (``LAUNCH_TRAIN_TIMED``):
    the loss falls, and every rank's backward runs on the tensor cores.
    (f) one fake-quant step's loss under both layouts.  (g), (h) the
    float32 prefill (1 x 512) and eight decode steps of the MoE, Mamba2
    and Zamba2 configs under model = 2, and mamba2's static serving.
    ``oracle``: the process computing the whole models' results into
    ``work`` (``start_oracle`` of ``split_args()``), started beside
    (a)-(c) and waited for here, before the ranks start."""
    t0 = time.perf_counter()
    oracle.wait(600)
    oracle_wait_s = time.perf_counter() - t0
    oracle_s = json.loads((work / "oracle" / "oracle.json").read_text()
                          )["seconds"]
    path = work / "oracle" / "oracle.pt"
    oracle_bytes = path.stat().st_size
    t0 = time.perf_counter()
    ranks = run_ranks(2, dict(split_args(), oracles=[str(path)]),
                      work / "ranks", timeout_s=900)
    ranks_s = time.perf_counter() - t0
    cfg = get_config(LM_ARCH)
    # each task's cases (its "seconds_task" aside)
    ranks = [{k: {c: r for c, r in v.items() if isinstance(r, dict)}
              if k in SPLIT_TASKS else v for k, v in res.items()}
             for res in ranks]
    a, b = ranks
    for key in ("train", "train_quant", "train_timed"):
        for case in a[key]:
            check(a[key][case]["digest"] == b[key][case]["digest"],
                  f"{key} {case}: the ranks' losses differ")
    for r, res in enumerate(ranks):
        for key in ("train", "train_quant"):
            for case, run in res[key].items():
                cmp, = run["vs"]
                check(cmp["loss_rel_err"] <= 1e-5,
                      f"rank {r} {key} {case}: loss {cmp}")
                if key == "train":
                    check(cmp["grad_err"] <= LM_GRAD_TOL and
                          cmp["master_err"] <= 1e-6,
                          f"rank {r} {case}: {cmp}")
        timed, = res["train_timed"].values()
        mb = LAUNCH_TRAIN_TIMED["microbatches"][0]
        want = {f"flash_attention_bwd_{k}:{TENSOR_CORES}":
                cfg.n_layers * mb for k in ("dkdv", "dq")}
        got = {k: timed["launches"].get(k, 0) for k in
               list(want) + [f"flash_attention_bwd_{k}:cuda_cores"
                             for k in ("dkdv", "dq")]}
        check(all(got[k] == n for k, n in want.items()) and
              sum(got.values()) == sum(want.values()),
              f"rank {r}: backward launches per step {got}, not "
              f"{cfg.n_layers} x {mb} of dK/dV and dQ on tensor_cores")
        losses = timed["losses"]
        check(all(math.isfinite(x) for x in losses) and
              statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
              f"rank {r}: the bf16 loss did not fall: {losses}")
        for key in ("moe_prefill", "ssm_prefill"):
            for arch, run in res[key].items():
                cmp, = run["vs"]
                for part, c in cmp.items():
                    check(c["max_abs_err"] <= LAUNCH_FAMILY_TOL *
                          c["logit_scale"], f"rank {r} {arch} {part}: {c}")
                fcfg = get_config(arch)
                depth = LAUNCH_MOE["layers"].get(arch, fcfg.n_layers)
                n_attn = depth // fcfg.attn_every \
                    if fcfg.family == "hybrid" else \
                    (0 if fcfg.family == "ssm" else depth)
                check(run["flash_launches"] == n_attn,
                      f"rank {r} {arch}: {run['flash_launches']} "
                      f"flash_attention launches per forward, not {n_attn}")
        st = res["static_serve"][SERVE_STATIC[0]]
        check(sum(st["distinct_tokens"]) > len(st["streams"]),
              f"rank {r}: every static stream repeats one token")
    for key in ("moe_prefill", "ssm_prefill"):
        for arch in a[key]:
            check(a[key][arch]["digest"] == b[key][arch]["digest"],
                  f"{arch}: the ranks' logits differ")
    check(a["static_serve"][SERVE_STATIC[0]]["streams"] ==
          b["static_serve"][SERVE_STATIC[0]]["streams"],
          "the ranks' static streams differ")

    def train_row(run):
        cmp = run["vs"][0] if run["vs"] else {}
        return dict({k: run.get(k) for k in (
            "layout", "microbatches", "losses", "gnorms", "median_step_s",
            "tokens_per_s", "peak_bytes", "collectives", "launches")},
            **cmp)
    timed = {f"rank{r}": train_row(next(iter(res["train_timed"].values())))
             for r, res in enumerate(ranks)}
    # every rank's launches: the prefills' forwards, and the first step
    # of each training case (its forward and backward kernels)
    launches = {"flash_attention": sum(
        res[key][arch]["flash_launches"] for res in ranks
        for key in ("moe_prefill", "ssm_prefill") for arch in res[key])}
    for res in ranks:
        for key in ("train", "train_quant", "train_timed"):
            for run in res[key].values():
                for k, n in run["launches"].items():
                    launches[k] = launches.get(k, 0) + n
    return dict(
        oracle_s=oracle_s, oracle_wait_s=oracle_wait_s,
        oracle_bytes=oracle_bytes, ranks_s=ranks_s,
        train_f32={case: train_row(run) for case, run in a["train"].items()},
        train_f32_rank1={case: run["vs"][0] for case, run in
                         b["train"].items()},
        train_quant={case: train_row(run)
                     for case, run in a["train_quant"].items()},
        train_bf16=dict(timed, batch=LAUNCH_TRAIN_TIMED["batch"],
                        steps=LAUNCH_TRAIN_TIMED["steps"],
                        warm=LAUNCH_TRAIN_TIMED["warm"],
                        remat=LAUNCH_TRAIN_TIMED["remat"]),
        families={arch: dict({k: run[k] for k in (
            "flash_launches", "seconds", "collectives", "param_bytes",
            "whole_param_bytes", "cache_bytes")}, **run["vs"][0])
            for key in ("moe_prefill", "ssm_prefill")
            for arch, run in a[key].items()},
        static={k: v for k, v in a["static_serve"][SERVE_STATIC[0]].items()
                if k not in ("streams",)},
        launches=launches,
        rank_seconds=[res["seconds"] for res in ranks])


def launch_roofline(card: str, train: dict, lm: dict) -> dict:
    """(d) the dry run's count (``roofline/op_cost.py``) and its
    prediction (``roofline/cost.py``) at layout (1, 1) against
    measurement: the bf16 1 x 32768 prefill through the dry run's CLI
    with ``--measure`` (the normal entry point, ``Model.forward``), and
    lm_train's step from lm_train's own numbers (not run again).
    Parameter and optimizer bytes must equal the real tensors', and the
    count's launches of each hand-written kernel the real call's; the
    count's launches of every kind stand beside the profiler's kernels
    of one such call (lm_prefill's and lm_train's profiles), and the
    counted and predicted FLOPs and bytes beside each other with the
    roofline of each."""
    one = make_layout((1, 1))
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()) as cli:
        pre, = lm_dryrun.main(LAUNCH_PREFILL_ARGV + ["--out", tmp])
    check(pre.ok and pre.measured and pre.counted,
          f"dry run of the prefill cell: {cli.getvalue()[-600:]}")
    t = train["train"]
    step = lm_dryrun.run_cell(LM_ARCH, LAUNCH_TRAIN_CELL.name, layout=one,
                              shape=LAUNCH_TRAIN_CELL,
                              microbatches=LM_TRAIN["microbatches"],
                              remat=False)
    check(step.ok and step.counted,
          f"dry run of the train cell: {step.reason[-300:]}")
    lm_dryrun.compare(step, dict(
        seconds=t["ms_per_step"] / 1e3, peak_bytes=t["max_memory_allocated"],
        what="lm_train's ms per step (median after the warm steps)",
        kernel_launches={k: v / t["steps"] for k, v in t["launches"].items()
                         if v},
        **t["state_bytes"]))
    check(pre.measured["param_bytes_equal"], "prefill: predicted parameter "
          f"bytes {pre.memory['param_bytes']} != "
          f"{pre.measured['param_bytes']}")
    check(step.measured["param_bytes_equal"] and
          step.measured["opt_bytes_equal"],
          f"train: predicted {step.memory['param_bytes']} / "
          f"{step.memory['opt_bytes']} bytes, real "
          f"{step.measured['param_bytes']} / {step.measured['opt_bytes']}")
    for c in (pre, step):
        check(c.measured["kernel_launches_equal"],
              f"{c.shape}: the count's kernel launches "
              f"{c.kernel_launches} != the real call's "
              f"{c.measured['kernel_launches']}")
    profiled = next(r["profile"] for r in lm["runs"]
                    if (r.get("B"), r.get("S")) == LM_PROFILED)
    out = {}
    for c, prof in ((pre, profiled), (step, t["profile"])):
        out[c.shape] = dict(
            card=card, cost=c.cost, memory=c.memory, roofline=c.roofline,
            measured=c.measured,
            launches=dict(counted=c.cost["launches"],
                          profiled_kernels=prof["kernels"],
                          counted_kernels=c.kernel_launches,
                          real_kernels=c.measured["kernel_launches"]),
            counted_vs_predicted=dict(
                flops=(c.cost["flops"], c.predicted["cost"]["flops"]),
                bytes=(c.cost["bytes accessed"],
                       c.predicted["cost"]["bytes accessed"]),
                ratio=c.predicted["ratio"],
                bound_s=(max(c.roofline[k] for k in ROOF_TERMS),
                         max(c.predicted["roofline"][k]
                             for k in ROOF_TERMS)),
                bottleneck=(c.roofline["bottleneck"],
                            c.predicted["roofline"]["bottleneck"])),
            top_ops=sorted(((k, v["launches"], v["bytes"])
                            for k, v in c.by_op.items()),
                           key=lambda r: -r[1])[:10])
    out[pre.shape]["cli"] = " ".join(LAUNCH_PREFILL_ARGV)
    return out


#: the roofline's three time terms
ROOF_TERMS = ("compute_s", "memory_s", "collective_s")


def phase_launch(card: str, train: dict, lm: dict) -> dict:
    t_phase = time.perf_counter()
    gc.collect()                      # the earlier phases' models
    torch.cuda.empty_cache()
    # counts to 0 just before this path, read just after; the ranks count
    # their own launches and hand them back
    _build.reset_launch_counts()
    parts_s = {}
    # (e)-(h)'s whole-model oracle runs in its own process beside (a)-(c);
    # its file (the float32 gradient and masters) goes to the checkout's
    # git-ignored build directory, not to TMPDIR
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = pathlib.Path(tmp)
        oracle = start_oracle(split_args(), work / "oracle")
        try:
            t0 = time.perf_counter()
            ranks = launch_ranks()
            parts_s["a-c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            split = launch_split(work, oracle)
            parts_s["e-h"] = time.perf_counter() - t0
        finally:
            oracle.stop()
    t0 = time.perf_counter()
    roof = launch_roofline(card, train, lm)
    roof["seconds"] = parts_s["d"] = time.perf_counter() - t0
    launches = dict(split["launches"])
    launches["flash_attention"] += _build.LAUNCH_COUNTS["flash_attention"] \
        + ranks["launches"]
    return dict(phase="launch", arch=LM_ARCH, card=card, layout="1x2",
                transport="gloo, both ranks on cuda:0: all_reduce and the "
                          "list form of all_gather staged through the host",
                ranks=ranks, split=split, roofline=roof, parts_s=parts_s,
                seconds=time.perf_counter() - t_phase,
                note="(a) float32 1 x 1024, the sharded forward against the "
                     "whole model in each rank; (b) float32 serving, "
                     "streams vs the whole engine with the near-tie rule; "
                     "(c) compressed_psum: the summed payloads are int32, "
                     "as in the reference, so they move as many bytes as "
                     "float32; (d) the dry run's count (launches of every "
                     "kind beside the profiler's kernels of one call; the "
                     "hand-written kernels' launches equal the real "
                     "call's) and its prediction, each with its roofline; "
                     "mfu: model FLOPs / (measured s x 989e12); "
                     "(e) training split: tensor (1, 2), data + ZeRO (2, 1), "
                     "float32 against the whole model's step, bf16 timed; "
                     "(f) fake-quant; (g) MoE expert parallel; (h) Mamba2 "
                     "and Zamba2 by head (in_proj split by head where the "
                     "reference's spec splits its packed columns evenly) "
                     "and mamba2's static serving under the layout",
                launches=launches)


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
#: the backward kernels: no TPU kernel; the reference differentiates its
#: plain scanned attention with jax.vjp
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
BWD_TC_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu"
BWD_TC256_SOURCE = \
    "src/repro_torch/kernels/csrc/flash_attention_bwd_tc256.cu"
BWD_REPLACES = "src/repro/models/attention.py:66"


def main() -> None:
    env = phase_env()
    emit(env)
    grid = phase_kernel_grid()
    emit(grid)
    main_path = phase_main_path()
    emit(main_path)
    emit(phase_no_fallback(main_path["configs"]))
    sira = phase_sira_flow(main_path["configs"])
    emit(sira)
    qat = phase_qat_chain(env["nvidia_smi"])
    emit(qat)
    examples = phase_examples(env["nvidia_smi"])
    emit(examples)
    times = phase_kernel_times(main_path["configs"])
    emit(times)
    # the float32 checks of lm_prefill and lm_families start here, in
    # processes of their own; lm_prefill waits for them before it times
    with tempfile.TemporaryDirectory() as tmp:
        f32 = Workers(pathlib.Path(tmp), FLOAT32_JOBS)
        try:
            lm = phase_lm_prefill(f32)
            emit(lm)
            fam = phase_lm_families(f32)
            emit(fam)
        finally:
            f32.stop()
    serve = phase_serve(env["nvidia_smi"])
    emit(serve)
    check(serve["launches"]["flash_attention"] > 0 and
          all(serve["launches"][k] == 0
              for k in ("int_matmul", "multithreshold", "quantize")),
          f"serve: launches {serve['launches']}")
    train = phase_lm_train(env["nvidia_smi"])
    emit(train)
    gemma2 = phase_gemma2_train(env["nvidia_smi"])
    emit(gemma2)
    launch = phase_launch(env["nvidia_smi"], train, lm)
    emit(launch)
    phases = dict(main_path=main_path, sira_flow=sira, qat_chain=qat,
                  examples=examples, lm_prefill=lm, lm_families=fam,
                  serve=serve, lm_train=train, gemma2_train=gemma2,
                  launch=launch)
    launches = dict(main_path["launches"], **lm["launches"])
    for phase in (examples, fam, serve, train, gemma2, launch):
        launches["flash_attention"] += phase["launches"]["flash_attention"]
    kernels = []
    for name, meta in KERNEL_META.items():
        t = times[name][0]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=launches[name],
            launches_by_path={k: ph["launches"].get(name, 0)
                              for k, ph in phases.items()},
            max_abs_err=grid[name]["max_abs_err"], ms=t["ms"],
            wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
    for name in BWD_ROUTED:
        t = times["flash_attention_bwd"][0]["kernels"][name]
        check(train["launches"][name] > 0,
              f"{name} was not launched on the lm_train path")
        kernels.append(dict(
            name=name, route="cuda",
            source=BWD_TC_SOURCE if name.endswith(TENSOR_CORES)
            else BWD_SOURCE,
            replaces=BWD_REPLACES,
            note="no TPU kernel: the reference differentiates its plain "
                 "attention with jax.vjp; dK/dV and dQ per route "
                 "(tensor_cores: bf16/f16, hd <= 256, here the hd <= 128 "
                 "tiling; cuda_cores: float32, forced here at bf16 to "
                 "time it)",
            launches=train["launches"][name]
            + launch["launches"].get(name, 0),
            # gemma2's launches are the hd-256 tiling's (the rows below)
            launches_by_path={k: ph["launches"].get(name, 0)
                              for k, ph in phases.items()
                              if k != "gemma2_train"},
            max_abs_err=train["grid"]["max_abs_err"][name], ms=t["ms"],
            wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
    # the tensor_cores route's hd-256 tiling, on gemma2's path
    for name in BWD_ROUTED[1:]:
        if not name.endswith(TENSOR_CORES):
            continue
        t = times["flash_attention_bwd_hd256"][0]["kernels"][name]
        check(gemma2["launches"][name] > 0,
              f"{name} at hd 256 was not launched on the gemma2 path")
        kernels.append(dict(
            name=f"{name} hd256", route="cuda", source=BWD_TC256_SOURCE,
            replaces=BWD_REPLACES,
            note="no TPU kernel: the reference differentiates its plain "
                 "attention with jax.vjp; the tensor_cores route for "
                 "128 < hd <= 256 (gemma2-2b), its two warpgroups "
                 "splitting the head",
            launches=gemma2["launches"][name],
            launches_by_path={"gemma2_train": gemma2["launches"][name]},
            max_abs_err=train["grid"]["max_abs_err_hd256"][name],
            ms=t["ms"], wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"]))
    emit(dict(kernels=kernels), timed=False)
    print(env["nvidia_smi"], flush=True)
    emit(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())), timed=False)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        run_worker(*sys.argv[2:4])
    else:
        main()
