#!/usr/bin/env python3
"""Where the time of accumulator-aware QAT on the PyTorch/CUDA port goes,
on one NVIDIA GPU.

    python3 tools/qat_step_profile.py

It trains ``chip_smoke.py``'s ``qat_chain`` configuration (the width,
steps and seed of ``benchmarks/baselines/BENCH_qat.json``) on the card at
budget 0 (no projection) and at budget 12 (the projection on every
layer).  After ``WARM_STEPS`` steps it profiles ``PROFILED_STEPS`` more
with ``torch.profiler`` and prints one JSON line per budget:

  * ``host_ms_per_step``: wall time per step, each step ended by its loss
    reaching the host (as ``run_qat`` times it), median of the profiled
    steps;
  * per step: ``kernels`` launched, ``device_busy_ms`` (the union of
    the kernels' intervals) and ``device_ms_by_family`` (matrix products,
    sort/scan of the projection, the rest); ``idle_share`` of the wall
    time of the profiled steps;
  * ``compiled_batch``: the same for one call of the trained model's
    float32 plan on a batch of 256 (the three QNN kernels and the glue);
  * ``top_kernels``: the ten kernels with the most device time in the
    profiled steps.

Then the ``nvidia-smi`` name and power limit.  Exits 2 without a CUDA
device (importing ``chip_smoke`` does).
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import BATCH, DEV, qat_bench                   # noqa: E402
from repro_torch.qat import (QATConfig, make_optimizer,        # noqa: E402
                             proven_layer_bits)
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

BUDGETS = (0, 12)
WARM_STEPS = 10
PROFILED_STEPS = 10


def family(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ("gemm", "sm90_xmma", "cutlass", "cublas",
                              "nvjet", "matmul")):
        return "matmul"
    if any(s in low for s in ("sort", "scan", "radix")):
        return "sort_scan"
    return "other"


def device_summary(prof, n: int) -> dict:
    """Kernels of a profile, per unit of ``n``: count, busy time (union
    of their intervals), time by family, and the ten largest."""
    from torch.autograd import DeviceType
    spans, by_family, by_name = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
        fam = family(ev.name)
        by_family[fam] = by_family.get(fam, 0.0) + ms / n
        ms0, c0 = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms0 + ms, c0 + 1)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(kernels=len(spans) / n, device_busy_ms=busy_us / 1e3 / n,
                device_ms_by_family=by_family,
                top_kernels=[dict(ms=ms, calls=c, name=k[:120])
                             for k, (ms, c) in top])


def profile_budget(bench, budget: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = QATConfig(budget=budget, **bench["config"])
    model = cfg.make_model(DEV)
    opt = make_optimizer(cfg, model)
    state = init_train_state(model, opt, cfg.seed)
    step_fn = make_train_step(model, opt, remat=False)
    for step in range(WARM_STEPS):
        state, metrics = step_fn(state, model.synth_batch(step, cfg.batch))
        float(metrics["loss"])
    host_ms = []
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        for step in range(WARM_STEPS, WARM_STEPS + PROFILED_STEPS):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, model.synth_batch(step,
                                                              cfg.batch))
            float(metrics["loss"])
            host_ms.append((time.perf_counter() - t0) * 1e3)
        wall_ms = (time.perf_counter() - t_all) * 1e3
    steps = device_summary(prof, PROFILED_STEPS)
    steps["idle_share"] = max(
        0.0, 1.0 - steps["device_busy_ms"] * PROFILED_STEPS / wall_ms)

    result, _ = proven_layer_bits(model, state.params)
    plan = result.model.compile()
    x = {"X": model.synth_batch(10_000, BATCH)["tokens"].astype("float64")}
    plan(x)                                    # warm
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan(x)                                # returns numpy: synchronised
        batch_ms = (time.perf_counter() - t0) * 1e3
    batch = device_summary(prof, 1)
    batch.pop("top_kernels")
    batch.update(host_ms=batch_ms, idle_share=max(
        0.0, 1.0 - batch["device_busy_ms"] / batch_ms))
    top = steps.pop("top_kernels")
    return dict(budget=budget, arch=bench["arch"], batch=cfg.batch,
                profiled_steps=PROFILED_STEPS,
                host_ms_per_step=statistics.median(host_ms),
                host_ms_steps=host_ms, **steps,
                compiled_batch=dict(batch=BATCH, **batch), top_kernels=top)


def main() -> None:
    bench = qat_bench()
    for budget in BUDGETS:
        print(json.dumps(profile_budget(bench, budget)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
