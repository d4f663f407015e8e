#!/usr/bin/env python3
"""QNN ms per batch of the seven ``chip_smoke.py`` configurations, on one
CUDA card, for comparing two trees or two ``int_matmul`` routes in one
run of the machine.

    python3 tools/qnn_batch_times.py [--src DIR] [--route ROUTE]
                                     [--batch 256] [--rounds 5] [--profile]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so an unpacked copy of another commit can be
timed beside this one; run each tree in its own process, in turns
(A, B, B, A).  ``--route cuda_cores`` (or ``tensor_cores``) sends every
``int_matmul`` call of the lowered models to that kernel; it needs a tree
whose wrapper takes ``route=``.  Each configuration goes through
``build_flow`` and ``compile()`` (float32, fused epilogues) and runs one
warm call, then ``--rounds`` rounds of three calls at batch ``--batch``
(host clock; every call returns numpy, so it ends synchronised).  Prints
one JSON line per configuration (median and all rounds, launches of one
call by kernel and route) and a last line with the card's name and power
limit.  ``--profile`` adds, from five more calls under
``torch.profiler`` and per call, the device time of all kernels, the wall
time, the device time and launches of each kernel family
(``multithreshold``, ``quantize``, ``int_matmul``, other) and the eight
kernels that took most device time.  Without a CUDA device it exits with
code 2.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def feeds_for(model, batch: int, seed: int) -> dict:
    shape = (batch,) + tuple(model.metadata["input_shape"][1:])
    (inp,) = model.graph.inputs
    r = model.input_ranges[inp]
    lo = np.broadcast_to(np.asarray(r.lo, np.float64), shape)
    hi = np.broadcast_to(np.asarray(r.hi, np.float64), shape)
    return {inp: np.random.default_rng(seed).uniform(lo, hi, size=shape)}


PROFILED_CALLS = 5


def device_profile(fast, feeds) -> dict:
    """``PROFILED_CALLS`` calls under ``torch.profiler``, per call: wall
    ms, device ms summed over kernels, device ms and launches of each
    kernel family, and the eight kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_CALLS):
            fast(feeds)
        wall = (time.perf_counter() - t0) * 1e3 / PROFILED_CALLS
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue                  # host operators: their kernels count
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / PROFILED_CALLS, e.count / PROFILED_CALLS,
                     e.key))
    rows.sort(reverse=True)
    families = dict(multithreshold=[0.0, 0], quantize=[0.0, 0],
                    int_matmul=[0.0, 0], other=[0.0, 0])
    for ms, n, key in rows:
        fam = next((f for f in ("multithreshold", "quantize") if f in key),
                   "int_matmul" if "matmul" in key else "other")
        families[fam][0] += ms
        families[fam][1] += n
    return dict(profiled_wall_ms=wall,
                device_ms=sum(r[0] for r in rows),
                device_ms_by_family={k: dict(ms=v[0], launches=v[1])
                                     for k, v in families.items()},
                top_kernels=[dict(name=k[:80], ms=ms, count=n)
                             for ms, n, k in rows[:8]])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--route", default=None,
                    choices=("tensor_cores", "cuda_cores"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qnn_batch_times: no CUDA device is available",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import build_flow
    from repro_torch.core.workloads import WORKLOADS, make_cnv, make_tfc
    from repro_torch.kernels import _build, ops as kops

    if args.route is not None:
        kernel = kops.int_matmul

        def forced(*a, **kw):
            return kernel(*a, route=args.route, **kw)
        kops.int_matmul = forced

    configs = [(name, fn, {}) for name, fn in WORKLOADS.items()] + [
        ("CNV-w2a2(ch=64,img=32)", make_cnv, dict(ch=64, img=32)),
        ("TFC-w2a2(in_dim=784)", make_tfc, dict(in_dim=784)),
        ("CNV-w2a8", make_cnv, dict(wbits=2, abits=8)),
    ]
    for name, factory, kwargs in configs:
        model = build_flow(factory(**kwargs)).model
        fast = model.compile()
        feeds = feeds_for(model, args.batch, seed=1)
        before = dict(_build.LAUNCH_COUNTS)
        fast(feeds)                                  # warm
        launches = {k: v - before.get(k, 0)
                    for k, v in _build.LAUNCH_COUNTS.items()
                    if v != before.get(k, 0)}
        rounds = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            for _ in range(3):
                fast(feeds)
            rounds.append((time.perf_counter() - t0) / 3 * 1e3)
        line = dict(
            name=name, src=args.src, route=args.route or "automatic",
            batch=args.batch, ms_per_batch=statistics.median(rounds),
            rounds_ms=rounds, launches=launches)
        if args.profile:
            line.update(device_profile(fast, feeds))
        print(json.dumps(line), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
