#!/usr/bin/env python3
"""Where the time and the memory of one LM prefill of the PyTorch/CUDA
port go, on one NVIDIA GPU.

    python3 tools/lm_prefill_profile.py

It profiles the bfloat16 prefills that ``chip_smoke.py``'s ``lm_prefill``
phase times: the same architecture (``LM_ARCH``, full width), weights,
tokens and ``B x S`` runs (``LM_BF16``).  For each run it prints one JSON
line:

  * ``memory``: bytes allocated before the call (the weights), the peak
    of one ``forward`` and the size of its logits;
  * ``device_ms_by_family``: device time of one ``forward``'s kernels by
    family (the flash-attention kernel, matrix products, the rest), from
    ``torch.profiler``, beside the wall time of the same call (ended by a
    synchronize), the device's busy time (the union of the kernels'
    intervals) and its idle share of the wall time;
  * ``top_kernels``: the ten kernels with the most device time.

Then the ``nvidia-smi`` name and power limit.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import LM_ARCH, LM_BF16, lm_model, lm_tokens  # noqa: E402
from repro_torch.configs import get_config                     # noqa: E402


def family(name: str) -> str:
    if "flash_kernel" in name:
        return "flash_attention"
    low = name.lower()
    if any(s in low for s in ("gemm", "sm90_xmma", "cutlass", "cublas",
                              "nvjet")):
        return "matmul"
    return "other"


def profile(model, toks) -> dict:
    """One warm ``forward`` (its peak memory), then one profiled: device
    time of its kernels (events on the card, not the host-side ops that
    launched them) by family, and the device's busy time as the union of
    their intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = model(toks)
    memory = dict(weights=weights,
                  forward_peak=torch.cuda.max_memory_allocated(),
                  logits_bytes=logits.numel() * logits.element_size())
    del logits
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_family, by_name = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
        fam = family(ev.name)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        ms0, n0 = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms0 + ms, n0 + 1)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(memory=memory, wall_ms=wall_ms,
                device_busy_ms=busy_us / 1e3,
                idle_share=max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
                kernels=len(spans), device_ms_by_family=by_family,
                top_kernels=[dict(ms=ms, calls=n, name=k[:120])
                             for k, (ms, n) in top])


def main() -> None:
    cfg = get_config(LM_ARCH)
    model = lm_model(cfg)
    for B, S, _ in LM_BF16:
        with torch.no_grad():
            prof = profile(model, lm_tokens(cfg, B, S))
        print(json.dumps(dict(arch=LM_ARCH, dtype=str(cfg.dtype), B=B, S=S,
                              **prof)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
