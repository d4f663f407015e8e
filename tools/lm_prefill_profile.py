#!/usr/bin/env python3
"""Where the time and the memory of one LM prefill of the PyTorch/CUDA
port go, on one NVIDIA GPU.

    python3 tools/lm_prefill_profile.py [--arch NAME]

It profiles the bfloat16 prefills that ``chip_smoke.py`` times: the same
architecture at full width (``--arch``, default ``LM_ARCH`` of the
``lm_prefill`` phase; one of ``FAMILY_WIDTHS``, the MoE, Mamba2 and Zamba2
configs of the ``lm_families`` phase), weights, tokens and ``B x S`` runs
(``LM_BF16``; ``FAMILY_BF16``, and ``FAMILY_LONG`` where the config
supports long contexts).  For each run it prints one JSON line:

  * ``memory``: bytes allocated before the call (the weights), the peak
    of one ``forward`` and the size of its logits;
  * ``device_ms_by_family``: device time of one ``forward``'s kernels by
    family (the flash-attention kernel, matrix products, the rest), from
    ``torch.profiler``, beside the wall time of the same call (ended by a
    synchronize), the device's busy time (the union of the kernels'
    intervals) and its idle share of the wall time;
  * ``top_kernels``: the ten kernels with the most device time;
  * ``device_ms_by_op``: the twelve PyTorch operators (``aten::...``)
    whose kernels take the most device time, with their calls.

Then the ``nvidia-smi`` name and power limit.  Exits 2 without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from chip_smoke import (FAMILY_BF16, FAMILY_LONG,             # noqa: E402
                        FAMILY_WIDTHS, LM_ARCH, LM_BF16, device_profile,
                        lm_model, lm_tokens, top_kernels)
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
    """One warm ``forward`` (its peak memory), then one profiled
    (``chip_smoke.device_profile``): device time of its kernels (events
    on the card, not the host-side ops that launched them) by family, and
    the device's busy time as the union of their intervals."""
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = model(toks)
    memory = dict(weights=weights,
                  forward_peak=torch.cuda.max_memory_allocated(),
                  logits_bytes=logits.numel() * logits.element_size())
    del logits
    prof = device_profile(lambda: model(toks), by_op=True)
    by_kernel = prof.pop("by_kernel")
    by_family: dict = {}
    for name, (ms, _) in by_kernel.items():
        by_family[family(name)] = by_family.get(family(name), 0.0) + ms
    return dict(memory=memory, device_ms_by_family=by_family,
                top_kernels=top_kernels(by_kernel, 10), **prof)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=LM_ARCH,
                    choices=[LM_ARCH] + list(FAMILY_WIDTHS))
    arch = ap.parse_args().arch
    cfg = get_config(arch)
    model = lm_model(cfg)
    runs = LM_BF16 if arch == LM_ARCH else [FAMILY_BF16] + (
        [FAMILY_LONG] if cfg.supports_long_context else [])
    for B, S, _ in runs:
        with torch.no_grad():
            prof = profile(model, lm_tokens(cfg, B, S))
        print(json.dumps(dict(arch=arch, dtype=str(cfg.dtype), B=B, S=S,
                              **prof)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
