"""Continuous-batching serving on the PyTorch/CUDA port's SIRA-optimized
integer path: int8 packed weights + a paged KV cache whose int8 storage
scales come from SIRA range analysis of the exported K/V projection
graphs.

    PYTHONPATH=src python examples_torch/serve_quantized.py
    PYTHONPATH=src python examples_torch/serve_quantized.py --torch-device cpu

Twin of ``examples/serve_quantized.py``: the reduced qwen2-1.5b (2
layers, d_model 64) with seeded weights, the same 8 requests, the same
lines.  On the card each prefill chunk runs the ``flash_attention``
kernel; decode runs the plain ``paged_attention``.  ``serve`` takes the
model and the requests, so a caller can bring its own weights; ``main``
returns the printed numbers and the greedy streams.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.convert import ParamTree
from repro_torch.quant.quantizer import pack_weights_int8
from repro_torch.serve import (Request, ServingConfig, ServingEngine,
                               derive_kv_spec)

ARCH = "qwen2-1.5b"
SEED = 0


def make_requests(cfg) -> list:
    """8 requests from ``np.random.default_rng(0)``, as the reference
    draws them: a queue twice as deep as the slot count, so the
    scheduler streams requests through freed slots instead of serving
    fixed waves."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=(int(rng.integers(4, 12)),)),
                    max_new_tokens=int(rng.integers(8, 24)))
            for _ in range(8)]


def serve(model, reqs) -> dict:
    """Serve ``reqs`` with ``model``'s float weights and fp pages, then
    with its weights packed int8 and a SIRA-int8 KV cache; print and
    return the times, metrics, pool bytes and the streams' agreement."""
    eng_fp = ServingEngine(model, ServingConfig(batch_slots=4, max_seq=64))
    t0 = time.perf_counter()
    out_fp = eng_fp.generate(reqs)
    t_fp = time.perf_counter() - t0

    # int8 weights + SIRA-derived int8 KV cache (scales are per layer and
    # per KV head, with fp fallback for any layer whose proven range is
    # too wide — see serve/kv_cache.py).  The spec must be derived from
    # the weights actually served: packing perturbs each projection by up
    # to half a quant step, so fp-derived ranges would not cover it.
    model_q = get_model(model.cfg, device=model.device)
    model_q.params = ParamTree(pack_weights_int8(
        model.param_tree(), min_size=64, cfg=model.cfg))
    spec = derive_kv_spec(model_q)
    eng_q = ServingEngine(model_q, ServingConfig(batch_slots=4, max_seq=64,
                                                 kv_cache=spec))
    t0 = time.perf_counter()
    out_q = eng_q.generate(reqs)
    t_q = time.perf_counter() - t0

    agree = float(np.mean([a == b for fa, fb in zip(out_fp, out_q)
                           for a, b in zip(fa, fb)]))
    m_fp, m_q = eng_fp.metrics.summary(), eng_q.metrics.summary()
    kv_fp, kv_q = eng_fp.cache.hbm_bytes(), eng_q.cache.hbm_bytes()
    print(f"fp serving:    {t_fp:.2f}s  "
          f"ttft={m_fp['mean_ttft_s'] * 1e3:.1f}ms  "
          f"occupancy={m_fp['slot_occupancy']:.2f}  "
          f"kv={kv_fp / 1024:.0f} KiB")
    print(f"int8 serving:  {t_q:.2f}s  "
          f"ttft={m_q['mean_ttft_s'] * 1e3:.1f}ms  "
          f"occupancy={m_q['slot_occupancy']:.2f}  "
          f"kv={kv_q / 1024:.0f} KiB  "
          f"({spec.n_int8}/{len(spec.layers)} layers int8)")
    print(f"greedy token agreement: {agree:.0%}")
    print("(int8 weights halve HBM weight traffic; the int8 paged cache "
          "quarters KV storage vs f32 and frees pages the moment a "
          "request finishes — the scales are proven ranges, so "
          "saturation cannot occur in-range: A2Q-style guarantee)")
    return dict(
        fp_s=t_fp, int8_s=t_q, fp_ttft_s=m_fp["mean_ttft_s"],
        int8_ttft_s=m_q["mean_ttft_s"],
        fp_occupancy=m_fp["slot_occupancy"],
        int8_occupancy=m_q["slot_occupancy"], fp_kv_bytes=kv_fp,
        int8_kv_bytes=kv_q, n_int8=spec.n_int8, layers=len(spec.layers),
        agreement=agree, streams_fp=out_fp, streams_int8=out_q)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model serves (default the card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_config(ARCH, reduced=True)
    model = get_model(cfg, device=args.torch_device)
    model.init(torch.Generator(device=model.device).manual_seed(SEED))
    return serve(model, make_requests(cfg))


if __name__ == "__main__":
    main()
