"""repro_torch: the PyTorch/CUDA port of ``repro`` (SIRA, scaled-integer
range analysis), for NVIDIA Hopper.

Same sub-package and module names as ``repro``; imports neither ``jax``
nor ``repro``.  Ported so far:
  core     — the paper's contribution (SIRA analysis + FDNA optimizations)
             and the compiled backend (``SiraModel.compile``)
  kernels  — CUDA kernels (int matmul, multithreshold, quantize, flash
             attention) with their plain PyTorch versions
  configs  — the ten architecture configs
  quant    — uniform affine quantizers, PTQ calibration
  models   — the dense/vlm/audio language models (prefill, decode, loss)
  obs      — tracing, metrics, range provenance (stdlib only)
  data, optim, train — the token pipeline, AdamW, the train step,
             checkpoints, gradient compression, supervision (``tree.py``
             walks the nested containers they take)
  qat      — accumulator-aware QAT (A2Q / A2Q+): train, prove, price
"""
__version__ = "1.0.0"
