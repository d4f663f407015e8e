"""repro_torch: the PyTorch/CUDA port of ``repro`` (SIRA, scaled-integer
range analysis), for NVIDIA Hopper.

Same sub-package and module names as ``repro``; imports neither ``jax``
nor ``repro``.  Ported so far:
  core     — the paper's contribution (SIRA analysis + FDNA optimizations)
             and the compiled backend (``SiraModel.compile``)
  kernels  — CUDA kernels (int matmul, multithreshold, quantize, flash
             attention) with their plain PyTorch versions
  configs  — the ten architecture configs
  quant    — uniform affine quantizers (``quantizer.py``)
  models   — the dense/vlm/audio language models (prefill and decode)
  obs      — tracing, metrics, range provenance (stdlib only)
"""
__version__ = "1.0.0"
