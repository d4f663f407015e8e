"""repro_torch: the PyTorch/CUDA port of ``repro`` (SIRA, scaled-integer
range analysis), for NVIDIA Hopper.

Same sub-package and module names as ``repro``; imports neither ``jax``
nor ``repro``.  Ported so far:
  core     — the paper's contribution (SIRA analysis + FDNA optimizations)
             and the compiled backend (``SiraModel.compile``)
  kernels  — CUDA kernels (int matmul, multithreshold, quantize) with
             their plain PyTorch versions
  obs      — tracing, metrics, range provenance (stdlib only)
"""
__version__ = "1.0.0"
