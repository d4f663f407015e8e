"""CUDA kernels for the SIRA-optimized integer inference path."""
from .ops import int_matmul, multithreshold, quantize  # noqa: F401
from . import ref                                      # noqa: F401
