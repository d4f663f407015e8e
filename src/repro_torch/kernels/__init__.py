"""CUDA kernels for the SIRA-optimized integer inference path and the LM
prefill's attention."""
from .ops import int_matmul, multithreshold, quantize  # noqa: F401
from .flash_attention import flash_attention_fwd       # noqa: F401
from . import ref                                      # noqa: F401
