"""LM model zoo: every registered family (dense incl. gemma2, vlm/audio,
MoE, Mamba2 SSD, the Zamba2 hybrid) and the SIRA block exporter."""
from .transformer import Model, get_model          # noqa: F401
from .common import rms_norm, linear               # noqa: F401
from .attention import flash_attention             # noqa: F401
from .convert import load_reference_params        # noqa: F401
from .export import export_block_graph, export_kv_proj_graph  # noqa: F401
