"""LM model zoo: the dense family (incl. gemma2) and its vlm/audio
variants (MoE, Mamba2 SSD and the Zamba2 hybrid are not ported yet)."""
from .transformer import Model, get_model          # noqa: F401
from .common import rms_norm, linear               # noqa: F401
from .attention import flash_attention             # noqa: F401
from .convert import load_reference_params        # noqa: F401
