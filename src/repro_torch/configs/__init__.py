"""Assigned architecture configs (10 archs from the public pool)."""
from .base import (ArchConfig, MoEConfig, SSMConfig, ShapeCell, SHAPES,  # noqa
                   REGISTRY, get_config, list_archs, input_specs,
                   cell_applicable, register)
from . import (zamba2_2p7b, internvl2_26b, qwen2_1p5b, gemma2_2b,  # noqa
               glm4_9b, granite3_2b, qwen2_moe_a2p7b,
               granite_moe_3b_a800m, mamba2_780m, musicgen_medium)
