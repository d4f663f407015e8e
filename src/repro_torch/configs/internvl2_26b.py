"""internvl2-26b [vlm]: InternViT frontend (stub) + InternLM2 backbone
(arXiv:2404.16821).  48L d_model=6144 48H(GQA kv=8) d_ff=16384
vocab=92553."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553,
        frontend="patch", frontend_len=256,
    ),
    reduced=lambda: ArchConfig(
        name="internvl2-26b", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, frontend="patch", frontend_len=8,
        dtype=torch.float32,
    ),
)
