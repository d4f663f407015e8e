"""granite-3-2b [dense]: GQA (hf:ibm-granite/granite-3.0-2b-base).
40L d_model=2048 32H(GQA kv=8) d_ff=8192 vocab=49155."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab=49155, tie_embeddings=True,
    ),
    reduced=lambda: ArchConfig(
        name="granite-3-2b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, tie_embeddings=True,
        dtype=torch.float32,
    ),
)
