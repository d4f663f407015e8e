"""glm4-9b [dense]: RoPE + GQA (hf:THUDM/glm-4-9b).
40L d_model=4096 32H(GQA kv=2) d_ff=13696 vocab=151552."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, qkv_bias=True,
    ),
    reduced=lambda: ArchConfig(
        name="glm4-9b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qkv_bias=True,
        dtype=torch.float32,
    ),
)
