"""qwen2-1.5b [dense]: GQA with QKV bias (arXiv:2407.10671).
28L d_model=1536 12H(GQA kv=2) d_ff=8960 vocab=151936."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True,
    ),
    reduced=lambda: ArchConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, qkv_bias=True, tie_embeddings=True,
        dtype=torch.float32,
    ),
)
