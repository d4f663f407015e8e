"""musicgen-medium [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284).  48L d_model=1536 24H(kv=24) d_ff=6144 vocab=2048.
Frontend (EnCodec + text conditioning) is a stub supplying precomputed
frame embeddings per the assignment."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab=2048, mlp_act="gelu",
        frontend="frame", frontend_len=64,
    ),
    reduced=lambda: ArchConfig(
        name="musicgen-medium", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=64, mlp_act="gelu",
        frontend="frame", frontend_len=8,
        dtype=torch.float32,
    ),
)
