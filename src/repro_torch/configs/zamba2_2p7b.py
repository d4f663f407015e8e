"""zamba2-2.7b [hybrid]: 54L Mamba2 backbone + shared attention blocks
(arXiv:2411.15242).  54L d_model=2560 32H(kv=32) d_ff=10240 vocab=32000,
ssm_state=64."""
import torch

from .base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
        attn_every=6,                     # shared attn block every 6 mamba
        supports_long_context=True,       # Mamba2 backbone: O(S) decode
    ),
    reduced=lambda: ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=32),
        attn_every=3, supports_long_context=True,
        dtype=torch.float32,
    ),
)
