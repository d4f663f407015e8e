"""mamba2-780m [ssm]: SSD state-space duality, attention-free
(arXiv:2405.21060).  48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128."""
import torch

from .base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
        supports_long_context=True,
    ),
    reduced=lambda: ArchConfig(
        name="mamba2-780m", family="ssm",
        n_layers=4, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=32),
        supports_long_context=True,
        dtype=torch.float32,
    ),
)
