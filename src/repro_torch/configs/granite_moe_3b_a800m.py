"""granite-moe-3b-a800m [moe]: 40 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base family).  32L d_model=1536
24H(GQA kv=8) d_ff=512 vocab=49155."""
import torch

from .base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, d_expert=512),
        tie_embeddings=True,
    ),
    reduced=lambda: ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=4, n_shared=0, d_expert=32),
        tie_embeddings=True,
        dtype=torch.float32,
    ),
)
