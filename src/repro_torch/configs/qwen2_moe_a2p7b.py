"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts top-4
(hf:Qwen/Qwen1.5-MoE-A2.7B).  24L d_model=2048 16H(kv=16) d_ff=1408
vocab=151936."""
import torch

from .base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936,
        moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
    ),
    reduced=lambda: ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32),
        dtype=torch.float32,
    ),
)
