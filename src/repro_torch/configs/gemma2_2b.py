"""gemma2-2b [dense]: local+global alternating attention, logit softcaps,
post-norms, GeGLU (arXiv:2408.00118).  26L d_model=2304 8H(GQA kv=4)
d_ff=9216 vocab=256000, head_dim=256."""
import torch

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab=256000, head_dim=256, mlp_act="gelu",
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=4096, post_norms=True, tie_embeddings=True,
    ),
    reduced=lambda: ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, mlp_act="gelu",
        attn_softcap=50.0, final_softcap=30.0,
        sliding_window=32, post_norms=True, tie_embeddings=True,
        dtype=torch.float32,
    ),
)
